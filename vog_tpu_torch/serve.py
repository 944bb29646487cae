"""Serving path: weights -> batched grounding on the card.

Counterpart of vog_tpu/serve.py.  ``Predictor`` maps a canonical request
batch (numpy) to grounded boxes per SRL argument: the chosen video slot,
proposal index, its box (normalised xyxy) and score, plus the canonical
score grid.  With device-resident ``tables`` a batch may carry
``vid_rows`` instead of props/seg_feats; the gather kernel resolves them
on the card.

``dispatch`` uploads the batch from pinned memory, enqueues the forward
and the copies of the outputs back to pinned host memory, records an
event and returns without waiting; ``fetch`` waits on that event.  So a
caller (``ServingLoop``) overlaps one batch's host work with another's
compute.  On the card with ``cuda_graphs`` (the default) the forward is a
CUDA graph captured once for each batch shape and numerics
(``train/graphs.py §numerics_key``; each serving bucket, at
``ServingLoop.prewarm``), the counterpart of jit's per-shape cache: a
dispatch copies the batch from a persistent pinned staging buffer into the
graph's static input, replays it, and copies the outputs into a ring of
``ring_depth`` persistent pinned buffers (train/graphs.py §ServeGraph);
``fetch`` copies them out and frees the slot.  ``cuda_graphs=False`` runs
the forward eagerly.

Precision: ``Predictor`` applies ``misc.matmul_precision`` with
``config.apply_matmul_precision``, as ``get_model`` does.  Weights come
as a flax params tree (converted by ``interop.from_jax``), a state_dict,
or a checkpoint of the port's Learner (``Predictor.from_checkpoint``);
a ``vog_tpu`` orbax checkpoint becomes one with
``tools/orbax_to_torch_port.py``.

The sequence-parallel ring (``mesh`` with a model axis longer than 1 and
``mdl.sp_attention``, as the JAX ``Predictor(mesh=)`` installs it): the
parameters stay whole on every rank and the attention blocks run the ring
over the model group (``get_model(..., tensor_parallel=False)``).  Model
rank 0 is the leader: its ``dispatch`` first broadcasts the padded batch
over the model group (its fields' shapes and dtypes, then each field);
the other model ranks run ``follow``, which takes each broadcast batch
through the same forward until the leader's ``close``.  Its forward is
eager: the followers' forwards pair with the leader's collectives a flush
at a time, outside any captured graph, so ``cuda_graphs`` must be off.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from vog_tpu_torch.config import apply_matmul_precision
from vog_tpu_torch.data.device_store import gather_from_tables
from vog_tpu_torch.device import DeviceLike, resolve_device
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.model.grounding import get_model
from vog_tpu_torch.sampling import assemble_batch, scores_to_canonical

# 0/1 fields a batch may ship as uint8
COMPACT_KEYS = ("targets", "prop_mask", "gt_frame_mask", "srl_arg_mask", "batch_mask")


def cast_compact(batch: Dict) -> Dict:
    out = dict(batch)
    for k in COMPACT_KEYS:
        if k in out:
            out[k] = out[k].float()
    return out


def predict_batch(model, conc: str, batch: Dict[str, torch.Tensor],
                  tables: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """A canonical batch on the device -> the grounding outputs (the
    ``Predictor``'s forward, and the exported program's)."""
    if tables is not None and "vid_rows" in batch:
        batch = gather_from_tables(batch, tables)
    batch = cast_compact(batch)
    clip = assemble_batch(batch, conc)
    logits = model(clip)
    B, V, F, P = batch["prop_mask"].shape
    scores = scores_to_canonical(logits, conc, B, V, F, P)  # (B,A,V,F,P)
    # padded proposals carry untrained logits: never let them win
    scores = torch.where(batch["prop_mask"][:, None] > 0, scores, torch.full_like(scores, -1e30))
    A = scores.shape[1]
    cand = scores.permute(0, 1, 3, 2, 4).reshape(B, A, F, V * P)
    choice = torch.argmax(cand, dim=-1)  # first maximum, as jnp.argmax
    v_hat, p_hat = choice // P, choice % P
    b_idx = torch.arange(B, device=cand.device)[:, None, None]
    f_idx = torch.arange(F, device=cand.device)[None, None, :]
    boxes = batch["prop_boxes"][b_idx, v_hat, f_idx, p_hat, :4]
    return {
        "scores": scores,
        "pred_vid": v_hat.to(torch.int32),
        "pred_prop": p_hat.to(torch.int32),
        "pred_box": boxes,
        "pred_score": cand.amax(dim=-1),
    }


class _Pending:
    """Outputs of one dispatch: host tensors being filled, the event that
    marks their copies done, and, for a graph's ring slot, the callback
    that frees it."""

    def __init__(self, host: Dict[str, torch.Tensor], event: Optional[torch.cuda.Event],
                 release: Optional[Callable[[], None]] = None):
        self.host = host
        self.event = event
        self.release = release


class Predictor:
    def __init__(
        self,
        cfg,
        params,
        vocab_size: int,
        tables: Optional[Dict[str, torch.Tensor]] = None,
        device: DeviceLike = None,
        cuda_graphs: bool = True,
        glove=None,
        mesh=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.model_group is not None else None
        if self.mesh is not None:
            if not cfg.mdl.sp_attention:
                raise ValueError(f"a Predictor on a model axis of {mesh.model} runs the sequence-parallel ring: "
                                 "set mdl.sp_attention=true (its parameters stay whole)")
            if cuda_graphs and self.device.type == "cuda":
                raise ValueError("a Predictor on the model axis runs its forward eagerly (the followers pair "
                                 "with each flush's collectives): pass cuda_graphs=False")
        apply_matmul_precision(cfg)
        self.model = get_model(cfg, vocab_size, device=self.device, glove=glove, mesh=self.mesh,
                               tensor_parallel=False)
        if params is not None:
            sd = params
            if any(isinstance(v, dict) or hasattr(v, "items") for v in params.values()):
                sd = params_from_jax(params, cfg)
            self.model.load_state_dict(sd, strict=True)
        self.tables = tables
        self.conc = cfg.ds.conc_type
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        # pinned output slots a bucket's graph keeps: a dispatch and a fetch
        # in turn need one, ServingLoop raises it to its pipeline's need
        self.ring_depth = 2
        self.graphs: Dict[tuple, object] = {}  # (numerics, batch shapes) -> ServeGraph

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_path, tables: Optional[Dict[str, torch.Tensor]] = None,
                        device: DeviceLike = None, glove=None, cuda_graphs: bool = True,
                        mesh=None) -> "Predictor":
        """A Predictor of the parameters of a port checkpoint
        (``train/learner.py §save``: ``models/{uid}/{tag}.pt``), as
        vog_tpu/serve.py §from_checkpoint restores the params alone: the
        optimizer's moments and the step are not read.  The model is built
        as the Learner builds it (``glove``: the vocabulary's GloVe table);
        the vocabulary's size is the saved embedding's."""
        payload = torch.load(Path(ckpt_path), map_location="cpu", weights_only=True)
        params = {k.split(":", 1)[1]: v for k, v in payload["state"].items() if k.startswith("param:")}
        if "lang.embed.weight" not in params:
            raise ValueError(f"{ckpt_path} holds no parameters of the port's model")
        return cls(cfg, params, int(params["lang.embed.weight"].shape[0]), tables=tables, device=device,
                   cuda_graphs=cuda_graphs, glove=glove, mesh=mesh)

    def _upload(self, v) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(v))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The forward on tensors already on the device."""
        return predict_batch(self.model, self.conc, batch, self.tables)

    def _share(self, batch: Optional[Dict[str, np.ndarray]]) -> Optional[Dict[str, torch.Tensor]]:
        """The leader's ``batch`` (None: the close message) broadcast over
        the model group -> its fields on this rank's device, or None."""
        mesh = self.mesh
        lead = mesh.model_index == 0
        spec = [None if not lead or batch is None else
                [(k, tuple(np.shape(v)), np.asarray(v).dtype.str) for k, v in batch.items()]]
        nccl = mesh.backend == "nccl"
        dist.broadcast_object_list(spec, src=mesh.model_ranks[0], group=mesh.model_group,
                                   device=self.device if nccl else None)
        if spec[0] is None:
            return None
        comm = self.device if nccl else torch.device("cpu")
        out = {}
        for k, shape, dt in spec[0]:
            if lead:
                t = torch.from_numpy(np.ascontiguousarray(batch[k])).to(comm)
            else:
                t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, np.dtype(dt))).dtype, device=comm)
            out[k] = mesh.broadcast_(t).to(self.device)
        return out

    def follow(self) -> int:
        """A follower's loop (model index > 0): each batch the leader
        broadcasts through the same forward, until its ``close``.  -> the
        number of batches followed."""
        n = 0
        while True:
            with self._on_device():
                batch = self._share(None)
                if batch is None:
                    return n
                with torch.inference_mode():
                    self.predict(batch)
            n += 1

    def close(self) -> None:
        """The leader's close message: every follower leaves ``follow``."""
        if self.mesh is not None and self.mesh.model_index == 0:
            with self._on_device():
                self._share(None)

    def _on_device(self):
        from contextlib import nullcontext

        return torch.cuda.device(self.device) if self.device.type == "cuda" else nullcontext()

    def dispatch(self, batch: Dict[str, np.ndarray]) -> _Pending:
        """Enqueue one batch and return without waiting for the card."""
        if self.mesh is not None:  # the leader: the batch to the followers, then the forward
            with self._on_device(), torch.inference_mode():
                out = self.predict(self._share(batch))
                if self.device.type != "cuda":
                    return _Pending(out, None)
                host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
                return _Pending(host, event)
        if self.cuda_graphs:
            from vog_tpu_torch.train.graphs import ServeGraph, numerics_key  # here: train imports this module

            key = (numerics_key(self.model),) + tuple(
                (k, np.shape(v), str(np.asarray(v).dtype)) for k, v in batch.items())
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = ServeGraph(self.predict, batch, self.device, self.ring_depth)
            r, host, event = g.dispatch(batch)
            return _Pending(host, event, lambda: g.release(r))
        with torch.inference_mode():
            out = self.predict({k: self._upload(v) for k, v in batch.items()})
            if self.device.type != "cuda":
                return _Pending(out, None)
            host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            return _Pending(host, event)

    @staticmethod
    def fetch(out: _Pending) -> Dict[str, np.ndarray]:
        """Wait for a ``dispatch`` result and return it as numpy (copied
        out of a graph's ring slot, which is then free again)."""
        if out.event is not None:
            out.event.synchronize()
        if out.release is None:
            return {k: v.numpy() for k, v in out.host.items()}
        try:
            return {k: v.numpy().copy() for k, v in out.host.items()}
        finally:
            out.release()

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.fetch(self.dispatch(batch))
