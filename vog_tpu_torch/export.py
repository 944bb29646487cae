"""The deployment artifact: the Predictor's forward as an exported program
(counterpart of vog_tpu/export.py).

``export_predictor`` traces the live ``Predictor``'s forward at one batch
size with ``torch.export`` and saves it with the weights inside, and
``ExportedPredictor`` replays it without building the model: the program
is the model, its kernel ops registered by the kernel modules, at the
precision the program was exported at (``misc.matmul_precision``, in the
manifest).  On the card the replay is a CUDA graph of the loaded program,
captured at the first request (``train/graphs.py §ServeGraph``, as the
live ``Predictor`` captures a bucket: static inputs, a ring of pinned
outputs) and keyed by the numerics in force; ``cuda_graphs=False``, and
the CPU, replay the program eagerly.  A capture that fails raises.  The four forward
kernels of the serving path are ``torch.library`` ops (``vog::gather_rows``,
``vog::flash_attention_fwd``, ``vog::mm_attention_fwd``,
``vog::grounding_head_fwd``), so the program holds each as one node and
its replay launches the same CUDA kernels as the live path (the plain
versions on the CPU).

Request schema, as the JAX package's:

  * ``feature_encoding="f32"``: float features.
  * ``"bf16"``: ``props`` / ``seg_feats`` travel as bfloat16, 2x smaller,
    as the bits in a uint16 array (numpy has no bfloat16; the bits are
    those of ``ml_dtypes.bfloat16``, rounded to nearest even), widened to
    fp32 inside the program.
  * ``"int8"``: int8 with one symmetric scale a feature vector, 4x
    smaller, the device store's quantization (``data/device_store.py
    §_pack_rows``: s = maxabs / 127, q = round(x / s)), dequantized inside
    the program.  ``encode_features`` is the client's encoder;
    ``ExportedPredictor.dispatch`` encodes float requests itself.
  * ``with_tables=True``: the device feature tables are saved beside the
    program (``tables.pt``, packed as they lie on the card) and requests
    carry ``vid_rows`` (B, V) instead of features.

The artifact is a directory: ``program.pt2`` (``torch.export.save``),
``manifest.json`` (schema, the config's dims, the torch version, the
device type, the encoding, the tables flag, the video -> row map) and,
with tables, ``tables.pt``.  A program replays on the device type it was
exported on.
"""

from __future__ import annotations

import copy
import json
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vog_tpu_torch.config import Cfg, apply_matmul_precision
from vog_tpu_torch.config.defaults import kernel_precision
from vog_tpu_torch.device import DeviceLike, resolve_device
from vog_tpu_torch.kernels import attention, gather, grounding_head, mm_attention  # noqa: F401  (the ops)
from vog_tpu_torch.serve import Predictor, _Pending
from vog_tpu_torch.train.graphs import ServeGraph

ENCODINGS = ("f32", "bf16", "int8")
FORMAT = "vog-torch-export-1"
# the program's outputs, in order
OUT_KEYS = ("scores", "pred_vid", "pred_prop", "pred_box", "pred_score")
# the forward kernels' ops (``torch.ops.vog.<name>``, ``kernels/_build.py §define_op``)
FORWARD_OPS = ("gather_rows", "flash_attention_fwd", "mm_attention_fwd", "grounding_head_fwd")


def forward_op_counts(graph: torch.fx.Graph) -> Dict[str, int]:
    """How many nodes of ``graph`` (an exported program's) call each
    forward op, by op name."""
    targets = {getattr(torch.ops.vog, name).default: name for name in FORWARD_OPS}
    counts = dict.fromkeys(FORWARD_OPS, 0)
    for node in graph.nodes:
        if node.op == "call_function" and node.target in targets:
            counts[targets[node.target]] += 1
    return counts


def request_spec(cfg, batch_size: int, feature_encoding: str = "f32",
                 vid_rows: bool = False) -> Dict[str, Tuple[tuple, np.dtype]]:
    """The canonical serving request at ``batch_size``: key -> (shape,
    numpy dtype on the wire)."""
    if feature_encoding not in ENCODINGS:
        raise ValueError(f"feature_encoding must be one of {ENCODINGS}")
    ds = cfg.ds
    B, V, F, P, A, L = (batch_size, ds.num_cmp, ds.num_frms, ds.num_prop_per_frm, ds.max_srl_args,
                        ds.max_seq_len)
    f32, i32, u8 = np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.uint8)
    spec = {
        "prop_boxes": ((B, V, F, P, 5), f32),
        "prop_mask": ((B, V, F, P), u8),
        "tokens": ((B, L), i32),
        "seq_len": ((B,), i32),
        "verb_idx": ((B,), i32),
        "srl_roles": ((B, A), i32),
        "srl_spans": ((B, A, 2), i32),
        "srl_arg_mask": ((B, A), u8),
        # read by the assembly (zeros at inference)
        "targets": ((B, V, A, F, P), u8),
        "batch_mask": ((B,), u8),
    }
    if vid_rows:
        spec["vid_rows"] = ((B, V), i32)
    elif feature_encoding == "int8":
        spec["props"] = ((B, V, F, P, ds.prop_dim), np.dtype(np.int8))
        spec["props_scale"] = ((B, V, F, P), f32)
        spec["seg_feats"] = ((B, V, F, ds.seg_dim), np.dtype(np.int8))
        spec["seg_scale"] = ((B, V, F), f32)
    else:
        dt = np.dtype(np.uint16) if feature_encoding == "bf16" else f32
        spec["props"] = ((B, V, F, P, ds.prop_dim), dt)
        spec["seg_feats"] = ((B, V, F, ds.seg_dim), dt)
    return spec


def encode_features(request: Dict[str, np.ndarray], feature_encoding: str) -> Dict[str, np.ndarray]:
    """The client's request-feature encoder (on the host, before the
    upload): batched (B, V, ...) and single-request (V, ...) layouts alike.
    int8 quantizes each trailing vector as the device store does."""
    if feature_encoding == "f32" or "props" not in request:
        return request
    out = dict(request)
    if feature_encoding == "bf16":  # rounded to nearest even, kept as uint16 bits
        for k in ("props", "seg_feats"):
            t = torch.from_numpy(np.ascontiguousarray(out[k], dtype=np.float32)).to(torch.bfloat16)
            out[k] = t.view(torch.int16).numpy().view(np.uint16)
        return out
    if feature_encoding != "int8":
        raise ValueError(f"unknown feature_encoding {feature_encoding!r}")
    for k, sk in (("props", "props_scale"), ("seg_feats", "seg_scale")):
        v = np.asarray(out[k], np.float32)
        s = np.max(np.abs(v), axis=-1) / 127.0
        s = np.where(s == 0, 1.0, s).astype(np.float32)
        out[k] = np.clip(np.round(v / s[..., None]), -127, 127).astype(np.int8)
        out[sk] = s
    return out


def _decode_features(batch: Dict[str, torch.Tensor], feature_encoding: str) -> Dict[str, torch.Tensor]:
    """Inside the program: the inverse of ``encode_features``."""
    if feature_encoding == "f32" or "props" not in batch:
        return batch
    out = dict(batch)
    if feature_encoding == "bf16":
        for k in ("props", "seg_feats"):
            out[k] = out[k].view(torch.bfloat16).float()
        return out
    for k, sk in (("props", "props_scale"), ("seg_feats", "seg_scale")):
        out[k] = out[k].float() * out.pop(sk)[..., None]
    return out


def _torch_input(v: np.ndarray) -> torch.Tensor:
    """A wire array as the program's input (bf16 bits as int16: torch
    reinterprets int16, not uint16, as bfloat16)."""
    v = np.ascontiguousarray(v)
    return torch.from_numpy(v.view(np.int16) if v.dtype == np.uint16 else v)


class _Program(nn.Module):
    """The exported forward: (tables..., request fields...) in fixed key
    orders -> the ``OUT_KEYS`` outputs."""

    def __init__(self, model: nn.Module, conc: str, keys, table_keys, encoding: str):
        super().__init__()
        self.model = model
        self.conc, self.keys, self.table_keys, self.encoding = conc, tuple(keys), tuple(table_keys), encoding

    def forward(self, *flat):
        from vog_tpu_torch.serve import predict_batch

        nt = len(self.table_keys)
        tables = dict(zip(self.table_keys, flat[:nt])) if nt else None
        batch = _decode_features(dict(zip(self.keys, flat[nt:])), self.encoding)
        out = predict_batch(self.model, self.conc, batch, tables)
        return tuple(out[k] for k in OUT_KEYS)


def _example(spec: Dict, device: torch.device, n_rows: int) -> Dict[str, torch.Tensor]:
    """A request of the schema's shapes for tracing (valid row indices,
    one token)."""
    out = {}
    for k, (shape, dt) in spec.items():
        if k in ("seq_len", "srl_arg_mask", "prop_mask", "batch_mask"):
            v = np.ones(shape, dt)
        elif k == "vid_rows":
            v = np.arange(int(np.prod(shape))).reshape(shape).astype(dt) % max(n_rows, 1)
        else:
            v = np.zeros(shape, dt)
        out[k] = _torch_input(v).to(device)
    return out


def export_predictor(predictor, batch_size: int, path, feature_encoding: str = "f32",
                     with_tables: bool = False, rows: Optional[Dict[str, int]] = None) -> Path:
    """Save ``predictor`` (``vog_tpu_torch.serve.Predictor``) at a fixed
    batch size as an artifact directory; -> its path.  The weights are
    traced as they are now; with ``with_tables`` the predictor's device
    tables go into ``tables.pt`` and ``rows`` (video -> row) into the
    manifest."""
    cfg = predictor.cfg
    if with_tables and predictor.tables is None:
        raise ValueError("with_tables=True needs a Predictor built with device feature tables "
                         "(vog_tpu_torch.data.device_store)")
    spec = request_spec(cfg, batch_size, feature_encoding=feature_encoding, vid_rows=with_tables)
    tables = dict(predictor.tables) if with_tables else {}
    model = copy.deepcopy(predictor.model).eval().requires_grad_(False)
    prog = _Program(model, cfg.ds.conc_type, spec.keys(), tables.keys(), feature_encoding)
    n_rows = int(next(iter(tables.values())).shape[0]) if tables else 0
    example = _example(spec, predictor.device, n_rows)
    with torch.no_grad(), warnings.catch_warnings():
        # nn.LSTM re-points its _flat_weights list at its parameters in
        # every forward, which export reports; the replay's outputs are the
        # live model's all the same (tests/test_torch_port_export.py)
        warnings.filterwarnings("ignore", message=r"The tensor attributes .*_flat_weights")
        ep = torch.export.export(prog, tuple(tables.values()) + tuple(example.values()))
    ep.example_inputs = None  # else saved with the program, the tables among them
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(ep, str(out / "program.pt2"))
    if with_tables:
        torch.save({k: v.detach().cpu() for k, v in tables.items()}, out / "tables.pt")
    ds = cfg.ds
    manifest = {
        "format": FORMAT,
        "batch_size": batch_size,
        "schema": {k: {"shape": list(s), "dtype": dt.name} for k, (s, dt) in spec.items()},
        "feature_encoding": feature_encoding,
        "with_tables": with_tables,
        "table_keys": list(tables),
        "rows": {k: int(v) for k, v in rows.items()} if rows else None,
        "dims": {k: getattr(ds, k) for k in ("num_cmp", "num_frms", "num_prop_per_frm", "max_srl_args",
                                             "max_seq_len", "prop_dim", "seg_dim")},
        "conc_type": ds.conc_type,
        "exp_setting": ds.exp_setting,
        "mdl_name": cfg.mdl.name,
        "mdl_dtype": cfg.mdl.dtype,
        "matmul_precision": cfg.misc.matmul_precision,
        "device": predictor.device.type,
        "torch_version": torch.__version__,
    }
    with open(out / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
    return out


def _flatten_lstm_weights(program: torch.fx.GraphModule) -> None:
    """Lay each LSTM's weights out in one buffer as cuDNN reads them, as
    ``nn.LSTM.flatten_parameters`` does for the live model: the loaded
    program holds them as separate tensors, which cuDNN would copy into
    one at every call (and warn)."""
    import functools

    for node in program.graph.nodes:
        if node.op != "call_function" or node.target is not torch.ops.aten.lstm.input:
            continue
        params = [functools.reduce(getattr, a.target.split("."), program) for a in node.args[2]]
        has_biases, num_layers, _, _, bidirectional, batch_first = node.args[3:9]
        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(params, 4 if has_biases else 2, params[0].shape[1], 2,  # 2: LSTM
                                            params[1].shape[1], 0, num_layers, batch_first, bidirectional)


class ExportedPredictor:
    """Loads an artifact and serves it with the live ``Predictor``'s
    contract (a dict of host arrays in, a dict of host arrays out, and
    ``dispatch`` / ``fetch``), so it drops into ``ServingLoop`` (without
    ``bucket_sizes``: ``batch_size`` is fixed).  The tables of a
    ``with_tables`` artifact go to the device once, at load.  On the card
    with ``cuda_graphs`` (the default) each request replays the program's
    CUDA graph."""

    def __init__(self, path, device: DeviceLike = None, cuda_graphs: bool = True):
        p = Path(path)
        with open(p / "manifest.json") as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{p} is not an artifact of this exporter (format {self.manifest.get('format')!r})")
        self.device = resolve_device(device)
        # the program's cuBLAS and cuDNN products at the precision it was
        # exported in, as the live Predictor sets it (its kernels' variant
        # is an argument of their ops, traced into the program)
        cfg = Cfg()
        cfg.misc.matmul_precision = self.manifest["matmul_precision"]
        apply_matmul_precision(cfg)
        if self.device.type != self.manifest["device"]:
            raise ValueError(f"{p} was exported on {self.manifest['device']}; it replays there, not on "
                             f"{self.device.type}")
        self.program = torch.export.load(str(p / "program.pt2")).module()
        if self.device.type == "cuda" and torch.backends.cudnn.enabled:
            _flatten_lstm_weights(self.program)
        self.batch_size = int(self.manifest["batch_size"])
        self.encoding = self.manifest["feature_encoding"]
        self.rows = self.manifest.get("rows")  # vid_seg -> table row
        self._tables: Tuple[torch.Tensor, ...] = ()
        if self.manifest["with_tables"]:
            saved = torch.load(p / "tables.pt", map_location="cpu", weights_only=True)
            self._tables = tuple(saved[k].to(self.device) for k in self.manifest["table_keys"])
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self.ring_depth = 2  # pinned output slots of the graph; ServingLoop raises it to its pipeline's need
        self.graphs: Dict[tuple, ServeGraph] = {}  # (numerics, request shapes) -> the captured replay

    def _forward(self, fields: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return dict(zip(OUT_KEYS, self.program(*self._tables, *(fields[k] for k in self.manifest["schema"]))))

    def _feed(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The request checked against the schema (float features encoded
        here when the artifact takes another encoding)."""
        if self.encoding != "f32" and "props" in batch and np.asarray(batch["props"]).dtype.kind == "f":
            batch = encode_features(batch, self.encoding)
        feed = {}
        for k, meta in self.manifest["schema"].items():
            if k not in batch:
                raise KeyError(f"exported predictor request missing '{k}'")
            v = np.asarray(batch[k], dtype=meta["dtype"])
            if list(v.shape) != meta["shape"]:
                raise ValueError(f"'{k}' shape {list(v.shape)} != exported {meta['shape']}")
            feed[k] = v
        return feed

    def dispatch(self, batch: Dict[str, np.ndarray]) -> _Pending:
        """Check and upload one batch, enqueue the program (its graph's
        replay on the card) and the copies of its outputs to the host, and
        return without waiting."""
        feed = {k: _torch_input(v) for k, v in self._feed(batch).items()}
        if self.cuda_graphs:
            key = (kernel_precision(), self.manifest["mdl_dtype"]) + tuple(
                (k, tuple(v.shape), str(v.dtype)) for k, v in feed.items())
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = ServeGraph(self._forward, feed, self.device, self.ring_depth)
            r, host, event = g.dispatch(feed)
            return _Pending(host, event, lambda: g.release(r))
        cuda = self.device.type == "cuda"
        with torch.inference_mode():
            args = {k: t.pin_memory().to(self.device, non_blocking=True) if cuda else t for k, t in feed.items()}
            host = {k: v.to("cpu", non_blocking=cuda) for k, v in self._forward(args).items()}
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return _Pending(host, event)

    fetch = staticmethod(Predictor.fetch)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.fetch(self.dispatch(batch))
