"""Optimizer, non-finite guard, the train and eval steps, and their fused
multi-step dispatches (counterpart of vog_tpu/train/state.py).

``make_optimizer`` does in one update what the JAX package's optax chain
does, step for step:

  * ``clip_by_global_norm``: g * max_norm / |g| when |g| >= max_norm (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
  * ``adam`` / ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, bias-corrected; adamw
    adds wd * param before the learning rate), the learning rate from
    ``warmup_cosine_decay_schedule`` (0 at step 0 under warm-up) or a
    constant;
  * ``skip_nonfinite_guard``: a step with a non-finite gradient leaves the
    parameters, the moments and the schedule's count as they were; after
    more than K such steps in a row the raw update is applied.

Its arithmetic runs once on one flat vector of every gradient and both
moments (the trees are flattened in the key order of ``init``'s params),
so a step costs the same few dozen ops whatever the number of tensors;
the update reaches the parameters by one ``torch._foreach_add_``.  Every
counter stays a tensor on the parameters' device, so a step never waits
for the card.  A parameter with no gradient (the frozen embedding) gets a
zero gradient, as optax sees one: adam leaves it, adamw decays it.

``make_train_step`` gathers from the device tables (expanding an
index-only batch first, data/ann_store.py), casts the compact fields,
assembles the clip view, runs the model in train mode with dropout keyed
on (seed, step, microbatch), the loss and its backward, and one update;
``train.grad_accum`` = K splits the batch into K microbatches, each
normalised by its own mask, and averages their gradients uniformly.  The
step writes the state in place (parameters, moments, counters and the
step count, an int32 device tensor) and reads nothing back to the host,
so the same body runs eagerly or inside a CUDA graph (train/graphs.py).
The step's averaged gradient stays in each parameter's ``.grad``.

``make_multi_train_step`` / ``make_multi_eval_step`` run K train steps or
E eval batches from a stacked (K, B, ...) batch as one dispatch: on the
card one CUDA graph replay a step (train/graphs.py), elsewhere the same
body in an eager loop; both equal K single steps bitwise.

Data parallelism (``mesh``, train/dist.py): each rank's step takes its
local rows of the global batch.  The loss's counts are summed over the
ranks before the division, so each rank's loss is its share of the global
batch's masked mean (model/loss.py), and ``aux["loss"]`` the global loss;
the flat gradient is summed over the ranks by one all-reduce right after
``FlatGrads.collect``, before the norm, the clipping and the non-finite
guard, so every rank takes the same decisions and the parameters stay
bitwise equal across ranks; dropout numbers the rank's rows from its
first global sample.  With ``train.grad_accum`` = K, microbatch i is the
union of the ranks' local microbatches i (DDP's split; the JAX step
splits the global batch into K contiguous blocks instead), normalised by
its own global counts.  On the card the collectives are captured in the
step's CUDA graph (NCCL); a graphed dispatch on a gloo group raises.
``shard_store``: the feature tables are row-sharded over the ranks and the
gather is collective (data/device_store.py §sharded_gather_from_tables).
Each of these runs over the mesh's data group; the rank's rows are its
data index's.

The model axis (a model from ``get_model(..., mesh=)``): the model ranks
of a data index compute the same loss.  After the data axis's sum, the
gradients of the whole parameters that each model rank holds a part of
(``TrainState.reduce_partial``: the relative-bias tables, and the ring
blocks' qkv and out under ``mdl.sp_attention``) are summed over the model
group; the global norm and the non-finite test count the sharded
parameters' squares over the model ranks and the whole ones once
(``TrainState.grad_stats``), so clipping and the guard decide as one
process does; Adam's moments live with their shard.  A graphed dispatch
captures the model group's NCCL collectives beside the data group's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from vog_tpu_torch.data.ann_store import expand_index_batch
from vog_tpu_torch.data.device_store import gather_from_tables, sharded_gather_from_tables
from vog_tpu_torch.evaluation import evaluate_batch
from vog_tpu_torch.model.loss import compute_loss
from vog_tpu_torch.model.transformer import dropout_key, set_dropout_key
from vog_tpu_torch.sampling import assemble_batch, scores_to_canonical
from vog_tpu_torch.serve import cast_compact
from vog_tpu_torch.train.dist import Mesh, gather_tensor, partial_grad, shard_tensor, tp_rule
from vog_tpu_torch.train.graphs import eval_graph, train_graph

Tree = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
COUNTERS = ("count", "notfinite_count", "total_notfinite")


class Optimizer(NamedTuple):
    init: Callable[[Tree], Dict[str, Any]]
    update: Callable[[Tree, Dict[str, Any], Tree], Tuple[Tree, Dict[str, Any]]]
    # flat gradient, state, flat params (None without weight decay), frozen
    # (None, or a bool tensor: keep every output at its input) -> (flat
    # update, new state, the gradient's global norm)
    flat_update: Callable[..., Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]]
    wd: float  # flat_update reads the flat params only when wd > 0
    lr: Callable[[torch.Tensor], torch.Tensor]  # the schedule: step count -> learning rate


def _flat(tree: Tree) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in tree.values()])


def make_optimizer(cfg) -> Optimizer:
    """clip_by_global_norm -> adam/adamw -> the configured learning rate,
    inside the non-finite guard, as the JAX package's optax chain."""
    t = cfg.train
    warm = max(t.warmup_steps, 1)
    total = max(t.total_steps, t.warmup_steps + 1)

    def lr(count: torch.Tensor) -> torch.Tensor:
        """optax.warmup_cosine_decay_schedule(0, lr, warm, total) or a constant."""
        c = count.float()
        if t.lr_schedule != "cosine":
            return torch.full_like(c, t.lr)
        ramp = (0.0 - t.lr) * (1 - c.clamp(0, warm) / warm) + t.lr
        cc = torch.clamp(c - warm, max=float(total - warm))
        cos = t.lr * (0.5 * (1 + torch.cos(math.pi * cc / (total - warm))))
        return torch.where(count < warm, ramp, cos)

    def init(params: Tree) -> Dict[str, Any]:
        p = next(iter(params.values()))
        n = sum(v.numel() for v in params.values())
        zero = torch.zeros((), dtype=torch.int32, device=p.device)
        return {"count": zero, "notfinite_count": zero.clone(), "total_notfinite": zero.clone(),
                "mu": torch.zeros(n, dtype=p.dtype, device=p.device),
                "nu": torch.zeros(n, dtype=p.dtype, device=p.device)}

    def flat_update(g: torch.Tensor, state: Dict[str, Any], p: Optional[torch.Tensor],
                    frozen: Optional[torch.Tensor] = None, stats=None):
        """``stats``: (finite, norm) of the gradient when it is sharded
        (``TrainState.grad_stats``); else both from ``g``."""
        finite = torch.isfinite(g).all() if stats is None else stats[0]
        bad = torch.where(finite, torch.zeros_like(state["notfinite_count"]), state["notfinite_count"] + 1)
        # without the guard (skip_nonfinite 0) every step applies
        apply = finite | (bad > t.skip_nonfinite)
        total_bad = state["total_notfinite"] + (~finite).to(torch.int32)
        if frozen is not None:
            apply = apply & ~frozen
            bad = torch.where(frozen, state["notfinite_count"], bad)
            total_bad = torch.where(frozen, state["total_notfinite"], total_bad)
        norm = torch.sqrt(torch.sum(g * g)) if stats is None else stats[1]
        count = state["count"]
        # fills, not host copies: no wait for the card
        c1 = 1 - torch.pow(torch.full((), B1, device=count.device), (count + 1).float())
        c2 = 1 - torch.pow(torch.full((), B2, device=count.device), (count + 1).float())
        gc = torch.where(norm < t.grad_clip, g, g / norm * t.grad_clip)
        m = (1 - B1) * gc + B1 * state["mu"]
        v = (1 - B2) * (gc * gc) + B2 * state["nu"]
        u = (m / c1) / (torch.sqrt(v / c2) + EPS)
        if t.wd > 0:
            u = u + t.wd * p
        out = torch.where(apply, u * -lr(count), torch.zeros_like(u))
        new = {"count": torch.where(apply, count + 1, count), "notfinite_count": bad,
               "total_notfinite": total_bad,
               "mu": torch.where(apply, m, state["mu"]), "nu": torch.where(apply, v, state["nu"])}
        return out, new, norm

    def update(grads: Tree, state: Dict[str, Any], params: Tree):
        out, new, _ = flat_update(_flat(grads), state, _flat(params) if t.wd > 0 else None)
        sizes = [v.numel() for v in grads.values()]
        return ({k: o.view_as(v) for (k, v), o in zip(grads.items(), out.split(sizes))}, new)

    return Optimizer(init, update, flat_update, float(t.wd), lr)


class FlatGrads:
    """A persistent flat gradient vector with a view for each parameter
    (the step's ``.grad``s), and a persistent flat update vector with its
    views (what ``_foreach_add_`` adds): allocated once, so a captured step
    writes where an eager one does.  On the model axis: ``sharded`` (a
    bool vector over the flat gradient, or None) marks the parameters this
    rank holds a part of, ``partial`` the whole parameters whose gradient
    each model rank holds a part of (train/dist.py §partial_grad)."""

    def __init__(self, params: List[nn.Parameter], sharded: Optional[List[bool]] = None,
                 partial: Optional[List[bool]] = None):
        self.params = params
        self.sizes = [p.numel() for p in params]
        n = sum(self.sizes)
        p0 = params[0]
        self.grad = torch.zeros(n, dtype=p0.dtype, device=p0.device)
        self.upd = torch.zeros_like(self.grad)
        self.grad_views = [g.view_as(p) for g, p in zip(self.grad.split(self.sizes), params)]
        self.upd_views = [u.view_as(p) for u, p in zip(self.upd.split(self.sizes), params)]
        self.sharded = None
        if sharded is not None and any(sharded):
            self.sharded = torch.cat([torch.full((n,), bool(s), device=p0.device)
                                      for n, s in zip(self.sizes, sharded)])
        self.partial = [g for g, on in zip(self.grad_views, partial or ()) if on]

    def collect(self, accum: int) -> torch.Tensor:
        """The parameters' ``.grad`` (zeros where none) averaged over
        ``accum`` microbatches into the flat vector, which the ``.grad``s
        then view."""
        parts = [torch.zeros_like(p).reshape(-1) if p.grad is None else p.grad.reshape(-1)
                 for p in self.params]
        torch.cat(parts, out=self.grad)
        if accum > 1:
            self.grad.div_(accum)
        for p, g in zip(self.params, self.grad_views):
            p.grad = g
        return self.grad


@dataclass
class TrainState:
    """The model (its parameters), the optimizer and its state, and the
    number of steps taken (an int32 tensor on the parameters' device;
    dropped steps count too, as in the JAX package's TrainState.step).
    Every step updates these tensors in place; ``graphs`` holds the CUDA
    graphs captured on them (train/graphs.py)."""

    model: nn.Module
    tx: Optimizer
    opt_state: Any
    step: torch.Tensor
    flat: FlatGrads
    graphs: Dict[Any, Any] = field(default_factory=dict)
    cfg: Any = None

    @classmethod
    def create(cls, cfg, model: nn.Module) -> "TrainState":
        """The state of ``model``; a model with a model axis (``model.tp``
        or ``model.sp``, ``get_model(..., mesh=)``) marks its sharded and
        partial-gradient parameters (train/dist.py)."""
        tx = make_optimizer(cfg)
        params = dict(model.named_parameters())
        p0 = next(iter(params.values()))
        tp = getattr(model, "tp", None)
        axis = tp or getattr(model, "sp", None)
        sharded = [tp_rule(k, cfg) is not None for k in params] if tp is not None else None
        partial = [partial_grad(k, cfg) for k in params] if axis is not None else None
        return cls(model, tx, tx.init({k: p.detach() for k, p in params.items()}),
                   torch.zeros((), dtype=torch.int32, device=p0.device),
                   FlatGrads(list(params.values()), sharded, partial), cfg=cfg)

    @property
    def axis(self):
        """The mesh of the model's model axis, or None."""
        return getattr(self.model, "tp", None) or getattr(self.model, "sp", None)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the state by name: the parameters, both moments,
        the guard counters and the step count (for snapshots and bitwise
        comparisons)."""
        out = {f"param:{k}": p.detach() for k, p in self.model.named_parameters()}
        out.update({f"opt:{k}": self.opt_state[k] for k in COUNTERS + ("mu", "nu")})
        out["step"] = self.step
        return out

    def leaves(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A flat optimizer vector (``opt_state["mu"]`` or ``["nu"]``) as
        views shaped like the parameters, by name."""
        names = [k for k, _ in self.model.named_parameters()]
        return {k: v.view_as(p) for k, v, p in zip(names, flat.split(self.flat.sizes), self.flat.params)}

    def whole_tensors(self) -> Dict[str, torch.Tensor]:
        """``tensors`` of the whole model: each sharded parameter and its
        moments gathered over the model axis (a collective of the model
        group: each of its ranks calls it), so the file a tensor-parallel
        world saves is the one a single process saves."""
        out = self.tensors()
        tp = getattr(self.model, "tp", None)
        if tp is None:
            return out
        rules = {k: tp_rule(k, self.cfg) for k, _ in self.model.named_parameters()}
        for k in rules:
            out[f"param:{k}"] = gather_tensor(out[f"param:{k}"], rules[k], tp)
        for k in ("mu", "nu"):
            out[f"opt:{k}"] = torch.cat([gather_tensor(v, rules[n], tp).reshape(-1)
                                         for n, v in self.leaves(out[f"opt:{k}"]).items()])
        return out

    def local_tensors(self, whole: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A whole model's ``tensors`` (a checkpoint's) -> this rank's part
        of each (the inverse of ``whole_tensors``, no collective)."""
        tp = getattr(self.model, "tp", None)
        if tp is None:
            return whole
        out = dict(whole)
        names = [k for k, _ in self.model.named_parameters()]
        rules = {k: tp_rule(k, self.cfg) for k in names}
        for k in names:
            if f"param:{k}" in whole:
                out[f"param:{k}"] = shard_tensor(whole[f"param:{k}"], rules[k], tp)
        for k in ("opt:mu", "opt:nu"):
            if k in whole and all(f"param:{n}" in whole for n in names):
                sizes = [whole[f"param:{n}"].numel() for n in names]
                out[k] = torch.cat([shard_tensor(v.view(whole[f"param:{n}"].shape), rules[n], tp).reshape(-1)
                                    for n, v in zip(names, whole[k].split(sizes))])
        return out

    def reduce_partial(self) -> None:
        """Sum the partial-gradient parameters' gradients over the model
        axis (one all-reduce of their concatenation)."""
        views = self.flat.partial
        if not views or self.axis is None:
            return
        joined = torch.cat([v.reshape(-1) for v in views])
        self.axis.all_reduce_(joined, "model")
        torch._foreach_copy_(views, [p.view_as(v) for p, v in zip(joined.split([v.numel() for v in views]),
                                                                    views)])

    def grad_stats(self, g: torch.Tensor):
        """(all finite, global norm) of a gradient whose sharded parameters
        are split over the model axis: the sharded parameters' sum of
        squares and non-finite count summed over the model ranks (one
        all-reduce of two numbers), the whole ones' counted once.  None
        when nothing is sharded."""
        mask = self.flat.sharded
        if mask is None:
            return None
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        sq = torch.where(mask, g * g, zero)
        bad = ~torch.isfinite(g)
        sums = torch.stack([sq.sum(), (bad & mask).sum().to(g.dtype)])
        self.model.tp.all_reduce_(sums, "model")
        rest = torch.where(mask, zero, g * g).sum()
        return (sums[1] == 0) & ~(bad & ~mask).any(), torch.sqrt(sums[0] + rest)

    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in self.tensors().items()}

    def restore(self, snap: Dict[str, torch.Tensor]) -> None:
        """Copy a ``snapshot`` back in place (the tensors keep their
        addresses, so captured graphs stay valid)."""
        with torch.no_grad():
            for k, v in self.tensors().items():
                v.copy_(snap[k])

    def apply_update(self, g: torch.Tensor, frozen: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer update from the flat gradient ``g``, written in
        place; with ``frozen`` (a bool tensor) every tensor keeps its value,
        selected, where it holds.  -> the gradient's global norm."""
        wd = self.tx.wd > 0
        params = self.flat.params
        pflat = torch.cat([p.detach().reshape(-1) for p in params]) if (wd or frozen is not None) else None
        out, new, norm = self.tx.flat_update(g, self.opt_state, pflat if wd else None, frozen, self.grad_stats(g))
        for k in COUNTERS + ("mu", "nu"):
            self.opt_state[k].copy_(new[k])
        if frozen is None:
            self.flat.upd.copy_(out)
            torch._foreach_add_([p.detach() for p in params], self.flat.upd_views)
            self.step.add_(1)
        else:
            # freeze by select (never by adding zero: -0.0 + 0.0 is +0.0)
            self.flat.upd.copy_(torch.where(frozen, pflat, pflat + out))
            torch._foreach_copy_([p.detach() for p in params], self.flat.upd_views)
            self.step.copy_(torch.where(frozen, self.step, self.step + 1))
        return norm


def make_gather(cfg, mesh: Optional[Mesh] = None, shard_store: bool = False) -> Callable:
    """The in-step resolve against the device tables (``_make_gather`` of
    the JAX package): an index-only batch (``ann_row``, with ``ann_i32``
    among the tables) expands first, then ``vid_rows`` gathers the
    features, from the rank's row shard and through ``mesh``'s collectives
    when ``shard_store``."""
    feats = (lambda b, t: sharded_gather_from_tables(b, t, mesh)) if shard_store else gather_from_tables

    def gather(batch: Dict[str, torch.Tensor], tables: Optional[Dict[str, torch.Tensor]]):
        if tables is None:
            return batch
        if "ann_row" in batch and "ann_i32" in tables:
            batch = expand_index_batch(batch, tables, cfg)
        if "vid_rows" in batch:
            batch = feats(batch, tables)
        return batch

    return gather


def _grouped(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.group is not None


def _reducer(mesh: Optional[Mesh]) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The sum over the data axis (None without a data group)."""
    return mesh.all_reduce_ if mesh is not None and mesh.data_group is not None else None


def _check_graphable(mesh: Optional[Mesh]) -> None:
    if _grouped(mesh) and mesh.backend != "nccl":
        raise RuntimeError(f"a graphed dispatch captures its collectives, and the {mesh.backend} process group's "
                           "cannot be captured: run nccl on the card (or the eager make_train_step)")


def _make_step(cfg, mesh: Optional[Mesh] = None, shard_store: bool = False) -> Callable:
    """-> ``step(state, batch, seed, tables, frozen) -> (aux, frozen)``:
    one train step in place.  ``frozen`` None: no freeze; a bool tensor:
    the state keeps every value where ``frozen | ~isfinite(loss)`` holds,
    and that flag is returned (the multi-step's sticky poison)."""
    conc = cfg.ds.conc_type
    accum = max(int(cfg.train.grad_accum), 1)
    t = cfg.train
    num_cmp = cfg.ds.num_cmp if conc == "sep" else 1
    gather = make_gather(cfg, mesh, shard_store)
    reduce = _reducer(mesh)
    rank = mesh.data_index if mesh is not None else 0

    def micro_loss(model, mb, tables):
        clip = assemble_batch(cast_compact(gather(mb, tables)), conc)
        loss, _ = compute_loss(model(clip), clip, t.pos_weight, t.loss_type, t.rank_weight,
                               rank_num_cmp=num_cmp, reduce_counts=reduce)
        return loss

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
             tables: Optional[Dict[str, torch.Tensor]] = None, frozen: Optional[torch.Tensor] = None):
        model = state.model.train()
        for p in state.flat.params:
            p.grad = None
        B = next(iter(batch.values())).shape[0]
        if B % accum:
            raise ValueError(f"train.grad_accum={accum} must divide the batch size {B}")
        mbs = B // accum
        losses = []
        for i in range(accum):
            set_dropout_key(model, dropout_key(seed, state.step, i), samples=(rank * mbs, mbs))
            mb = batch if accum == 1 else {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
            loss = micro_loss(model, mb, tables)
            loss.backward()
            losses.append(loss.detach())
        with torch.no_grad():
            g = state.flat.collect(accum)
            loss = torch.stack(losses).mean()
            if reduce is not None:  # the shares of the global loss and its gradient
                reduce(g)
                loss = reduce(loss)
            state.reduce_partial()
            if frozen is not None:
                frozen = frozen | ~torch.isfinite(loss)
            aux = {"loss": loss, "grad_norm": state.apply_update(g, frozen)}
            if t.skip_nonfinite > 0:
                aux["guard_notfinite"] = state.opt_state["notfinite_count"].clone()
        return aux, frozen

    return step


def make_train_step(cfg, mesh: Optional[Mesh] = None, shard_store: bool = False) -> Callable:
    """-> ``train_step(state, batch, seed, tables=None) -> (state, aux)``.
    ``batch`` holds tensors on the model's device; with ``tables`` (the
    device-resident feature tables, and the annotation tables) it may
    carry ``vid_rows`` in place of props/seg_feats, or be index-only.
    aux: ``loss`` (the microbatches' mean), ``grad_norm`` (before
    clipping) and, with the guard, ``guard_notfinite``.  Eager, on any
    device: this is the ``steps_per_dispatch`` = 1 path.  ``mesh``: data
    parallelism over its ranks (``batch`` holds this rank's rows)."""
    step = _make_step(cfg, mesh, shard_store)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
                   tables: Optional[Dict[str, torch.Tensor]] = None):
        aux, _ = step(state, batch, seed, tables)
        return state, aux

    return train_step


def make_eval_step(cfg, mesh: Optional[Mesh] = None, shard_store: bool = False) -> Callable:
    """-> ``eval_step(state, batch, tables=None) -> out``: the model in
    eval mode, the loss with ``compute_loss``'s defaults, and
    ``evaluate_batch`` (compact when ``train.eval_max_pairs`` > 0; < 0
    means 2 A, one or two annotated frames an arg in ASRL), plus
    ``loss_sum`` = loss * n_batch and ``n_batch`` = max(sum(batch_mask),
    1) for aggregation.  With ``mesh`` the loss and n_batch are the global
    batch's, and the outputs additive over the ranks (what
    ``train/multihost.py §gather_eval`` sums): each rank's ``loss_sum`` is
    its share of the loss times the global n_batch, and rank 0 alone
    reports n_batch."""
    conc = cfg.ds.conc_type
    gather = make_gather(cfg, mesh, shard_store)
    reduce = _reducer(mesh)
    rank = mesh.data_index if mesh is not None else 0
    max_pairs = int(cfg.train.eval_max_pairs)
    if max_pairs < 0:
        max_pairs = 2 * cfg.ds.max_srl_args

    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  tables: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        model = state.model.eval()
        with torch.no_grad():
            b = cast_compact(gather(batch, tables))
            clip = assemble_batch(b, conc)
            logits = model(clip)
            loss, _ = compute_loss(logits, clip, reduce_counts=reduce)
            B, V, F, P = b["prop_mask"].shape
            out = evaluate_batch(scores_to_canonical(logits, conc, B, V, F, P), b["prop_boxes"],
                                 b["gt_boxes"], b["gt_frame_mask"], b["srl_arg_mask"], b["pos_vid"],
                                 b["batch_mask"], b["prop_mask"], max_pairs=max_pairs)
            nb = b["batch_mask"].sum()
            if reduce is not None:
                nb = reduce(nb)
            nb = nb.clamp(min=1.0)
            out["loss_sum"] = loss * nb
            out["n_batch"] = nb if rank == 0 else torch.zeros_like(nb)
        return out

    return eval_step


def dispatch_sizes(cfg) -> Tuple[int, int]:
    """(K, E): train steps and eval batches a dispatch.
    ``eval_batches_per_dispatch`` 0 follows ``steps_per_dispatch``, 1 is
    off."""
    k = max(int(cfg.train.steps_per_dispatch), 1)
    e = int(cfg.train.eval_batches_per_dispatch)
    return k, (k if e == 0 else max(e, 1))


def _slot(stacked: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v[i]) for k, v in stacked.items()}


def _stack(outs: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _on_card(state: TrainState) -> bool:
    return state.step.device.type == "cuda"


def make_multi_train_step(cfg, mesh: Optional[Mesh] = None, shard_store: bool = False) -> Callable:
    """K train steps as one dispatch (``train.steps_per_dispatch``):
    ``multi_step(state, stacked, seed, tables=None) -> (state, auxs)``,
    ``stacked`` a dict of (K, B, ...) host arrays, every aux
    with a leading K axis.  Bitwise equal to K ``train_step`` calls; every
    step advances ``state.step``.

    With ``skip_nonfinite`` 0 a sticky poisoned flag trips on a non-finite
    loss, and from that step on the whole state (parameters, moments,
    counters, step count) is frozen by select, so the state the host reads
    at the dispatch boundary holds the last clean values; with the guard
    on, the guard drops bad updates and no freeze runs.

    On the card each dispatch is one copy of the stacked batch into a
    captured step's static input and K replays of that graph
    (train/graphs.py); a shorter group (an epoch's tail) replays it fewer
    times.  A capture or replay that fails raises: nothing falls back to
    the eager loop.  Elsewhere the same body runs in an eager loop.
    ``mesh``, ``shard_store``: as ``make_train_step``; the graph holds the
    step's collectives, so on the card the group must be NCCL."""
    step = _make_step(cfg, mesh, shard_store)
    freeze = int(cfg.train.skip_nonfinite) == 0

    def multi_step(state: TrainState, stacked: Dict[str, Any], seed: int,
                   tables: Optional[Dict[str, torch.Tensor]] = None):
        n = len(next(iter(stacked.values())))
        if _on_card(state):
            _check_graphable(mesh)
            return state, train_graph(step, freeze, state, stacked, seed, tables, _grouped(mesh))(stacked, n)
        frozen = torch.zeros((), dtype=torch.bool, device=state.step.device) if freeze else None
        auxs = []
        for i in range(n):
            aux, frozen = step(state, _slot(stacked, i), seed, tables, frozen)
            auxs.append(aux)
        return state, _stack(auxs)

    return multi_step


def make_multi_eval_step(cfg, mesh: Optional[Mesh] = None, shard_store: bool = False) -> Callable:
    """E eval batches as one dispatch (``train.eval_batches_per_dispatch``):
    ``multi_eval(state, stacked, tables=None)`` -> every ``eval_step``
    output with a leading E axis, bitwise equal to E ``eval_step`` calls.
    On the card one replay a batch of a captured eval step, as
    ``make_multi_train_step``."""
    step = make_eval_step(cfg, mesh, shard_store)

    def multi_eval(state: TrainState, stacked: Dict[str, Any],
                   tables: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        n = len(next(iter(stacked.values())))
        if _on_card(state):
            _check_graphable(mesh)
            return eval_graph(step, state, stacked, tables, _grouped(mesh))(stacked, n)
        return _stack([step(state, _slot(stacked, i), tables) for i in range(n)])

    return multi_eval
