"""Optimizer, non-finite guard and the train step (counterpart of
vog_tpu/train/state.py).

``make_optimizer`` does in one update what the JAX package's optax chain
does, step for step, over dicts of tensors (parameter name -> tensor):

  * ``clip_by_global_norm``: g * max_norm / |g| when |g| >= max_norm (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
  * ``adam`` / ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, bias-corrected; adamw
    adds wd * param before the learning rate), the learning rate from
    ``warmup_cosine_decay_schedule`` (0 at step 0 under warm-up) or a
    constant;
  * ``skip_nonfinite_guard``: a step with a non-finite gradient leaves the
    parameters, the moments and the schedule's count as they were; after
    more than K such steps in a row the raw update is applied.

Every counter stays a tensor on the parameters' device, so a step never
waits for the card.  A parameter with no gradient (the frozen embedding)
gets a zero gradient, as optax sees one: adam leaves it, adamw decays it.

``make_train_step`` gathers from the device tables, casts the compact
fields, assembles the clip view, runs the model in train mode with dropout
drawn from a generator seeded from (seed, step, microbatch), the loss and
its backward, and one update; ``train.grad_accum`` = K splits the batch
into K microbatches, each normalised by its own mask, and averages their
gradients uniformly.  The step's averaged gradient stays in each
parameter's ``.grad``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from vog_tpu_torch.data.device_store import gather_from_tables
from vog_tpu_torch.model.loss import compute_loss
from vog_tpu_torch.model.transformer import set_dropout_generator
from vog_tpu_torch.sampling import assemble_batch
from vog_tpu_torch.serve import cast_compact

Tree = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


class Optimizer(NamedTuple):
    init: Callable[[Tree], Dict[str, Any]]
    update: Callable[[Tree, Dict[str, Any], Tree], Tuple[Tree, Dict[str, Any]]]


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))


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
        zero = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
        return {"count": zero, "notfinite_count": zero.clone(), "total_notfinite": zero.clone(),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads: Tree, state: Dict[str, Any], params: Tree):
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        bad = torch.where(finite, torch.zeros_like(state["notfinite_count"]), state["notfinite_count"] + 1)
        # without the guard (skip_nonfinite 0) every step applies
        apply = finite | (bad > t.skip_nonfinite)
        norm = global_norm(grads)
        keep = norm < t.grad_clip
        count = state["count"]
        # fills, not host copies: no wait for the card
        c1 = 1 - torch.pow(torch.full((), B1, device=count.device), (count + 1).float())
        c2 = 1 - torch.pow(torch.full((), B2, device=count.device), (count + 1).float())
        step = -lr(count)
        mu, nu, out = {}, {}, {}
        for k, g in grads.items():
            g = torch.where(keep, g, g / norm * t.grad_clip)
            m = (1 - B1) * g + B1 * state["mu"][k]
            v = (1 - B2) * (g * g) + B2 * state["nu"][k]
            u = (m / c1) / (torch.sqrt(v / c2) + EPS)
            if t.wd > 0:
                u = u + t.wd * params[k]
            out[k] = torch.where(apply, u * step, torch.zeros_like(u))
            mu[k] = torch.where(apply, m, state["mu"][k])
            nu[k] = torch.where(apply, v, state["nu"][k])
        return out, {"count": torch.where(apply, count + 1, count), "notfinite_count": bad,
                     "total_notfinite": state["total_notfinite"] + (~finite).to(torch.int32),
                     "mu": mu, "nu": nu}

    return Optimizer(init, update)


@dataclass
class TrainState:
    """The model (its parameters), the optimizer and its state, and the
    number of steps taken (dropped steps count too, as in the JAX
    package's TrainState.step)."""

    model: nn.Module
    tx: Optimizer
    opt_state: Any
    step: int = 0

    @classmethod
    def create(cls, cfg, model: nn.Module) -> "TrainState":
        tx = make_optimizer(cfg)
        return cls(model, tx, tx.init({k: p.detach() for k, p in model.named_parameters()}))


def dropout_generator(device: torch.device, seed: int, step: int, micro: int = 0) -> torch.Generator:
    """A generator seeded from (seed, step, microbatch): the same masks for
    the same triple, unrelated masks for any other."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step, micro]).generate_state(1, np.uint64)[0]))
    return g


def make_train_step(cfg) -> Callable:
    """-> ``train_step(state, batch, seed, tables=None) -> (state, aux)``.
    ``batch`` holds tensors on the model's device; with ``tables`` (the
    device-resident feature tables) it may carry ``vid_rows`` in place of
    props/seg_feats.  aux: ``loss`` (the microbatches' mean), ``grad_norm``
    (before clipping) and, with the guard, ``guard_notfinite``."""
    conc = cfg.ds.conc_type
    accum = max(int(cfg.train.grad_accum), 1)
    t = cfg.train
    num_cmp = cfg.ds.num_cmp if conc == "sep" else 1

    def micro_loss(model, mb, tables):
        if tables is not None and "vid_rows" in mb:
            mb = gather_from_tables(mb, tables)
        clip = assemble_batch(cast_compact(mb), conc)
        loss, _ = compute_loss(model(clip), clip, t.pos_weight, t.loss_type, t.rank_weight,
                               rank_num_cmp=num_cmp)
        return loss

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
                   tables: Optional[Dict[str, torch.Tensor]] = None):
        model = state.model.train()
        params = dict(model.named_parameters())
        dev = next(iter(params.values())).device
        for p in params.values():
            p.grad = None
        B = next(iter(batch.values())).shape[0]
        if B % accum:
            raise ValueError(f"train.grad_accum={accum} must divide the batch size {B}")
        mbs = B // accum
        losses = []
        for i in range(accum):
            set_dropout_generator(model, dropout_generator(dev, seed, state.step, i))
            mb = batch if accum == 1 else {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
            loss = micro_loss(model, mb, tables)
            loss.backward()
            losses.append(loss.detach())
        with torch.no_grad():
            grads = {}
            for k, p in params.items():
                g = torch.zeros_like(p) if p.grad is None else p.grad / accum
                p.grad = g
                grads[k] = g
            aux = {"loss": torch.stack(losses).mean(), "grad_norm": global_norm(grads)}
            values = {k: p.detach() for k, p in params.items()}
            updates, state.opt_state = state.tx.update(grads, state.opt_state, values)
            for k, p in params.items():
                p.add_(updates[k])
            if t.skip_nonfinite > 0:
                aux["guard_notfinite"] = state.opt_state["notfinite_count"]
        state.step += 1
        return state, aux

    return train_step
