"""Worlds of gloo processes on the CPU for the port's mesh tests: the data
axis (``test_torch_port_dist.py``, ``test_torch_port_multihost.py``) and
the model axis (``test_torch_port_tp.py``, ``test_torch_port_ring.py``).

``run_world(fn, world, *args)`` spawns ``world`` processes, each joining
one gloo group (rendezvous through a file, so parallel test workers
never share a port) and running ``fn(rank, world, *args)``; each rank's
return value comes back in rank order.  A rank that raises fails the
call with its traceback; a world still running at ``timeout`` seconds is
killed and the call raises ``TimeoutError``.  This module imports torch
and the port only (the children never import JAX).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD_TIMEOUT = 50.0  # seconds: each test stays within 60 s


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, f"{tmp}/result{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, *args, timeout: float = WORLD_TIMEOUT) -> list:
    tmp = tempfile.mkdtemp(prefix="vog_world_")
    try:
        ctx = mp.start_processes(_entry, args=(fn, world, tmp, args), nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"a world of {world} ranks ran past {timeout} s")
        return [torch.load(f"{tmp}/result{r}.pt", weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _mesh(cfg):
    from vog_tpu_torch.train.dist import make_mesh

    cfg.misc.multihost = True
    return make_mesh(cfg)


def _local(batch, mesh):
    from vog_tpu_torch.train.dist import local_batch_rows

    B = len(next(iter(batch.values())))
    lo, hi = local_batch_rows(mesh, B)
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])) for k, v in batch.items()}


def mesh_worlds(rank, world, values):
    """``make_mesh`` for each ``misc.mesh_data`` of ``values`` -> (rank,
    world, backend, the rows of a global batch of 6), or the error."""
    from vog_tpu_torch.config import Cfg
    from vog_tpu_torch.train.dist import local_batch_rows

    out = []
    for d in values:
        cfg = Cfg()
        cfg.misc.mesh_data = d
        try:
            mesh = _mesh(cfg)
        except ValueError as e:
            out.append(str(e))
            continue
        out.append((mesh.rank, mesh.world, mesh.backend, local_batch_rows(mesh, 6)))
    return out


def train_steps(rank, world, cfgs, sd, batches, vocab):
    """For each config of ``cfgs``, from ``sd``: the data-parallel train
    step on this rank's rows of each global batch -> per step (loss,
    grad_norm, the flat gradient), and the state after the last step."""
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step

    out = []
    for cfg in cfgs:
        mesh = _mesh(cfg)
        model = get_model(cfg, vocab, device="cpu", train=True)
        model.load_state_dict(sd, strict=True)
        state = TrainState.create(cfg, model)
        step = make_train_step(cfg, mesh)
        steps = []
        for b in batches:
            state, aux = step(state, _local(b, mesh), seed=0)
            steps.append({"loss": aux["loss"].clone(), "grad_norm": aux["grad_norm"].clone(),
                          "grad": state.flat.grad.clone()})
        out.append({"steps": steps, "state": state.snapshot()})
    return out


def sharded_gather(rank, world, cfg, tables, batch):
    """``tables`` (the full packed tables, padded to a multiple of the
    world) row-sharded: this rank keeps its block and resolves its rows of
    ``batch`` through ``sharded_gather_from_tables``."""
    from vog_tpu_torch.data.device_store import sharded_gather_from_tables

    mesh = _mesh(cfg)
    n = tables["feats"].shape[0] // world
    mine = {k: v[rank * n:(rank + 1) * n].clone() for k, v in tables.items()}
    out = sharded_gather_from_tables(_local(batch, mesh), mine, mesh)
    return {k: out[k] for k in ("props", "seg_feats")}


def eval_gather(rank, world, cases):
    """``gather_eval`` of this rank's (sums, preds) in each case."""
    from vog_tpu_torch.train.multihost import gather_eval

    return [gather_eval(*per_rank[rank]) for per_rank in cases]


def learner_runs(rank, world, cfg, sd, epochs):
    """A Learner of this world: ``epochs`` epochs from ``sd`` (uid "dp"),
    then the same run cut after its first epoch and resumed from "last" to
    the end (uid "dpr") -> the per-step losses, each epoch's metrics, the
    final states of both runs."""
    import copy

    from vog_tpu_torch.data.loader import get_data
    from vog_tpu_torch.train.learner import Learner

    def learner(uid, **train):
        c = copy.deepcopy(cfg)
        for k, v in train.items():
            setattr(c.train, k, v)
        mesh = _mesh(c)
        lrn = Learner(uid, get_data(c, mesh), c, device="cpu", mesh=mesh)
        if not train.get("resume"):
            lrn.model.load_state_dict(sd, strict=True)
        return lrn

    losses, metrics = [], []
    lrn = learner("dp")
    multi = lrn._train_multi

    def record(*a, **kw):
        st, aux = multi(*a, **kw)
        losses.extend(aux["loss"].reshape(-1).tolist())
        return st, aux

    lrn._train_multi = record
    for _ in range(epochs):
        metrics.append(lrn.fit(1))
    cut = learner("dpr")
    cut.fit(1)
    resumed = learner("dpr", resume=True)
    resumed.fit()
    return {"losses": losses, "metrics": metrics, "state": lrn.state.snapshot(),
            "resumed": resumed.state.snapshot(), "epoch": resumed.epoch}


def cli_train(rank, world, argv):
    """``cli.train.main(argv)`` on this rank (the group exists: its
    ``init_distributed`` keeps it) -> the final metrics."""
    from vog_tpu_torch.cli import train

    return train.main(list(argv))


def learner_sigterm(rank, world, cfg, cut_after):
    """A Learner of this world whose rank 1 alone gets a SIGTERM (its flag
    set, as the handler does) after dispatch ``cut_after`` -> (batch in
    epoch where ``fit`` left, the step count)."""
    from vog_tpu_torch.data.loader import get_data
    from vog_tpu_torch.train.learner import Learner

    mesh = _mesh(cfg)
    lrn = Learner("term", get_data(cfg, mesh), cfg, device="cpu", mesh=mesh)
    multi, n = lrn._train_multi, [0]

    def dispatch(*a, **kw):
        out = multi(*a, **kw)
        n[0] += 1
        if rank == 1 and n[0] == cut_after:
            lrn._preempted = True
        return out

    lrn._train_multi = dispatch
    lrn.fit()
    return lrn.batch_in_epoch, int(lrn.state.step)


def _model_mesh(cfg, mesh_model: int):
    cfg.misc.mesh_model = mesh_model
    return _mesh(cfg)


def _whole_grad(state, mesh, cfg):
    """The step's flat gradient of the whole model: each sharded leaf's
    gathered over the model group, in the parameters' order."""
    from vog_tpu_torch.train.dist import gather_tensor, tp_rule

    leaves = state.leaves(state.flat.grad)
    tp = state.model.tp
    return torch.cat([(gather_tensor(v, tp_rule(k, cfg), tp) if tp is not None else v).reshape(-1)
                      for k, v in leaves.items()])


def tp_steps(rank, world, cfgs, sd, batches, vocab, mesh_model):
    """For each config of ``cfgs``, from the whole ``sd`` (or the config's
    of a list of them): a world of
    (world / mesh_model, mesh_model) takes the train step on this data
    index's rows of each global batch -> per step (loss, grad_norm, the
    whole flat gradient), this rank's whole (unsharded) parameters after
    the steps, and the gathered state."""
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step
    from vog_tpu_torch.train.dist import shard_state_dict, tp_rule

    out = []
    for cfg, whole_sd in zip(cfgs, sd if isinstance(sd, list) else [sd] * len(cfgs)):
        mesh = _model_mesh(cfg, mesh_model)
        model = get_model(cfg, vocab, device="cpu", train=True, mesh=mesh)
        model.load_state_dict(shard_state_dict(whole_sd, mesh, cfg), strict=True)
        state = TrainState.create(cfg, model)
        step = make_train_step(cfg, mesh)
        steps = []
        for b in batches:
            state, aux = step(state, _local(b, mesh), seed=0)
            steps.append({"loss": aux["loss"].clone(), "grad_norm": aux["grad_norm"].clone(),
                          "grad": _whole_grad(state, mesh, cfg)})
        whole = {k: v.detach().clone() for k, v in model.named_parameters() if tp_rule(k, cfg) is None}
        out.append({"steps": steps, "whole_params": whole, "state": state.whole_tensors()})
    return out


def ring_cases(rank, world, cases, device="cpu"):
    """``ring_attention`` over a model axis of ``world``: for each case
    (q, k, v, mask, bias or None, frame ids, the output's cotangent), this
    rank's T/world block forward and backward on ``device`` -> (output
    block, dq, dk, dv blocks, this rank's partial frame-bias gradient or
    None), on the CPU."""
    from vog_tpu_torch.config import Cfg
    from vog_tpu_torch.kernels.ring_attention import ring_attention

    cfg = Cfg()
    cfg.mdl.n_heads = world
    mesh = _model_mesh(cfg, world)
    out = []
    for case in cases:
        q, k, v, mask, bias, fids, cot = (None if t is None else t.to(device) for t in case)
        n = q.shape[2] // world
        sl = slice(rank * n, (rank + 1) * n)
        qs, ks, vs = (t[:, :, sl].clone().requires_grad_(True) for t in (q, k, v))
        b = None if bias is None else bias.clone().requires_grad_(True)
        o = ring_attention(qs, ks, vs, mask[:, sl], b, None if bias is None else fids[sl], mesh)
        o.backward(cot[:, :, sl])
        out.append(tuple(None if t is None else t.cpu() for t in (o.detach(), qs.grad, ks.grad, vs.grad,
                                                                  None if b is None else b.grad)))
    return out


def tp_learner(rank, world, argv, cfg, one_ckpt):
    """``cli.train`` on a model axis of ``world`` (argv sets it); then a
    Learner of ``cfg`` on the same mesh loads the single process's
    checkpoint ``one_ckpt`` -> (the final metrics, the loaded state
    gathered whole)."""
    from vog_tpu_torch.cli import train
    from vog_tpu_torch.data.loader import get_data
    from vog_tpu_torch.train.learner import Learner

    metrics = train.main(list(argv))
    mesh = _mesh(cfg)
    lrn = Learner("tp_load", get_data(cfg, mesh), cfg, device="cpu", mesh=mesh)
    lrn.load(one_ckpt)
    return metrics, lrn.state.whole_tensors()


def serve_follow(rank, world, cfg, sd, vocab, requests, max_batch):
    """A ``Predictor`` on a model axis of ``world`` with the ring: rank 0
    serves ``requests`` through a ``ServingLoop`` (the followers pair with
    each flush) -> the responses; the other ranks -> the number of flushes
    they followed."""
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.serving import ServingLoop

    mesh = _model_mesh(cfg, world)
    pred = Predictor(cfg, sd, vocab, device="cpu", cuda_graphs=False, mesh=mesh)
    if mesh.model_index != 0:
        return pred.follow()
    loop = ServingLoop(pred, max_batch=max_batch, max_wait_ms=50.0)
    try:
        futs = [loop.submit(r) for r in requests]
        return [f.result(timeout=40) for f in futs]
    finally:
        loop.close()
        pred.close()


def mesh_checks(rank, world, cfgs, sd, faults):
    """On a model axis of ``world``: for each config, ``sd`` sharded and
    gathered back (-> the gathered state dict, this rank's shapes, the
    count of sharded entries); then ``make_mesh`` of a ``Cfg`` with each
    fault (group, field, value) set -> its message."""
    from vog_tpu_torch.config import Cfg
    from vog_tpu_torch.train.dist import gather_state_dict, make_mesh, shard_state_dict, tp_rule

    trips = []
    for cfg in cfgs:
        mesh = _model_mesh(cfg, world)
        part = shard_state_dict(sd, mesh, cfg)
        trips.append((gather_state_dict(part, mesh, cfg), {k: tuple(v.shape) for k, v in part.items()},
                      sum(tp_rule(k, cfg) is not None for k in sd)))
    msgs = []
    for group, field, value in faults:
        cfg = Cfg()
        cfg.misc.multihost, cfg.misc.mesh_model = True, world
        setattr(getattr(cfg, group), field, value)
        try:
            make_mesh(cfg)
            msgs.append("accepted")
        except ValueError as e:
            msgs.append(str(e))
    return {"round_trips": trips, "faults": msgs}
