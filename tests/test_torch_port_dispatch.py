"""The port's fused dispatches (``make_multi_train_step``,
``make_multi_eval_step``) against the JAX package's and against their own
single steps, on the CPU (where they run their eager loop; the card's CUDA
graphs are held to the same single steps by tests/test_torch_port_cuda.py
and chip_smoke.py):

  * K = 3 steps (dropout 0, with and without ``grad_accum=2``) against
    ``vog_tpu.train.state.make_multi_train_step``: each step's loss and
    grad_norm within 1e-4 relative, the guard counters and the step count
    equal, Adam's first moment within the train step's gradient limit
    (1e-4 * max(1, max|m|) a leaf), and each leaf's parameter change within
    1e-2 relative (Frobenius norms) where the first moment exceeds 1e-3 of
    the leaf's largest (Adam gives a rounding-level gradient a full step);
  * the port's multi-step bitwise equal to 3 of its single steps, with
    dropout on (state and every aux);
  * freeze on NaN (``skip_nonfinite`` 0, a NaN planted in step 2's batch
    of 3): the state frozen after step 1, bitwise the single step's state,
    its step count 1 as JAX's, and JAX's frozen moments within the
    limit above; with ``skip_nonfinite`` > 0 no freeze: the guard drops
    step 2 and the step count reaches 3 on both sides;
  * ``make_multi_eval_step`` bitwise equal to E single eval steps, and its
    count sums equal to the JAX package's multi-eval;
  * ``dispatch_sizes``: ``eval_batches_per_dispatch`` 0 follows
    ``steps_per_dispatch``, 1 is off.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _cfg, _glove, _random_batch
from tests.test_torch_port_model import port_cfg
from tests.test_torch_port_train import _adam_mu
from vog_tpu.train import state as jstate
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.model.grounding import get_model
from vog_tpu_torch.train import (
    TrainState,
    dispatch_sizes,
    make_eval_step,
    make_multi_eval_step,
    make_multi_train_step,
    make_train_step,
)

B, K = 4, 3


def _cfgs(dropout=0.0, accum=1, skip=3):
    cfg = _cfg(tiny=True)
    cfg.mdl.dropout = dropout
    t = cfg.train
    t.lr, t.lr_schedule, t.grad_clip, t.skip_nonfinite, t.pos_weight = 1e-3, "const", 1e6, skip, 5.0
    t.grad_accum = accum
    return cfg, port_cfg(cfg)


def _stacked(cfg, nan_at=None):
    bs = [_random_batch(cfg, B, seed=20 + i) for i in range(K)]
    for b in bs:
        b["prop_mask"][1, 2, :, 4] = 0.0
    if nan_at is not None:
        bs[nan_at]["props"][0, 0, 0, 0, 0] = np.nan
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _jax_run(cfg, stacked):
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    new, auxs = jax.jit(jstate.make_multi_train_step(cfg))(
        state, {k: jnp.asarray(v) for k, v in stacked.items()}, jax.random.PRNGKey(1))
    return state, new, jax.tree.map(np.asarray, auxs)


def _port_state(pcfg, jparams=None, seed=0):
    model = get_model(pcfg, 400, device="cpu", seed=seed, train=True)
    if jparams is not None:
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), pcfg), strict=True)
    return TrainState.create(pcfg, model)


def _torch(stacked):
    return {k: torch.from_numpy(v) for k, v in stacked.items()}


def _close_leaves(got, ref):
    for k, r in ref.items():
        r = r.numpy()
        err = np.abs(got[k].numpy() - r).max()
        assert err <= 1e-4 * max(1.0, np.abs(r).max()), (k, err)


def _moments(jstate_opt, pcfg):
    return params_from_jax(jax.tree.map(np.asarray, _adam_mu(jstate_opt)), pcfg)


@pytest.mark.parametrize("accum", [1, 2])
def test_multi_step_matches_jax(accum):
    cfg, pcfg = _cfgs(accum=accum)
    stacked = _stacked(cfg)
    j0, j1, jaux = _jax_run(cfg, stacked)
    ts = _port_state(pcfg, j0.params)
    before = {k: p.detach().clone() for k, p in ts.model.named_parameters()}
    ts, aux = make_multi_train_step(pcfg)(ts, _torch(stacked), seed=0)
    for k in ("loss", "grad_norm"):
        assert aux[k].shape == (K,)
        np.testing.assert_allclose(aux[k].numpy(), jaux[k], rtol=1e-4)
    assert np.array_equal(aux["guard_notfinite"].numpy(), jaux["guard_notfinite"])
    assert int(ts.step) == int(j1.step) == K
    mu = _moments(j1.opt_state, pcfg)
    _close_leaves(ts.leaves(ts.opt_state["mu"]), mu)
    jp1, jp0 = params_from_jax(jax.tree.map(np.asarray, j1.params), pcfg), \
        params_from_jax(jax.tree.map(np.asarray, j0.params), pcfg)
    for k, p in ts.model.named_parameters():
        # Adam turns a gradient at rounding level (an attention key bias,
        # zero in exact arithmetic) into a full-size step of either sign:
        # compare the change where the first moment stands clear of it
        sig = mu[k].abs() > 1e-3 * max(float(mu[k].abs().max()), 1e-30)
        dj = (jp1[k] - jp0[k]).double()[sig]
        dp = (p.detach() - before[k]).double()[sig]
        if dj.numel() and dj.norm() > 0:
            assert float((dp - dj).norm() / dj.norm()) <= 1e-2, k


@pytest.mark.parametrize("accum", [1, 2])
def test_multi_step_bitwise_single_steps(accum):
    cfg, pcfg = _cfgs(dropout=0.1, accum=accum)
    stacked = _torch(_stacked(cfg))
    multi, single = _port_state(pcfg, seed=2), _port_state(pcfg, seed=2)
    multi, maux = make_multi_train_step(pcfg)(multi, stacked, seed=5)
    step = make_train_step(pcfg)
    saux = [step(single, {k: v[i] for k, v in stacked.items()}, seed=5)[1] for i in range(K)]
    a, b = multi.tensors(), single.tensors()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in maux:
        assert torch.equal(maux[k], torch.stack([x[k] for x in saux])), k
    assert int(multi.step) == K


def test_freeze_on_nan_matches_jax():
    cfg, pcfg = _cfgs(skip=0)
    stacked = _stacked(cfg, nan_at=1)
    j0, j1, jaux = _jax_run(cfg, stacked)
    ts = _port_state(pcfg, j0.params)
    ts, aux = make_multi_train_step(pcfg)(ts, _torch(stacked), seed=0)
    assert np.isnan(float(aux["loss"][1])) and np.isnan(jaux["loss"][1])
    np.testing.assert_allclose(aux["loss"][[0, 2]].numpy(), jaux["loss"][[0, 2]], rtol=1e-4)
    assert int(ts.step) == int(j1.step) == 1  # frozen after step 1, the count too
    _close_leaves(ts.leaves(ts.opt_state["mu"]), _moments(j1.opt_state, pcfg))
    ref = _port_state(pcfg, j0.params)
    make_train_step(pcfg)(ref, {k: v[0] for k, v in _torch(stacked).items()}, seed=0)
    a, b = ts.tensors(), ref.tensors()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert all(torch.isfinite(p).all() for p in ts.model.parameters())


def test_no_freeze_with_the_guard():
    cfg, pcfg = _cfgs(skip=3)
    stacked = _stacked(cfg, nan_at=1)
    j0, j1, jaux = _jax_run(cfg, stacked)
    ts = _port_state(pcfg, j0.params)
    ts, aux = make_multi_train_step(pcfg)(ts, _torch(stacked), seed=0)
    assert int(ts.step) == int(j1.step) == K
    assert int(ts.opt_state["total_notfinite"]) == int(j1.opt_state.total_notfinite) == 1
    assert aux["guard_notfinite"].tolist() == jaux["guard_notfinite"].tolist() == [0, 1, 0]
    assert int(ts.opt_state["count"]) == 2  # the dropped step left the schedule's count
    _close_leaves(ts.leaves(ts.opt_state["mu"]), _moments(j1.opt_state, pcfg))
    single = _port_state(pcfg, j0.params)
    step = make_train_step(pcfg)
    for i in range(K):
        step(single, {k: v[i] for k, v in _torch(stacked).items()}, seed=0)
    a, b = ts.tensors(), single.tensors()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_multi_eval_matches_single_steps_and_jax():
    cfg, pcfg = _cfgs()
    stacked = _stacked(cfg)
    # GT boxes on video 0's first proposal of each frame: some hits
    stacked["gt_boxes"] = np.broadcast_to(stacked["prop_boxes"][:, :, None, 0, :, 0, :4],
                                          stacked["gt_boxes"].shape).copy()
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    ref = jax.jit(jstate.make_multi_eval_step(cfg))(state, {k: jnp.asarray(v) for k, v in stacked.items()})
    ts = _port_state(pcfg, state.params)
    got = make_multi_eval_step(pcfg)(ts, _torch(stacked))
    step = make_eval_step(pcfg)
    singles = [step(ts, {k: v[i] for k, v in _torch(stacked).items()}) for i in range(K)]
    assert set(got) == set(ref)
    for k in got:
        assert got[k].shape[0] == K
        assert torch.equal(got[k], torch.stack([s[k] for s in singles])), k
    for k in ("n_pairs", "n_acc", "n_vacc", "n_queries", "n_strict", "n_cons", "pair_arg", "pair_frame"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    np.testing.assert_allclose(got["loss_sum"].numpy(), np.asarray(ref["loss_sum"]), rtol=1e-4)


@pytest.mark.parametrize("k,e,want", [(16, 10, (16, 10)), (16, 0, (16, 16)), (16, 1, (16, 1)),
                                      (1, 0, (1, 1)), (0, 0, (1, 1))])
def test_dispatch_sizes(k, e, want):
    _, pcfg = _cfgs()
    pcfg.train = dataclasses.replace(pcfg.train, steps_per_dispatch=k, eval_batches_per_dispatch=e)
    assert dispatch_sizes(pcfg) == want
