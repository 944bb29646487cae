"""The shapes the card's attention kernels take since they widened: a head
dim of 256 (their widest instance), more than 64 frames (the frame-bias
table read from device memory, its gradient summed in 64-frame tiles) and
more than 8 args (the mm kernels launched in groups of args), on the CPU
against the JAX package.

  * the flash and mm attention's gradients (their plain backward versions,
    through the ``torch.autograd.Function``s) at dh 256 and at F = 80
    against ``jax.vjp`` of the JAX package's Pallas kernels in interpret
    mode, in both backward modes, with tests/test_torch_port_grads.py's
    tolerances (flash atol 5e-5 / rtol 1e-3, mm atol 1e-4 / rtol 1e-3);
  * the mm wrapper's group split (``arg_groups``, ``fwd_by_groups``,
    ``bwd_by_groups``, ``sum_arg_groups``) on the plain versions at A = 9
    and 10: against one whole-A call (forward 1e-6 relative: the same
    arithmetic arg by arg; gradients atol 1e-5 / rtol 1e-4: dq, dk, dv and
    dfb are summed group by group instead of over all args at once), and
    against the JAX package's kernel at A = 10 (the mm tolerances);
  * a small VOGNet (narrow widths, 1 head of dim 256, ``temp`` over 4
    videos of 20 frames: 80 frames, A = 10) through the JAX model and the
    port from the same params (``params_from_jax``): the forward logits
    (2e-4 x max(1, max|ref|)) and one train step's loss, grad norm (1e-4
    relative) and every gradient (1e-4 x max(1, max|g|)), the bounds of
    tests/test_torch_port_p100.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _cfg, _glove, _random_batch
from tests.test_torch_port_grads import _attn_inputs, _grads, _jax_grads
from tests.test_torch_port_model import close, port_cfg
from tests.test_torch_port_train import _adam_mu
from vog_tpu.config import post_proc_config as jpost_proc_config
from vog_tpu.kernels.attention import flash_attention as jflash
from vog_tpu.kernels.mm_attention import mm_shared_qk_attention as jmm
from vog_tpu.sampling import assemble_batch as jassemble
from vog_tpu.train import state as jstate
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.kernels import attention, mm_attention
from vog_tpu_torch.kernels.attention import flash_attention
from vog_tpu_torch.kernels.mm_attention import (
    arg_groups, bwd_by_groups, fwd_by_groups, mm_attention_bwd_plain, mm_attention_plain,
    mm_shared_qk_attention, sum_arg_groups,
)
from vog_tpu_torch.model.grounding import check_kernel_shapes, get_model
from vog_tpu_torch.sampling import assemble_batch
from vog_tpu_torch.sampling.conc import view_dims
from vog_tpu_torch.train import TrainState, make_train_step


# --------------------------------------------------------------------------
# the kernels' gradients at dh 256 and F = 80
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["recompute", "emit"])
@pytest.mark.parametrize("shape", [(1, 2, 40, 256, 10), (1, 2, 160, 24, 80)])
def test_flash_grads_match_jax_wide(mode, shape):
    B, H, T, dh, F = shape
    rng, q, k, v, mask, fb, fid = _attn_inputs(4, B, H, T, dh, F)
    cot = rng.normal(size=(B, H, T, dh)).astype(np.float32)
    diff = (0, 1, 2, 4)
    got = _grads(lambda *a: flash_attention(*a, bwd_mode=mode), (q, k, v, mask, fb, fid), diff, cot)
    ref = _jax_grads(lambda *a: jflash(*a, interpret=True, bwd_mode=mode), (q, k, v, mask, fb, fid), diff, cot)
    for name, a, b in zip(("dq", "dk", "dv", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-3, err_msg=name)


def _mm_args(seed, B, H, A, T, dh, F):
    rng, qm, km, vm, mask, fb, fid = _attn_inputs(seed, B, H, T, dh, F)
    cn = rng.uniform(-3.0, 0.0, (B, H, A, T)).astype(np.float32)
    return rng, ((qm / np.sqrt(dh)).astype(np.float32), km, vm, cn, mask, fb, fid)


@pytest.mark.parametrize("mode", ["emit", "recompute"])
@pytest.mark.parametrize("shape", [(1, 2, 3, 40, 256, 10), (1, 2, 3, 160, 24, 80)])
def test_mm_grads_match_jax_wide(mode, shape):
    B, H, A, T, dh, F = shape
    rng, args = _mm_args(5, B, H, A, T, dh, F)
    cot = rng.normal(size=(B, H, A, T, dh)).astype(np.float32)
    diff = (0, 1, 2, 3, 5)
    got = _grads(lambda *a: mm_shared_qk_attention(*a, bwd_mode=mode), args, diff, cot)
    ref = _jax_grads(lambda *a: jmm(*a, interpret=True, bwd_mode=mode), args, diff, cot)
    for name, a, b in zip(("dq", "dk", "dv", "dcn", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3, err_msg=name)


# --------------------------------------------------------------------------
# more args than a launch takes: the group split and the groups' sum
# --------------------------------------------------------------------------
def test_arg_groups():
    assert arg_groups(5) == [(0, 5)]
    assert arg_groups(8) == [(0, 8)]
    assert arg_groups(9) == [(0, 5), (5, 9)]
    assert arg_groups(10) == [(0, 5), (5, 10)]
    for A in range(1, 40):
        groups = arg_groups(A)
        sizes = [a1 - a0 for a0, a1 in groups]
        assert groups[0][0] == 0 and groups[-1][1] == A
        assert all(groups[i][1] == groups[i + 1][0] for i in range(len(groups) - 1))
        assert len(groups) == -(-A // mm_attention.KERNEL_ARGS) and max(sizes) <= mm_attention.KERNEL_ARGS
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("A", [9, 10])
def test_groups_match_one_whole_call(A):
    """fwd_by_groups / bwd_by_groups over the plain versions against one
    whole-A call of each."""
    rng, args = _mm_args(6, 2, 2, A, 37, 16, 7)
    targs = _t(*args)
    whole = mm_attention_plain(*targs)
    grouped = fwd_by_groups(mm_attention_plain, *targs)
    for a, b in zip(grouped, whole):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    g = torch.from_numpy(rng.normal(size=(2, 2, A, 37, 16)).astype(np.float32))
    whole_g = mm_attention_bwd_plain(*targs, *whole, g)
    calls = []

    def bwd(*a):
        calls.append(a[3].shape[2])  # the group's args
        return mm_attention_bwd_plain(*a)

    got = bwd_by_groups(bwd, *targs, *whole, g)
    assert calls == [a1 - a0 for a0, a1 in arg_groups(A)]
    for name, a, b in zip(("dq", "dk", "dv", "dcn", "dfb"), got, whole_g):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_sum_arg_groups_order():
    """dq, dk, dv and dfb are summed group by group in order, dcn
    concatenated over A."""
    parts = []
    for v, n in ((1.0, 2), (1e8, 3), (-1e8, 1)):
        shared = [torch.full((1, 1, 4, 2), v) for _ in range(4)]
        parts.append((*shared[:3], torch.full((1, 1, n, 2), v), shared[3]))
    dq, dk, dv, dcn, dfb = sum_arg_groups(parts)
    for x in (dq, dk, dv, dfb):  # ((1 + 1e8) - 1e8) = 0 in fp32, not 1
        assert x.shape == (1, 1, 4, 2) and not x.any()
    assert dcn.shape == (1, 1, 6, 2)
    assert dcn[0, 0, :, 0].tolist() == [1.0, 1.0, 1e8, 1e8, 1e8, -1e8]


def test_groups_match_jax_at_ten_args():
    """The grouped plain versions at A = 10 against the JAX package's
    kernel in interpret mode (one call over all ten args), forward and
    every gradient."""
    rng, args = _mm_args(7, 1, 2, 10, 40, 16, 10)
    targs = _t(*args)
    out = fwd_by_groups(mm_attention_plain, *targs)
    ref = jmm(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
    cot = rng.normal(size=(1, 2, 10, 40, 16)).astype(np.float32)
    got = bwd_by_groups(mm_attention_bwd_plain, *targs, *out, torch.from_numpy(cot))
    diff = (0, 1, 2, 3, 5)
    jref = _jax_grads(lambda *a: jmm(*a, interpret=True), args, diff, cot)
    for name, a, b in zip(("dq", "dk", "dv", "dcn", "dfb"), (got[i] for i in (0, 1, 2, 3, 4)), jref):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-3, err_msg=name)


# --------------------------------------------------------------------------
# a small VOGNet at dh 256, 80 frames and 10 args
# --------------------------------------------------------------------------
def _wide_cfg():
    """Narrow widths but one head of dim 256, ``temp`` over 4 videos of 20
    frames (80 frames, 2 proposals a frame: T = 160), 10 args."""
    cfg = _cfg(tiny=True)
    cfg.mdl.vis_dim, cfg.mdl.n_heads = 256, 1
    cfg.ds.conc_type, cfg.ds.num_frms, cfg.ds.num_props_gt5 = "temp", 20, 2
    cfg.ds.max_srl_args = 10
    cfg.mdl.decomposed_mm = True
    cfg.mdl.dropout = 0.0
    return jpost_proc_config(cfg)


def _wide_batch(cfg, B, seed):
    batch = _random_batch(cfg, B, seed=seed)
    batch["srl_arg_mask"][0, 7:] = 0.0  # padded args
    return batch


def test_wide_shapes_pass_the_card_check():
    cfg = port_cfg(_wide_cfg())
    _, n_frames, _ = view_dims(cfg.ds.conc_type, cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm)
    assert n_frames == 80 and cfg.mdl.vis_dim // cfg.mdl.n_heads == 2 * attention.HEAD_DIMS[-1] == 256
    assert attention.head_dim_instance(256) == (128, 2)  # past the widest instance: a cluster of two blocks
    check_kernel_shapes(cfg)


def test_wide_vognet_logits_match_flax():
    cfg = _wide_cfg()
    pcfg = port_cfg(cfg)
    B = 2
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _wide_batch(cfg, B, seed=3)
    ref = np.asarray(state.apply_fn(
        {"params": state.params},
        jassemble({k: jnp.asarray(v) for k, v in batch.items()}, cfg.ds.conc_type),
        deterministic=True,
    ))
    model = get_model(pcfg, 400, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params), pcfg), strict=True)
    with torch.no_grad():
        got = model(assemble_batch({k: torch.from_numpy(v) for k, v in batch.items()}, pcfg.ds.conc_type))
    assert tuple(got.shape) == (B, 10, 160)
    close(got.numpy(), ref)


def test_wide_vognet_train_step_matches_jax():
    cfg = _wide_cfg()
    t = cfg.train
    t.lr, t.lr_schedule, t.grad_clip, t.skip_nonfinite, t.pos_weight = 1e-3, "const", 1e6, 3, 20.0
    pcfg = port_cfg(cfg)
    B = 2
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _wide_batch(cfg, B, seed=1)
    new_state, jaux = jax.jit(jstate.make_train_step(cfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    jgrads = params_from_jax(jax.tree.map(lambda m: np.asarray(m) / 0.1, _adam_mu(new_state.opt_state)), pcfg)

    model = get_model(pcfg, 400, device="cpu", train=True)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params), pcfg), strict=True)
    ts, aux = make_train_step(pcfg)(TrainState.create(pcfg, model),
                                    {k: torch.from_numpy(v) for k, v in batch.items()}, seed=0)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-4)
    assert int(aux["guard_notfinite"]) == int(jaux["guard_notfinite"]) == 0
    params = dict(model.named_parameters())
    assert set(params) == set(jgrads)
    for k, p in params.items():
        ref = jgrads[k].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * max(1.0, np.abs(ref).max()), (k, err)
