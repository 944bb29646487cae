"""Gradients of the port's kernel wrappers on CPU tensors (their plain
backward versions, through the ``torch.autograd.Function``s) against
``jax.vjp`` of the JAX package's Pallas kernels in interpret mode, and the
port's losses against ``vog_tpu.model.loss``.  The same numpy inputs and
cotangents go to both.

Tolerances are the JAX package's own for its kernels' gradients against
XLA: flash atol 5e-5 / rtol 1e-3 (tests/test_attention.py), mm atol 1e-4 /
rtol 1e-3 (tests/test_mm_attention.py), head atol 5e-4 / rtol 1e-3
(tests/test_head_kernel.py).  A batch row whose keys are all masked is
left out of the JAX comparison (the Pallas kernels average over the
padded key block there, a deliberate difference) and held against
autograd of the plain forward instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vog_tpu.kernels.attention import flash_attention as jflash
from vog_tpu.kernels.grounding_head import fused_grounding_head as jhead
from vog_tpu.kernels.mm_attention import mm_shared_qk_attention as jmm
from vog_tpu.model import compute_loss as jcompute_loss
from vog_tpu.model.loss import masked_rank_loss as jrank
from vog_tpu_torch.kernels.attention import flash_attention, flash_attention_plain
from vog_tpu_torch.kernels.grounding_head import fused_grounding_head
from vog_tpu_torch.kernels.mm_attention import mm_attention_plain, mm_shared_qk_attention
from vog_tpu_torch.model.loss import compute_loss, masked_rank_loss


def _grads(fn, args, diff, cot):
    """Gradients of sum(fn(*args) * cot) w.r.t. args[i] for i in diff."""
    xs = [torch.from_numpy(np.array(a)).requires_grad_(i in diff) if a is not None else None
          for i, a in enumerate(args)]
    out = fn(*xs)
    return [g.numpy() for g in torch.autograd.grad(out, [xs[i] for i in diff], torch.from_numpy(cot))]


def _jax_grads(fn, args, diff, cot):
    def f(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        return fn(*full)

    _, vjp = jax.vjp(f, *[jnp.asarray(args[i]) for i in diff])
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _attn_inputs(seed, B, H, T, dh, F, all_masked=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, dh)).astype(np.float32) for _ in range(3))
    mask = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    if all_masked:
        mask[B - 1] = 0.0
    fb = rng.normal(scale=0.5, size=(H, F, F)).astype(np.float32)
    fid = (np.arange(T) // max(T // F, 1)).clip(0, F - 1).astype(np.int32)
    return rng, q, k, v, mask, fb, fid


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode,bias,shape", [
    ("recompute", True, (2, 2, 50, 16, 10)),
    ("recompute", False, (2, 2, 50, 16, 10)),
    ("emit", True, (2, 2, 50, 16, 10)),
    ("recompute", True, (1, 2, 130, 8, 13)),  # two Pallas blocks
])
def test_flash_grads_match_jax(mode, bias, shape):
    B, H, T, dh, F = shape
    rng, q, k, v, mask, fb, fid = _attn_inputs(0, B, H, T, dh, F)
    if not bias:
        fb, fid = None, None
    cot = rng.normal(size=(B, H, T, dh)).astype(np.float32)
    diff = (0, 1, 2, 4) if bias else (0, 1, 2)
    got = _grads(lambda *a: flash_attention(*a, bwd_mode=mode), (q, k, v, mask, fb, fid), diff, cot)
    ref = _jax_grads(lambda *a: jflash(*a, interpret=True, bwd_mode=mode),
                     (q, k, v, mask, fb, fid), diff, cot)
    for name, a, b in zip(("dq", "dk", "dv", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("bias", [True, False])
def test_flash_grads_with_all_masked_row_match_autograd_of_plain(bias):
    rng, q, k, v, mask, fb, fid = _attn_inputs(1, 3, 2, 37, 8, 5, all_masked=True)
    if not bias:
        fb, fid = None, None
    cot = rng.normal(size=q.shape).astype(np.float32)
    diff = (0, 1, 2, 4) if bias else (0, 1, 2)
    got = _grads(flash_attention, (q, k, v, mask, fb, fid), diff, cot)
    ref = _grads(lambda *a: flash_attention_plain(*a)[0], (q, k, v, mask, fb, fid), diff, cot)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
    assert np.abs(got[2][2]).max() > 0  # dv of the all-masked row: p = 1/T


# --------------------------------------------------------------------------
# mm shared-QK attention
# --------------------------------------------------------------------------
def _mm_inputs(seed, B, H, A, T, dh, F=10, all_masked=False):
    rng, qm, km, vm, mask, fb, fid = _attn_inputs(seed, B, H, T, dh, F, all_masked)
    cn = rng.uniform(-3.0, 0.0, (B, H, A, T)).astype(np.float32)
    return rng, (qm, km, vm, cn, mask, fb, fid)


@pytest.mark.parametrize("mode,shape", [
    ("emit", (1, 2, 3, 40, 16)),
    ("recompute", (1, 2, 3, 40, 16)),
    ("emit", (2, 2, 5, 150, 8)),  # two Pallas blocks
])
def test_mm_grads_match_jax(mode, shape):
    B, H, A, T, dh = shape
    rng, args = _mm_inputs(2, B, H, A, T, dh)
    cot = rng.normal(size=(B, H, A, T, dh)).astype(np.float32)
    diff = (0, 1, 2, 3, 5)
    got = _grads(lambda *a: mm_shared_qk_attention(*a, bwd_mode=mode), args, diff, cot)
    ref = _jax_grads(lambda *a: jmm(*a, interpret=True, bwd_mode=mode), args, diff, cot)
    for name, a, b in zip(("dq", "dk", "dv", "dcn", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3, err_msg=name)


def test_mm_grads_with_all_masked_row_match_autograd_of_plain():
    rng, args = _mm_inputs(3, 3, 2, 4, 29, 8, F=5, all_masked=True)
    cot = rng.normal(size=(3, 2, 4, 29, 8)).astype(np.float32)
    diff = (0, 1, 2, 3, 5)
    got = _grads(mm_shared_qk_attention, args, diff, cot)
    ref = _grads(lambda *a: mm_attention_plain(*a)[0], args, diff, cot)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# fused grounding head
# --------------------------------------------------------------------------
def test_head_grads_match_jax():
    rng = np.random.default_rng(4)
    B, T, A, D = 2, 70, 3, 256
    Dh = D // 2
    r = lambda *s, sc=1.0: (rng.normal(size=s, scale=0.5) * sc).astype(np.float32)  # noqa: E731
    args = (r(B, T, D), r(B, A, D), r(B, T, D), r(B, A, D), r(D, D, sc=D**-0.5),
            r(D, Dh, sc=D**-0.5), r(Dh), r(Dh, sc=Dh**-0.5), np.float32(0.3))
    cot = rng.normal(size=(B, A, T)).astype(np.float32)
    diff = tuple(range(9))
    got = _grads(fused_grounding_head, args, diff, cot)
    ref = _jax_grads(lambda *a: jhead(*a, interpret=True), args, diff, cot)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, np.reshape(b, a.shape), atol=5e-4, rtol=1e-3, err_msg=str(i))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def _loss_clip(seed, B=3, A=4, T=30):
    rng = np.random.default_rng(seed)
    clip = {
        "targets": (rng.uniform(size=(B, A, T)) > 0.9).astype(np.float32),
        "mask": (rng.uniform(size=(B, T)) > 0.2).astype(np.float32),
        "srl_arg_mask": (rng.uniform(size=(B, A)) > 0.3).astype(np.float32),
        "batch_mask": (np.arange(B) < B - 1).astype(np.float32),
    }
    return rng.normal(scale=3.0, size=(B, A, T)).astype(np.float32), clip


@pytest.mark.parametrize("loss_type,pos_weight", [("bce", 1.0), ("bce", 5.0), ("rank", 5.0)])
def test_compute_loss_matches_jax(loss_type, pos_weight):
    logits, clip = _loss_clip(5)
    ref = jcompute_loss(jnp.asarray(logits), {k: jnp.asarray(v) for k, v in clip.items()},
                        pos_weight, loss_type, 0.5)[0]
    x = torch.from_numpy(logits).requires_grad_()
    got = compute_loss(x, {k: torch.from_numpy(v) for k, v in clip.items()}, pos_weight,
                       loss_type, 0.5)[0]
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    jg = jax.grad(lambda z: jcompute_loss(z, {k: jnp.asarray(v) for k, v in clip.items()},
                                          pos_weight, loss_type, 0.5)[0])(jnp.asarray(logits))
    (tg,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7, rtol=1e-4)


def test_rank_loss_regroups_sep_videos_like_jax():
    logits, clip = _loss_clip(6, B=8)  # 2 groups of num_cmp=4 videos
    mask = clip["mask"][:, None, :] * clip["srl_arg_mask"][:, :, None]
    ref = jrank(jnp.asarray(logits), jnp.asarray(clip["targets"]), jnp.asarray(mask), num_cmp=4)
    got = masked_rank_loss(torch.from_numpy(logits), torch.from_numpy(clip["targets"]),
                           torch.from_numpy(mask), num_cmp=4)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
