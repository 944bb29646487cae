"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX package's Pallas kernels run in interpret mode, forward
only (the gradients: tests/test_torch_port_grads.py, and at the wide
shapes tests/test_torch_port_wide.py).  The same numpy inputs go to both.
The attention cases include a head dim of 256 (the card's widest instance)
and 80 frames (past the 64 whose bias table a block keeps in shared
memory).

Tolerances: the gather is a copy and must be bitwise equal in every
dtype.  The fp32 attention and head functions sum in another order than
the Pallas kernels (blocked, online softmax) so they are held to
max |err| <= 2e-5 + 1e-4 |ref| (attention) and 2e-4 absolute (head), the
bounds the JAX package's own tests hold its kernels to against XLA.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vog_tpu.kernels import attention as jattn
from vog_tpu.kernels import mm_attention as jmm
from vog_tpu.kernels.gather import gather_rows as jgather
from vog_tpu.kernels.grounding_head import fused_grounding_head as jhead
from vog_tpu_torch.kernels import _build
from vog_tpu_torch.kernels.attention import flash_attention_fwd
from vog_tpu_torch.kernels.gather import gather_rows
from vog_tpu_torch.kernels.grounding_head import fused_grounding_head
from vog_tpu_torch.kernels.mm_attention import mm_attention_fwd


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# gather
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gather_bitwise_vs_pallas(dtype):
    rng = np.random.default_rng(0)
    N = 37
    K = {"float32": 8, "bfloat16": 16, "int8": 32}[dtype]  # Pallas sublane tile
    if dtype == "int8":
        host = rng.integers(-127, 128, (N, K, 128)).astype(np.int8)
        jt, tt = jnp.asarray(host), torch.from_numpy(host)
    else:
        host = rng.normal(size=(N, K, 128)).astype(np.float32)
        jt = jnp.asarray(host).astype(dtype)
        tt = torch.from_numpy(host).to(getattr(torch, dtype))
    # duplicate and out-of-range rows (both clamp to [0, N-1])
    rows = np.array([[0, 5, 5, 36], [1, -3, 99, 2]], np.int32)
    want = np.asarray(jgather(jt, jnp.asarray(rows), interpret=True).astype(jnp.float32))
    got = gather_rows(tt, torch.from_numpy(rows))
    assert got.dtype == tt.dtype and tuple(got.shape) == (2, 4, K, 128)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gather_flat_rows_any_width():
    """The port's gather takes 2-D tables of any row width (no fallback)."""
    rng = np.random.default_rng(1)
    host = rng.normal(size=(9, 200)).astype(np.float32)
    rows = np.array([3, 0, 8, 8], np.int32)
    np.testing.assert_array_equal(gather_rows(_t(host), _t(rows)).numpy(), host[rows])


def test_cpu_wrappers_do_not_count_launches():
    _build.reset_counts()
    gather_rows(torch.zeros(3, 4), torch.zeros(2, dtype=torch.int32))
    assert _build.launches == {}


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
def _attn_inputs(seed, B, H, T, dh, F, mixed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, dh)).astype(np.float32) for _ in range(3))
    mask = (rng.uniform(size=(B, T)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    fb = rng.normal(scale=0.5, size=(H, F, F)).astype(np.float32)
    if mixed:  # frames change inside every tile
        fids = rng.integers(0, F, T).astype(np.int32)
        fids.sort()
    else:
        fids = (np.arange(T) // max(T // F, 1)).clip(0, F - 1).astype(np.int32)
    return q, k, v, mask, fb, fids


@pytest.mark.parametrize(
    "shape,with_bias,mixed",
    [((2, 2, 40, 16, 10), False, False), ((2, 2, 40, 16, 10), True, False),
     ((1, 2, 150, 8, 10), True, True),
     # the kernels' widest head-dim instance, and more frames than the
     # (F, F) table a block holds in shared memory (80 > 64)
     ((1, 2, 40, 256, 10), True, False), ((1, 2, 160, 24, 80), True, True)],
)
def test_flash_plain_vs_pallas(shape, with_bias, mixed):
    B, H, T, dh, F = shape
    q, k, v, mask, fb, fids = _attn_inputs(0, B, H, T, dh, F, mixed)
    jfb = jnp.asarray(fb) if with_bias else None
    jfid = jnp.asarray(fids) if with_bias else None
    o_ref, res = jattn._flash_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jfb, jfid, True,
    )
    Tp = res[-1][4]
    lse_ref = np.asarray(res[7]).reshape(B, H, Tp)[:, :, :T]
    o, lse = flash_attention_fwd(
        _t(q), _t(k), _t(v), _t(mask),
        _t(fb) if with_bias else None, _t(fids) if with_bias else None,
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=2e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# mm shared-QK attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,mixed", [((1, 2, 3, 40, 16, 10), False), ((1, 2, 5, 150, 8, 10), True),
                                         ((1, 2, 3, 40, 256, 10), False), ((1, 2, 3, 160, 24, 80), True)])
def test_mm_plain_vs_pallas(shape, mixed):
    B, H, A, T, dh, F = shape
    q, k, v, mask, fb, fids = _attn_inputs(1, B, H, T, dh, F, mixed)
    cn = np.random.default_rng(2).uniform(-3.0, 0.0, (B, H, A, T)).astype(np.float32)
    j = [jnp.asarray(x) for x in (q, k, v, cn, mask, fb, fids)]
    qf, kf, vf, ct, mk, fbc, fid, dims = jmm._prep(*j)
    out_ref, m_ref, den_ref = jmm._fwd(qf, kf, vf, ct, mk, fbc, fid, dims, True)
    Tp = dims[5]
    out_ref = np.asarray(out_ref).reshape(B, H, A, Tp, -1)[:, :, :, :T, :dh]
    stat = lambda x: np.asarray(x).reshape(B, H, Tp, A).transpose(0, 1, 3, 2)[..., :T]
    out, m, den = mm_attention_fwd(*(_t(x) for x in (q, k, v, cn, mask, fb, fids)))
    np.testing.assert_allclose(out.numpy(), out_ref, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(m.numpy(), stat(m_ref), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(den.numpy(), stat(den_ref), atol=2e-5, rtol=1e-4)
    # and the public entry point of the JAX package
    pub = jmm.mm_shared_qk_attention(*j, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pub), atol=3e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# fused grounding head
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,T,A,D", [(2, 70, 3, 128), (1, 40, 5, 256)])
def test_head_plain_vs_pallas(B, T, A, D):
    rng = np.random.default_rng(3)
    Dh = D // 2
    r = lambda scale, *s: rng.normal(size=s, scale=scale).astype(np.float32)
    args = [r(0.5, B, T, D), r(0.5, B, A, D), r(0.5, B, T, D), r(0.5, B, A, D),
            r(0.5 / np.sqrt(D), D, D), r(0.5 / np.sqrt(D), D, Dh), r(0.5, Dh),
            r(0.5 / np.sqrt(Dh), Dh), np.float32(0.3)]
    ref = np.asarray(jhead(*(jnp.asarray(a) for a in args), interpret=True))
    got = fused_grounding_head(*(_t(a) for a in args))
    assert tuple(got.shape) == (B, A, T)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def _head_fwd_emulated(args, stream, grid):
    """The card forward's arithmetic in numpy (fp64): a persistent grid of
    ``grid`` blocks walking the items (64 flattened (b, t) rows, one arg),
    each reading the weight stream as head_fwd does (A fragment slot u of
    k half e <- column 2u + e of the k-step).  -> (logits, times each
    (b, a, t) was written)."""
    vis, arg, wv, wl, _, _, b1, w2, b2 = (np.asarray(a, np.float64) for a in args)
    B, T, D = vis.shape
    A, Dh = arg.shape[1], b1.shape[0]
    dp = -(-D // 64) * 64
    per = dp // 8 * 512 + 8 * 2048
    halves = np.asarray(stream, np.float64).reshape(-1, 2, 2048)  # a stage's big, then small parts
    s = halves.sum(1).reshape(dp // 64, per)
    pad = lambda x, n: np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])  # noqa: E731
    rows = np.arange(B * T)
    out, hits = np.zeros((B, A, T)), np.zeros((B, A, T), np.int64)
    nitems = -(-B * T // 64) * A
    for blk in range(grid):
        for item in range(blk, nitems, grid):
            n = rows[item // A * 64:(item // A + 1) * 64]
            a = item % A
            bb, tt = n // T, n % T
            x = pad(vis[bb, tt] * arg[bb, a], dp)
            acc2 = np.zeros((len(n), 256))
            for c in range(dp // 64):
                acc1 = np.zeros((len(n), 64))
                for st in range(dp // 8):
                    step = s[c, st * 512:(st + 1) * 512].reshape(2, 64, 4)  # [e][n][u]
                    for u in range(4):
                        for e in range(2):
                            acc1 += x[:, 8 * st + 2 * u + e, None] * step[e, :, u]
                h = np.maximum(acc1 + pad(wv[bb, tt], dp)[:, 64 * c:64 * c + 64]
                               + pad(wl[bb, a], dp)[:, 64 * c:64 * c + 64], 0)
                for j in range(8):
                    step = s[c, dp // 8 * 512 + j * 2048:dp // 8 * 512 + (j + 1) * 2048].reshape(2, 256, 4)
                    for u in range(4):
                        for e in range(2):
                            acc2 += h[:, 8 * j + 2 * u + e, None] * step[e, :, u]
            out[bb, a, tt] = np.maximum(acc2 + pad(b1, 256), 0) @ pad(w2, 256) + b2
            hits[bb, a, tt] += 1
    return out, hits


@pytest.mark.parametrize("B,T,A,D,grid", [(2, 37, 3, 96, 5), (1, 130, 2, 64, 3), (3, 5, 7, 32, 132)])
def test_head_fwd_stream_and_item_walk(B, T, A, D, grid):
    """The forward's weight stream (``fwd_stream_plain``, the plain version
    of head_fwd_prep) holds Wx and W1 where head_fwd reads them: a numpy
    emulation of the kernel's fragment mapping and item walk gives the plain
    head's logits, and the walk writes every (b, a, t) exactly once."""
    from vog_tpu_torch.kernels.grounding_head import fwd_stream_floats, fwd_stream_plain, grounding_head_plain

    rng = np.random.default_rng(4)
    Dh = D // 2
    r = lambda scale, *s: rng.normal(size=s, scale=scale).astype(np.float32)  # noqa: E731
    args = [r(0.5, B, T, D), r(0.5, B, A, D), r(0.5, B, T, D), r(0.5, B, A, D),
            r(0.5 / np.sqrt(D), D, D), r(0.5 / np.sqrt(D), D, Dh), r(0.5, Dh),
            r(0.5 / np.sqrt(Dh), Dh), np.float32(0.3)]
    stream = fwd_stream_plain(_t(args[4]), _t(args[5]))
    assert stream.numel() == fwd_stream_floats(D)
    got, hits = _head_fwd_emulated(args, stream.numpy(), grid)
    assert (hits == 1).all()
    ref = grounding_head_plain(*(_t(a).double() for a in args)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-9)


def test_head_fwd_stream_layout_as_the_prep_kernel_indexes_it():
    """``fwd_stream_plain`` element by element as head_fwd_prep computes
    each output offset (csrc/grounding_head.cu), zero past D and Dh: each
    stage's big parts (TF32 toward zero) and then its small parts, which
    add up to the weight exactly."""
    from vog_tpu_torch.kernels.grounding_head import fwd_stream_plain

    D, Dh = 96, 48
    rng = np.random.default_rng(5)
    wx, w1 = rng.normal(size=(D, D)).astype(np.float32), rng.normal(size=(D, Dh)).astype(np.float32)
    got = fwd_stream_plain(_t(wx), _t(w1)).numpy()
    dp = 128
    per = dp // 8 * 512 + 8 * 2048
    want = np.zeros_like(got)
    for o in range(got.size):
        stage, part = o // 4096, (o // 2048) & 1
        c, r = divmod(stage * 2048 + o % 2048, per)
        z1 = r >= dp // 8 * 512
        step, w = divmod(r - dp // 8 * 512, 2048) if z1 else divmod(r, 512)
        halfsize = 1024 if z1 else 256
        u, n8, half, ng = w & 3, (w >> 2) & 7, w // halfsize, (w % halfsize) >> 5
        n, kk = 8 * ng + n8, 8 * step + 2 * u + half
        v = np.float32(0)
        if z1 and 64 * c + kk < D and n < Dh:
            v = w1[64 * c + kk, n]
        elif not z1 and kk < D and 64 * c + n < D:
            v = wx[kk, 64 * c + n]
        big = (np.array(v, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
        want[o] = v - big if part else big
    np.testing.assert_array_equal(got, want)
    halves = got.reshape(-1, 2, 2048)
    assert ((halves[:, 0].view(np.uint32) & 0x1FFF) == 0).all()  # TF32 big parts
