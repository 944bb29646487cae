"""The widths the card's kernels take since their wide paths: the fused
head at any ``mdl.vis_dim`` (past 512, not a multiple of 32, a hidden
width past 256) and attention head dims past 256, on the CPU against the
JAX package.

  * the head's padding (``pad_head``, the plain forward and backward on
    the padded operands, ``unpad_grads``: what the CUDA wrapper runs around
    its kernels), values and all 9 gradients, against the flax head's XLA
    path at D 300 (its params' gradients and the inputs', through the
    stems), and against the JAX package's head kernel in interpret mode at
    a lane-aligned D 256 (values atol 1e-4 / rtol 1e-4; gradients atol
    5e-4 / rtol 1e-3, the JAX package's own head-gradient tolerance,
    tests/test_head_kernel.py);
  * the forward's weight stream at D 640 / Dh 320 (two hidden groups):
    ``fwd_stream_plain`` element by element as head_fwd_prep indexes it,
    at both precisions (exact), and an fp64 numpy emulation of head_fwd's
    wide path (the stream read stage by stage in the kernel's order: z0 by
    K slices of the cross tile, then z1 a group of 256 columns at a time)
    against the plain head (1e-9);
  * the plain flash and mm attention (the CPU path of the wrappers, whose
    CUDA kernels take dh > 256 on their wide path) at dh 320 and 512
    against the JAX package's Pallas kernels in interpret mode, forward and
    every gradient in both backward modes, with
    tests/test_torch_port_grads.py's tolerances (values atol 3e-5 / rtol
    1e-4; gradients flash atol 5e-5 / rtol 1e-3, mm atol 1e-4 / rtol
    1e-3);
  * a small VOGNet at vis 320 with one head (dh 320, the head's D 320)
    through the JAX model and the port from the same params: the logits
    (2e-4 x max(1, max|ref|)) and one train step's loss, grad norm (1e-4
    relative) and every gradient (1e-4 x max(1, max|g|)), the bounds of
    tests/test_torch_port_wide.py.
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
from vog_tpu.kernels.grounding_head import fused_grounding_head as jhead
from vog_tpu.kernels.mm_attention import mm_shared_qk_attention as jmm
from vog_tpu.model.grounding import GroundingHead as JGroundingHead
from vog_tpu.train import state as jstate
from vog_tpu.sampling import assemble_batch as jassemble
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.kernels import attention, grounding_head, mm_attention
from vog_tpu_torch.kernels.attention import flash_attention, flash_attention_plain
from vog_tpu_torch.kernels.grounding_head import (
    fwd_stream_floats, fwd_stream_plain, grounding_head_bwd_plain, grounding_head_plain, pad_head,
    round_tf32, unpad_grads, w_chunks,
)
from vog_tpu_torch.kernels.mm_attention import mm_attention_plain, mm_shared_qk_attention
from vog_tpu_torch.model.grounding import check_kernel_shapes, get_model
from vog_tpu_torch.sampling import assemble_batch
from vog_tpu_torch.train import TrainState, make_train_step

HEAD_NAMES = ("dvis", "darg", "dwv", "dwl", "dwx", "dw1", "db1", "dw2", "db2")


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# --------------------------------------------------------------------------
# the head: padding to the widths the kernels take
# --------------------------------------------------------------------------
def _padded_head(args, g):
    """The CUDA wrapper's arithmetic around its kernels, with the plain
    versions in their place: the operands padded, the forward and the 9
    gradients on them, the gradients sliced back -> (logits, grads)."""
    vis, arg, wv, wl, wx, w1, b1, w2, b2 = _t(*args)
    D, Dh = wx.shape[0], w1.shape[1]
    padded = pad_head(vis, arg, wv, wl, wx, w1, b1, w2)
    out = grounding_head_plain(*padded, b2)
    grads = unpad_grads(grounding_head_bwd_plain(*padded, b2, torch.from_numpy(g)), D, Dh)
    return out.numpy(), [x.numpy() for x in grads]


def test_pad_head_widths():
    rng = np.random.default_rng(0)
    for D, Dh in ((300, 150), (2080, 1040), (512, 256), (40, 20)):
        ts = _t(*(rng.normal(size=s).astype(np.float32) for s in
                  ((2, 3, D), (2, 4, D), (2, 3, D), (2, 4, D), (D, D), (D, Dh), (Dh,), (Dh,))))
        padded = pad_head(*ts)
        Dp, Dhp = -(-D // 32) * 32, -(-Dh // 16) * 16
        assert padded[4].shape == (Dp, Dp) and padded[5].shape == (Dp, Dhp) and padded[6].shape == (Dhp,)
        assert padded[0].shape == (2, 3, Dp) and padded[3].shape == (2, 4, Dp)
        if (Dp, Dhp) == (D, Dh):
            assert all(p is t for p, t in zip(padded, ts))  # the kernels' widths: no copy
        for p, t in zip(padded, ts):  # the operand in its corner, zeros elsewhere
            corner = tuple(slice(0, n) for n in t.shape)
            assert torch.equal(p[corner], t) and int(p.count_nonzero()) == int(t.count_nonzero())


def test_head_padding_matches_the_flax_head_at_d300():
    """D 300 (padded to 320), Dh 150 (to 160): the padded plain head's
    logits and 9 gradients against the flax GroundingHead's XLA path (the
    JAX package's head off its kernel's gate), its gradients of the
    inputs and params mapped through the stems wv = vis Wv + bv, wl = arg
    Wl."""
    cfg = _cfg(tiny=True)
    cfg.mdl.vis_dim = D = 300
    cfg = jpost_proc_config(cfg)
    Dh, B, T, A = D // 2, 2, 23, 3
    rng = np.random.default_rng(9)
    r = lambda scale, *s: rng.normal(size=s, scale=scale).astype(np.float32)  # noqa: E731
    vis, arg = r(0.5, B, T, D), r(0.5, B, A, D)
    params = {"fuse_vis_kernel": r(D ** -0.5, D, D), "fuse_vis_bias": r(0.1, D),
              "fuse_lang_kernel": r(D ** -0.5, D, D), "fuse_cross_kernel": r(D ** -0.5, D, D),
              "head1_kernel": r(D ** -0.5, D, Dh), "head1_bias": r(0.1, Dh),
              "head2_kernel": r(Dh ** -0.5, Dh, 1), "head2_bias": r(0.1, 1)}
    head = JGroundingHead(cfg)
    ref, vjp = jax.vjp(lambda v, a, p: head.apply({"params": p}, v, a), jnp.asarray(vis), jnp.asarray(arg),
                       jax.tree.map(jnp.asarray, params))
    cot = rng.normal(size=(B, A, T)).astype(np.float32)
    jv, ja, jp = vjp(jnp.asarray(cot))

    wv = vis @ params["fuse_vis_kernel"] + params["fuse_vis_bias"]
    wl = arg @ params["fuse_lang_kernel"]
    args = (vis, arg, wv, wl, params["fuse_cross_kernel"], params["head1_kernel"], params["head1_bias"],
            params["head2_kernel"][:, 0], params["head2_bias"][0])
    out, (dvis, darg, dwv, dwl, dwx, dw1, db1, dw2, db2) = _padded_head(args, cot)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=1e-4)
    tol = dict(atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(dvis + dwv @ params["fuse_vis_kernel"].T, np.asarray(jv), **tol, err_msg="vis")
    np.testing.assert_allclose(darg + dwl @ params["fuse_lang_kernel"].T, np.asarray(ja), **tol, err_msg="arg")
    mine = {"fuse_vis_kernel": np.einsum("btd,bte->de", vis, dwv), "fuse_vis_bias": dwv.sum((0, 1)),
            "fuse_lang_kernel": np.einsum("bad,bae->de", arg, dwl), "fuse_cross_kernel": dwx,
            "head1_kernel": dw1, "head1_bias": db1, "head2_kernel": dw2[:, None], "head2_bias": np.reshape(db2, (1,))}
    for k, v in mine.items():
        np.testing.assert_allclose(v, np.asarray(jp[k]), **tol, err_msg=k)


def test_head_padding_matches_the_jax_kernel_at_d256():
    """At a lane-aligned D 256 (the JAX kernel's gate; the padding takes
    the operands as they are): values and 9 gradients against the JAX
    package's head kernel in interpret mode."""
    rng = np.random.default_rng(7)
    B, T, A, D = 1, 40, 3, 256
    Dh = D // 2
    r = lambda *s, sc=1.0: (rng.normal(size=s, scale=0.5) * sc).astype(np.float32)  # noqa: E731
    args = (r(B, T, D), r(B, A, D), r(B, T, D), r(B, A, D), r(D, D, sc=D**-0.5),
            r(D, Dh, sc=D**-0.5), r(Dh), r(Dh, sc=Dh**-0.5), np.float32(0.3))
    cot = rng.normal(size=(B, A, T)).astype(np.float32)
    out, grads = _padded_head(args, cot)
    ref = jhead(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=1e-4)
    jref = _jax_grads(lambda *a: jhead(*a, interpret=True), args, tuple(range(9)), cot)
    for name, a, b in zip(HEAD_NAMES, grads, jref):
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape), atol=5e-4, rtol=1e-3, err_msg=name)


def test_w_chunks_keep_d512_and_bound_the_partials():
    assert w_chunks(512, 256) == grounding_head.W_CHUNKS == 11  # GT5, P100: as before
    assert w_chunks(128, 64) == w_chunks(256, 128) == 11
    assert w_chunks(1024, 512) == 2 and w_chunks(2080, 1040) == w_chunks(4096, 2048) == 1


# --------------------------------------------------------------------------
# the head: the forward's weight stream at two hidden groups
# --------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_head_fwd_stream_layout_two_hidden_groups(precision):
    """``fwd_stream_plain`` at D 640 / Dh 320 element by element as
    head_fwd_prep computes each output offset (csrc/grounding_head.cu):
    per chunk its z0 k-steps, then 8 z1 k-steps for each hidden group of
    256 columns, zero past D and Dh; "highest": each stage's big parts,
    then its small parts; "default": each weight rounded to TF32."""
    D, Dh = 640, 320
    rng = np.random.default_rng(5)
    wx, w1 = rng.normal(size=(D, D)).astype(np.float32), rng.normal(size=(D, Dh)).astype(np.float32)
    got = fwd_stream_plain(*_t(wx, w1), precision).numpy()
    assert got.size == fwd_stream_floats(D, precision, Dh)
    dp, ng, parts = 640, 2, 2 if precision == "highest" else 1
    z0len = dp // 8 * 512
    per = z0len + 8 * ng * 2048
    o = np.arange(got.size)
    stage, part = o // (parts * 2048), (o // 2048) & 1 if parts == 2 else np.zeros_like(o)
    raw = stage * 2048 + o % 2048
    c, r = raw // per, raw % per
    z1 = r >= z0len
    step = np.where(z1, (r - z0len) // 2048, r // 512)
    w = np.where(z1, (r - z0len) % 2048, r % 512)
    halfsize = np.where(z1, 1024, 256)
    u, n8, half, ngp = w & 3, (w >> 2) & 7, w // halfsize, (w % halfsize) >> 5
    n = 8 * ngp + n8
    kk = 8 * np.where(z1, step % 8, step) + 2 * u + half
    k1, col1 = 64 * c + kk, 256 * (step // 8) + n  # z1: W1 row, column
    col0 = 64 * c + n  # z0: Wx row kk, column
    ok1 = z1 & (k1 < D) & (col1 < Dh)
    ok0 = ~z1 & (kk < D) & (col0 < D)
    v = np.zeros(got.size, np.float32)
    v[ok1] = w1[k1[ok1], col1[ok1]]
    v[ok0] = wx[kk[ok0], col0[ok0]]
    if precision == "highest":
        big = (v.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
        want = np.where(part == 1, v - big, big)
    else:
        want = round_tf32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (v[ok1].size, v[ok0].size) == (parts * D * Dh, parts * D * D)  # every weight once a part


def _head_fwd_wide_emulated(args, stream):
    """head_fwd's wide path in numpy (fp64), item by item, reading the
    stream stage by stage in the kernel's order (``stream_stage``): (1) z0
    by K slices of 512 columns of the cross tile (each chunk's stages of
    the slice, the chunk's sums kept between slices), (2) for each group of
    256 z1 columns each chunk's 8 z1 stages of the group, the logit summed
    over the groups.  -> logits (B, A, T)."""
    vis, arg, wv, wl, _, _, b1, w2, b2 = (np.asarray(a, np.float64) for a in args)
    B, T, D = vis.shape
    A, Dh = arg.shape[1], b1.shape[0]
    dp = -(-D // 64) * 64
    nch, p1, nhg, nks, S = dp // 64, dp // 32, -(-Dh // 256), -(-dp // 512), 16
    stages = np.asarray(stream, np.float64).reshape(-1, 2, 2048).sum(1)  # big + small
    pad = lambda x, n: np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])  # noqa: E731
    L = p1 + 8 * nhg  # a chunk's stages in the stream

    def stream_stage(u):
        if u < nch * p1:
            ks = min(u // (nch * S), nks - 1)
            v = u - nch * S * ks
            sl = min(S, p1 - S * ks)
            return v // sl * L + S * ks + v % sl
        hg, w = divmod(u - nch * p1, nch * 8)
        return w // 8 * L + p1 + 8 * hg + w % 8

    out = np.zeros((B, A, T))
    rows = np.arange(B * T)
    for item in range(-(-B * T // 64) * A):
        n = rows[item // A * 64:(item // A + 1) * 64]
        a = item % A
        bb, tt = n // T, n % T
        full = pad(vis[bb, tt] * arg[bb, a], nks * 512)
        z0 = np.zeros((len(n), dp))
        u = 0
        for ks in range(nks):
            cross = full[:, 512 * ks:512 * ks + 512]  # the K slice the tile holds
            for c in range(nch):
                for s in range(min(S, p1 - S * ks)):
                    st = stages[stream_stage(u)].reshape(4, 2, 64, 4)  # [k-step][e][n][u]
                    u += 1
                    for kk in range(4):
                        wk = st[kk].transpose(2, 0, 1).reshape(8, 64)  # row 2u + e
                        z0[:, 64 * c:64 * c + 64] += cross[:, 32 * s + 8 * kk:32 * s + 8 * kk + 8] @ wk
        h = np.maximum(z0 + pad(wv[bb, tt], dp) + pad(wl[bb, a], dp), 0)
        logit = np.zeros(len(n))
        for hg in range(nhg):
            acc2 = np.zeros((len(n), 256))
            for c in range(nch):
                for j in range(8):
                    st = stages[stream_stage(u)].reshape(2, 256, 4)
                    u += 1
                    acc2 += h[:, 64 * c + 8 * j:64 * c + 8 * j + 8] @ st.transpose(2, 0, 1).reshape(8, 256)
            cols = slice(256 * hg, 256 * hg + 256)
            logit += np.maximum(acc2 + pad(b1, 256 * nhg)[cols], 0) @ pad(w2, 256 * nhg)[cols]
        assert u == nch * p1 + nhg * nch * 8  # every stage of the item read once
        out[bb, a, tt] = logit + b2
    return out


def test_head_fwd_wide_walk_reads_the_stream_in_order():
    """At D 640 / Dh 320 (two K slices of the cross tile, two hidden
    groups) the emulated wide walk over ``fwd_stream_plain`` gives the
    plain head's logits."""
    rng = np.random.default_rng(11)
    B, T, A, D = 1, 70, 2, 640
    Dh = D // 2
    r = lambda scale, *s: rng.normal(size=s, scale=scale).astype(np.float32)  # noqa: E731
    args = [r(0.5, B, T, D), r(0.5, B, A, D), r(0.5, B, T, D), r(0.5, B, A, D),
            r(0.5 / np.sqrt(D), D, D), r(0.5 / np.sqrt(D), D, Dh), r(0.5, Dh),
            r(0.5 / np.sqrt(Dh), Dh), np.float32(0.3)]
    stream = fwd_stream_plain(*_t(args[4], args[5]))
    got = _head_fwd_wide_emulated(args, stream.numpy())
    ref = grounding_head_plain(*(x.double() for x in _t(*args))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-9)


# --------------------------------------------------------------------------
# attention head dims past 256
# --------------------------------------------------------------------------
def test_head_dim_rule():
    # the narrow instances up to 128, past it the cluster: 128-column blocks, cluster_plan's count
    assert attention.head_dim_instance(64) == (64, 1) and attention.head_dim_instance(65) == (128, 1)
    assert attention.head_dim_instance(200) == (128, 2) and attention.head_dim_instance(256) == (128, 2)
    assert attention.head_dim_instance(257) == (128, 3) and attention.head_dim_instance(512) == (128, 4)
    assert attention.head_dim_instance(1024) == (128, 8)
    assert attention.head_dim_instance(1100) == (128, 5)  # two passes of 5 blocks
    assert [mm_attention.head_dim_instance(d) for d in (64, 128, 129, 256, 320, 1024)] == [
        (128, 1), (128, 1), (128, 2), (128, 2), (128, 3), (128, 8)]
    assert mm_attention.DQ_ROWS == 64  # both dq kernels' blocks: the (F, F) partials' row tiles
    # the launches past 128 (cluster_plan's): the backward 8 args at any dh, the forward 7, 4 past dh 1024
    assert [len(mm_attention.bwd_groups(12, d)) for d in (128, 256, 257, 1024, 1100)] == [2, 2, 2, 2, 2]
    assert mm_attention.bwd_groups(8, 1100) == [(0, 8)]
    assert mm_attention.fwd_groups(8, 1100, "default") == [(0, 4), (4, 8)]


@pytest.mark.parametrize("dh", [320, 512])
def test_flash_wide_forward_matches_jax(dh):
    _, q, k, v, mask, fb, fid = _attn_inputs(12, 1, 2, 40, dh, 5)
    o, lse = flash_attention_plain(*_t(q, k, v, mask, fb, fid))
    ref = jflash(*(jnp.asarray(x) for x in (q, k, v, mask, fb, fid)), interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
    assert np.isfinite(lse.numpy()).all()


@pytest.mark.parametrize("mode", ["recompute", "emit"])
@pytest.mark.parametrize("dh", [320, 512])
def test_flash_wide_grads_match_jax(dh, mode):
    rng, q, k, v, mask, fb, fid = _attn_inputs(13, 1, 2, 40, dh, 5)
    cot = rng.normal(size=q.shape).astype(np.float32)
    diff = (0, 1, 2, 4)
    got = _grads(lambda *a: flash_attention(*a, bwd_mode=mode), (q, k, v, mask, fb, fid), diff, cot)
    ref = _jax_grads(lambda *a: jflash(*a, interpret=True, bwd_mode=mode), (q, k, v, mask, fb, fid), diff, cot)
    for name, a, b in zip(("dq", "dk", "dv", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-3, err_msg=name)


def _mm_args(seed, dh):
    rng, qm, km, vm, mask, fb, fid = _attn_inputs(seed, 1, 2, 40, dh, 5)
    cn = rng.uniform(-3.0, 0.0, (1, 2, 3, 40)).astype(np.float32)
    return rng, ((qm / np.sqrt(dh)).astype(np.float32), km, vm, cn, mask, fb, fid)


@pytest.mark.parametrize("dh", [320, 512])
def test_mm_wide_forward_matches_jax(dh):
    _, args = _mm_args(14, dh)
    out, m, den = mm_attention_plain(*_t(*args))
    ref = jmm(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
    assert (den.numpy() >= 1).all()


@pytest.mark.parametrize("mode", ["emit", "recompute"])
@pytest.mark.parametrize("dh", [320, 512])
def test_mm_wide_grads_match_jax(dh, mode):
    rng, args = _mm_args(15, dh)
    cot = rng.normal(size=(1, 2, 3, 40, dh)).astype(np.float32)
    diff = (0, 1, 2, 3, 5)
    got = _grads(lambda *a: mm_shared_qk_attention(*a, bwd_mode=mode), args, diff, cot)
    ref = _jax_grads(lambda *a: jmm(*a, interpret=True, bwd_mode=mode), args, diff, cot)
    for name, a, b in zip(("dq", "dk", "dv", "dcn", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3, err_msg=name)


# --------------------------------------------------------------------------
# a small VOGNet at vis 320 with one head (dh 320)
# --------------------------------------------------------------------------
def _wider_cfg():
    """Narrow widths but vis 320 with one head: head dim 320 (on the card
    the attention kernels' wide path, 3 column slices) and the fused head
    at D 320."""
    cfg = _cfg(tiny=True)
    cfg.mdl.vis_dim, cfg.mdl.n_heads = 320, 1
    cfg.mdl.decomposed_mm = True
    cfg.mdl.dropout = 0.0
    return jpost_proc_config(cfg)


def test_wider_vognet_passes_the_card_check():
    cfg = port_cfg(_wider_cfg())
    assert cfg.mdl.vis_dim // cfg.mdl.n_heads == 320 and attention.head_dim_instance(320) == (128, 3)
    check_kernel_shapes(cfg)


def test_wider_vognet_logits_match_flax():
    cfg = _wider_cfg()
    pcfg = port_cfg(cfg)
    B = 2
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _random_batch(cfg, B, seed=3)
    ref = np.asarray(state.apply_fn(
        {"params": state.params},
        jassemble({k: jnp.asarray(v) for k, v in batch.items()}, cfg.ds.conc_type),
        deterministic=True,
    ))
    model = get_model(pcfg, 400, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params), pcfg), strict=True)
    with torch.no_grad():
        got = model(assemble_batch({k: torch.from_numpy(v) for k, v in batch.items()}, pcfg.ds.conc_type))
    assert got.shape == ref.shape
    close(got.numpy(), ref)


def test_wider_vognet_train_step_matches_jax():
    cfg = _wider_cfg()
    t = cfg.train
    t.lr, t.lr_schedule, t.grad_clip, t.skip_nonfinite, t.pos_weight = 1e-3, "const", 1e6, 3, 20.0
    pcfg = port_cfg(cfg)
    B = 2
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _random_batch(cfg, B, seed=1)
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
