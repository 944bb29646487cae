"""The production recipe's mm backward kernel, mm_bwd_dkv_wg (emit mode at
"default", dh <= 128; csrc/mm_attention.cu), on the CPU:

  * the route (``kernels/mm_attention.py §bwd_route``): which (precision,
    mode, head dim, frames, args) take it: the GT5 and P100 production
    shapes do, "highest", recompute mode and head dims past 128 do not;
    arg counts past 8 take it once a group of ``bwd_groups``;
  * the host-side mirrors of its shared layouts: ``wg_tile_index`` (the
    K-major core matrices every tile is laid out in, as the kernel's
    ``cm_idx``) read back through the wgmma descriptor's rule (16 bytes of
    a row, 8 rows a core matrix, LBO between 4-column groups, SBO = 128
    bytes between 8-row groups) gives the matrix it stores, and
    ``wg_d_of_m`` (the head-dim order of the transposed products' M rows)
    is a permutation that pairs a lane's rows g and g + 8 on adjacent
    columns;
  * the kernel's tile algorithm, emulated in numpy with those mirrors and
    the kernel's fragment reads (two 64-key warpgroups a 128-key block,
    32-row query tiles, S^T once a tile for all args, the statistics zero
    past T, dcn summed a tile at a time, dV^T and dK^T from the A fragments
    read transposed out of the g_a / Q tile and the B operand read out of
    the staging tile, comb masked to the valid keys) against ``jax.vjp``
    of the JAX package's emit backward in interpret mode on the same numpy
    inputs, frame ids in order as the model's (the JAX package's mm
    tolerance, atol 1e-4 / rtol 1e-3); with frame ids in no order, where
    the Pallas backward is off its own forward's gradient (ROADMAP,
    reference-side faults), against autograd of the port's plain forward
    in fp64; with a batch row whose keys are all masked (deliberate
    difference (a)), against the port's plain backward.

The kernel itself runs on the card only (tests/test_torch_port_cuda.py
§test_mm_bwd_kernel, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vog_tpu.kernels.mm_attention import mm_shared_qk_attention as jmm
from vog_tpu_torch.kernels import mm_attention as mm
from vog_tpu_torch.kernels._cluster import arg_groups

PAST, MASKED = -2, -1  # key codes past T and masked (csrc/tiles.cuh)
NEG = float(np.float32(-1e30))  # a masked key's score, as the kernel holds it (fp32)
DK = 128  # the padded head dim of the kernel's tiles


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------
@pytest.mark.parametrize("precision,mode,dh,F,A,route", [
    ("default", "emit", 128, 10, 5, "wg"),  # GT5 production: vis 512, 4 heads, 10 frames
    ("default", "emit", 128, 40, 5, "wg"),  # P100 production: 40 frames
    ("default", "emit", 40, 80, 1, "wg"),  # past 64 frames, one arg
    ("default", "emit", 37, 10, 8, "wg"),  # a head dim the wrapper pads to 40
    ("highest", "emit", 128, 10, 5, "narrow"),
    ("default", "recompute", 128, 10, 5, "narrow"),
    ("highest", "recompute", 64, 80, 3, "narrow"),
    ("default", "emit", 256, 10, 5, "cluster"),
    ("default", "emit", 129, 40, 5, "cluster"),
])
def test_bwd_route(precision, mode, dh, F, A, route):
    assert mm.bwd_route(mode, precision, dh) == route  # frames and args do not change it
    assert [g for g in mm.bwd_groups(A, dh)] == arg_groups(A, mm.KERNEL_ARGS if dh <= 128 else 8)


@pytest.mark.parametrize("A", [9, 12, 17])
def test_wg_route_takes_args_past_a_launch_in_groups(A):
    groups = mm.bwd_groups(A, 128)
    assert len(groups) == -(-A // mm.KERNEL_ARGS) and all(a1 - a0 <= mm.KERNEL_ARGS for a0, a1 in groups)
    assert groups[0][0] == 0 and groups[-1][1] == A and mm.bwd_route("emit", "default", 128) == "wg"


# --------------------------------------------------------------------------
# the layouts
# --------------------------------------------------------------------------
def _descriptor_read(buf, start, lbo, n_rows, k_cols):
    """Element (row n, k) of the K-major operand a no-swizzle wgmma
    descriptor at float ``start`` reads, ``lbo`` floats between 4-column
    groups, 32 floats (128 bytes) between 8-row groups: (n_rows, k_cols)."""
    n = np.arange(n_rows)[:, None]
    k = np.arange(k_cols)[None, :]
    return buf[start + (k // 4) * lbo + (n // 8) * 32 + (n % 8) * 4 + k % 4]


@pytest.mark.parametrize("rows,ld", [(mm.WG_KEYS, mm.WG_KV_LD), (mm.WG_ROWS, mm.WG_Q_LD), (mm.WG_ROWS, mm.WG_G_LD),
                                     (mm.WG_KEYS, mm.WG_P_LD)])
def test_wg_tile_index_is_the_descriptor_layout(rows, ld):
    """Each tile, written by ``wg_tile_index``, holds every element once,
    and each k-step of 8 columns read through its descriptor (start 2 s
    ld, LBO ld floats, SBO 128 bytes) is that step's columns."""
    cols = DK if ld != mm.WG_P_LD else mm.WG_ROWS  # the staging tile: 32 query columns
    x = np.random.default_rng(rows + ld).normal(size=(rows, cols))
    idx = np.array([[mm.wg_tile_index(r, c, ld) for c in range(cols)] for r in range(rows)])
    assert len(np.unique(idx)) == rows * cols and idx.max() < (cols // 4) * ld
    buf = np.zeros((cols // 4) * ld)
    buf[idx] = x
    for s in range(cols // 8):
        np.testing.assert_array_equal(_descriptor_read(buf, 2 * s * ld, ld, rows, 8), x[:, 8 * s:8 * s + 8])
    # the padding (16 floats a group of the g_a and staging tiles) is never read
    assert ld - 4 * rows in (0, 16)


def test_wg_d_of_m_pairs_a_lanes_rows():
    d = [mm.wg_d_of_m(m) for m in range(DK)]
    assert sorted(d) == list(range(DK))
    for h in range(2):
        for w in range(4):
            for g in range(8):
                m = 64 * h + 16 * w + g
                assert d[m + 8] == d[m] + 1 and d[m] % 2 == 0 and d[m] // 16 == 4 * h + w


def _a_index(ld):
    """[h][s] -> (64, 8) float offsets of the A fragments of a transposed
    product, as the kernel's a_frags_t reads them from a tile of group
    stride ``ld``: lane (g, t) of warp w takes the float2 at row 8 s + t,
    column 64 h + 16 w + 2 g (a0 = A(16 w + g, t), a1 = A(16 w + g + 8, t))
    and the one 4 rows further (a2, a3 at k = t + 4)."""
    out = [[np.zeros((64, 8), dtype=np.int64) for _ in range(4)] for _ in range(2)]
    for h in range(2):
        for s in range(4):
            for w in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    off = (16 * h + 4 * w + g // 2) * ld + 4 * (8 * s + t) + 2 * (g % 2)  # cm_idx + 2 (g & 1)
                    m = 16 * w + g
                    out[h][s][m, t], out[h][s][m + 8, t] = off, off + 1
                    out[h][s][m, t + 4], out[h][s][m + 8, t + 4] = off + 16, off + 17
    return out


A_G, A_Q = _a_index(mm.WG_G_LD), _a_index(mm.WG_Q_LD)
B_P = [np.array([[(2 * s + k // 4) * mm.WG_P_LD + (n // 8) * 32 + (n % 8) * 4 + k % 4 for n in range(64)]
                 for k in range(8)]) for s in range(4)]


def _tile(x, ld):
    """A (rows, 128) matrix laid out as the kernel's tile of group stride ld."""
    rows, cols = x.shape
    buf = np.zeros((cols // 4) * ld)
    idx = np.array([[mm.wg_tile_index(r, c, ld) for c in range(cols)] for r in range(rows)])
    buf[idx] = x
    return buf


def _transposed_product(tile, a_idx, staged):
    """(128, 64): X^T B as the kernel's wgmma issues it: A from a_idx's
    reads of ``tile``, B (32 query rows x 64 keys) read by the staging
    tile's descriptor, rows in wg_d_of_m's order."""
    acc = np.zeros((DK, 64))
    for h in range(2):
        for s in range(4):
            acc[64 * h:64 * h + 64] += tile[a_idx[h][s]] @ staged[B_P[s]]
    return acc


def test_transposed_products_are_the_gradient_products():
    rng = np.random.default_rng(5)
    x, p = rng.normal(size=(mm.WG_ROWS, DK)), rng.normal(size=(64, mm.WG_ROWS))  # g_a rows, P^T
    staged = _tile(p, mm.WG_P_LD)
    order = [mm.wg_d_of_m(m) for m in range(DK)]
    for ld, a_idx in ((mm.WG_G_LD, A_G), (mm.WG_Q_LD, A_Q)):
        got = _transposed_product(_tile(x, ld), a_idx, staged)
        want = x.T @ p.T  # (d, key): dV^T += G^T P, dK^T += Q^T comb
        np.testing.assert_allclose(got, want[order], rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------
# the tile algorithm against the JAX package
# --------------------------------------------------------------------------
def _emulate_wg(qm, km, vm, cn, mask, fb, fid, out, mrow, den, g):
    """dk, dv, dcn and comb as mm_bwd_dkv_wg computes them (float64, no
    TF32 rounding): the algorithm and layouts, not the card's arithmetic."""
    B, H, T, dh = qm.shape
    A = cn.shape[2]
    delta = (g * out).sum(-1)
    dk, dv = np.zeros((B, H, T, dh)), np.zeros((B, H, T, dh))
    dcn, comb = np.zeros((B, H, A, T)), np.zeros((B * H, T, T))
    order = [mm.wg_d_of_m(m) for m in range(DK)]

    def rows_of(x, idx):  # rows idx of a (T, dh) matrix, zero past T and from dh to 128
        t = np.zeros((len(idx), DK))
        ok = idx < T
        t[ok, :dh] = x[idx[ok]]
        return t

    for b in range(B):
        for h in range(H):
            for k0 in range(0, T, 2 * mm.WG_KEYS):
                for wg in range(2):
                    keys = k0 + mm.WG_KEYS * wg + np.arange(mm.WG_KEYS)
                    kv = keys < T
                    kc = np.where(~kv, PAST, np.where(mask[b, np.minimum(keys, T - 1)] > 0,
                                                      fid[np.minimum(keys, T - 1)], MASKED))
                    K, V = rows_of(km[b, h], keys), rows_of(vm[b, h], keys)
                    dvt, dkt, dc = np.zeros((DK, 64)), np.zeros((DK, 64)), np.zeros((A, 64))
                    for i0 in range(0, T, mm.WG_ROWS):
                        qi = i0 + np.arange(mm.WG_ROWS)
                        qv = qi < T
                        Q = rows_of(qm[b, h], qi)
                        fq = np.where(qv, fid[np.minimum(qi, T - 1)], 0)
                        st = K @ Q.T
                        st = np.where(kc[:, None] >= 0, st + fb[h][fq[None, :], np.maximum(kc, 0)[:, None]], NEG)
                        cb = np.zeros((64, mm.WG_ROWS))
                        for a in range(A):
                            G = rows_of(g[b, h, a], qi)
                            sel = np.minimum(qi, T - 1)
                            m_ = np.where(qv, mrow[b, h, a, sel], 0.0)
                            inv = np.where(qv, 1.0 / den[b, h, a, sel], 0.0)
                            dl = np.where(qv, delta[b, h, a, sel], 0.0)
                            cna = np.where(kv, cn[b, h, a, np.minimum(keys, T - 1)], 0.0)
                            dpt = V @ G.T
                            with np.errstate(over="ignore"):
                                p = np.exp(st + cna[:, None] - m_[None, :]) * inv[None, :]
                            p = np.where((inv[None, :] == 0) | (kc[:, None] == PAST), 0.0, p)
                            ds = p * (dpt - dl[None, :])
                            cb += ds
                            dc[a] += ds.sum(1)
                            dvt += _transposed_product(_tile(G, mm.WG_G_LD), A_G, _tile(p, mm.WG_P_LD))
                        cb = np.where(kc[:, None] < 0, 0.0, cb)
                        dkt += _transposed_product(_tile(Q, mm.WG_Q_LD), A_Q, _tile(cb, mm.WG_P_LD))
                        comb[b * H + h][np.ix_(qi[qv], keys[kv])] = cb.T[qv][:, kv]
                    d_ok = np.array(order) < dh
                    for n in np.nonzero(kv)[0]:
                        dv[b, h, keys[n], np.array(order)[d_ok]] = dvt[d_ok, n]
                        dk[b, h, keys[n], np.array(order)[d_ok]] = dkt[d_ok, n]
                    dcn[b, h][:, keys[kv]] = dc[:, kv]
    return dk, dv, dcn, comb


def _inputs(seed, B, H, A, T, dh, F, all_masked=False, mixed=False):
    """Frame ids in order (the model's: a frame's proposals together), or
    ``mixed``: in no order."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, dh)).astype(np.float32) for _ in range(3))
    mask = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    if all_masked:
        mask[B - 1] = 0.0
    fb = rng.normal(scale=0.5, size=(H, F, F)).astype(np.float32)
    fid = rng.integers(0, F, size=T).astype(np.int32)
    if not mixed:
        fid = np.sort(fid)
    cn = rng.uniform(-3.0, 0.0, (B, H, A, T)).astype(np.float32)
    return rng, (q * dh ** -0.5, k, v, cn, mask, fb, fid)


def _emulated_grads(args, cot):
    """(dq, dk, dv, dcn, dfb): the emulated kernel, then dq and dfb over its
    comb as the wrapper forms them (``_dq_dfb``)."""
    t = [torch.from_numpy(np.array(a)) for a in args]
    out, mrow, den = (x.numpy() for x in mm.mm_attention_plain(*t))
    qm, km, vm, cn, mask, fb, fid = args
    dk, dv, dcn, comb = _emulate_wg(*(x.astype(np.float64) if x.dtype == np.float32 else x for x in args),
                                    out.astype(np.float64), mrow.astype(np.float64), den.astype(np.float64),
                                    cot.astype(np.float64))
    B, H, T, _ = qm.shape
    dq, dfb = mm._dq_dfb(torch.from_numpy(comb.astype(np.float32)), t[1], t[6], fb.shape[-1], H)
    return [dq.numpy(), dk, dv, dcn, dfb.numpy()]


# (B, H, A, T, dh, F): one partial query tile (13), a second warpgroup with
# keys (70), a second 128-key block whose second warpgroup holds no key
# (150), dh not a multiple of 8, frames past 64
@pytest.mark.parametrize("shape", [(1, 2, 1, 13, 16, 10), (1, 2, 3, 70, 40, 10), (2, 1, 5, 150, 8, 10),
                                   (1, 2, 2, 45, 36, 80)])
def test_wg_tiles_match_jax(shape):
    B, H, A, T, dh, F = shape
    rng, args = _inputs(3, B, H, A, T, dh, F)
    cot = rng.normal(size=(B, H, A, T, dh)).astype(np.float32)
    got = _emulated_grads(args, cot)
    diff = (0, 1, 2, 3, 5)

    def f(*d):
        full = list(args)
        for i, x in zip(diff, d):
            full[i] = x
        return jmm(*full, interpret=True, bwd_mode="emit")

    _, vjp = jax.vjp(f, *[jnp.asarray(args[i]) for i in diff])
    ref = [np.asarray(x) for x in vjp(jnp.asarray(cot))]
    for name, a, b in zip(("dq", "dk", "dv", "dcn", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3, err_msg=name)


def _autograd_grads(args, cot):
    """Gradients of sum(out * cot) by autograd of the port's plain forward
    in fp64."""
    t = [torch.from_numpy(np.array(a)).double() if a.dtype == np.float32 else torch.from_numpy(np.array(a))
         for a in args]
    diff = [t[i].requires_grad_() for i in (0, 1, 2, 3, 5)]
    out = mm.mm_attention_plain(*t)[0]
    return [x.numpy() for x in torch.autograd.grad(out, diff, torch.from_numpy(cot).double())]


@pytest.mark.parametrize("seed,shape", [(7, (1, 2, 1, 13, 16, 10)), (3, (1, 2, 3, 70, 40, 10)),
                                        (3, (2, 1, 5, 150, 8, 10))])
def test_wg_tiles_with_frames_in_no_order_match_autograd(seed, shape):
    """Frame ids in no order: on these inputs the JAX package's Pallas
    backward (both modes, in interpret mode) differs from the gradient of
    its own forward by O(1) (ROADMAP, reference-side faults), so the
    emulated kernel is held to autograd of the port's plain forward in
    fp64, which matches the JAX forward (tests/test_torch_port_kernels.py
    §test_mm_plain_vs_pallas, mixed frames)."""
    B, H, A, T, dh, F = shape
    rng, args = _inputs(seed, B, H, A, T, dh, F, mixed=True)
    cot = rng.normal(size=(B, H, A, T, dh)).astype(np.float32)
    got, ref = _emulated_grads(args, cot), _autograd_grads(args, cot)
    for name, a, b in zip(("dq", "dk", "dv", "dcn", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3, err_msg=name)


def test_wg_tiles_with_all_masked_row_match_the_plain_backward():
    """Batch row 1's keys all masked: the kernel's arithmetic there (every
    key at -1e30, p = 1 / den) is the plain backward's, which the JAX
    package's Pallas kernel does not share (deliberate difference (a))."""
    rng, args = _inputs(8, 2, 2, 3, 40, 12, 5, all_masked=True)
    cot = rng.normal(size=(2, 2, 3, 40, 12)).astype(np.float32)
    got = _emulated_grads(args, cot)
    t = [torch.from_numpy(np.array(a)) for a in args]
    ref = mm.mm_attention_bwd_plain(*t, *mm.mm_attention_plain(*t), torch.from_numpy(cot))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-4, rtol=1e-3)
