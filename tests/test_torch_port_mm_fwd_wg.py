"""The production recipe's mm forward kernel, mm_fwd_wg (a one-pass
precision, dh <= 128; csrc/mm_attention.cu), on the CPU:

  * the route (``kernels/mm_attention.py §fwd_route``): the GT5 and P100
    production shapes take it at every one-pass precision name, "highest"
    and "float32" do not, past dh 128 the cluster kernel does; frames and
    args do not change it; arg counts past WG_FWD_ARGS (the kernel's
    kFwArgs) take it once a group of ``fwd_groups``;
  * the host-side mirrors of its shared layouts read back through the
    wgmma descriptor's rule (16 bytes of a row, 8 rows a core matrix, LBO
    between 4-column groups, SBO = 128 bytes between 8-row groups): the
    resident Q tile and a K tile (S = Q K^T from shared memory), the P_a
    staging tile [query][key] (the B operand of O_a^T), the V tile whose
    A fragments of V^T are read transposed in ``wg_d_of_m``'s head-dim
    order, and ``fw_pos`` (the order of the per-row rescale factors and
    sums, four 16-byte reads a lane);
  * the kernel's tile algorithm, emulated in numpy with those mirrors and
    the kernel's fragment reads (64-row blocks, 32-key tiles, S of a whole
    tile in each of the two consumer warpgroups, each row's max over the
    tile, every exp once: each warpgroup writes P_a at its 16 keys into
    the shared staging tile, A lazy online softmaxes (a warp's reference
    maxima move only past kLazy; the true max kept, the denominator
    rebased onto it), O_a^T of each warpgroup's 64 head-dim columns
    rescaled where a flag is set by the factors read through ``fw_pos``
    and accumulated from the V^T fragments and the staged P_a, the two
    warpgroups' row sums added, rows and keys past T) against the JAX
    package's Pallas forward in interpret mode (out, row max,
    denominator) on the same numpy inputs, frame ids in order and in no
    order (the JAX package's mm tolerance, atol 1e-4 / rtol 1e-3), and
    with a batch row whose keys are all masked (deliberate difference
    (a)) against the port's plain forward.

The kernel itself runs on the card only (tests/test_torch_port_cuda.py
§test_mm, chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vog_tpu.kernels import mm_attention as jmm
from vog_tpu_torch.kernels import mm_attention as mm
from vog_tpu_torch.kernels._cluster import arg_groups

PAST, MASKED = -2, -1  # key codes past T and masked (csrc/tiles.cuh)
NEG = float(np.float32(-1e30))  # a masked key's score, as the kernel holds it (fp32)
DK = 128  # the padded head dim of the kernel's tiles
LAZY = 8.0  # kLazy: how far a tile's max passes a row's reference max before the reference moves
CU = Path(mm.__file__).resolve().parents[1] / "csrc" / "mm_attention.cu"


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU.read_text()).group(1))


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------
@pytest.mark.parametrize("precision,dh,F,A,route", [
    ("default", 128, 10, 5, "wg"),  # GT5 production: vis 512, 4 heads, 10 frames
    ("default", 128, 40, 5, "wg"),  # P100 production: 40 frames
    ("high", 128, 10, 5, "wg"),  # the one-pass names JAX takes
    ("tensorfloat32", 64, 10, 3, "wg"),
    ("bfloat16", 128, 40, 5, "wg"),
    ("default", 37, 10, 8, "wg"),  # a head dim the wrapper pads to 40
    ("default", 40, 80, 1, "wg"),  # past 64 frames
    ("highest", 128, 10, 5, "narrow"),
    ("float32", 128, 40, 5, "narrow"),
    ("highest", 37, 80, 9, "narrow"),
    ("default", 256, 10, 5, "cluster"),
    ("highest", 129, 40, 5, "cluster"),
])
def test_fwd_route(precision, dh, F, A, route):
    assert mm.fwd_route(precision, dh) == route  # frames and args do not change it
    most = {"wg": mm.WG_FWD_ARGS, "narrow": mm.KERNEL_ARGS}.get(route)
    if most is not None:
        assert mm.fwd_groups(A, dh, precision) == arg_groups(A, most)


@pytest.mark.parametrize("A", [6, 8, 9, 17])
def test_wg_forward_takes_args_past_a_launch_in_groups(A):
    """A launch of mm_fwd_wg takes at most kFwArgs (WG_FWD_ARGS) args: more
    run in ``arg_groups``, in order, covering every arg."""
    assert mm.WG_FWD_ARGS == _const("kFwArgs")
    groups = mm.fwd_groups(A, 128, "default")
    assert len(groups) == -(-A // mm.WG_FWD_ARGS) and all(a1 - a0 <= mm.WG_FWD_ARGS for a0, a1 in groups)
    assert groups[0][0] == 0 and groups[-1][1] == A
    assert all(x[1] == y[0] for x, y in zip(groups, groups[1:]))
    assert max(a1 - a0 for a0, a1 in groups) - min(a1 - a0 for a0, a1 in groups) <= 1


def test_fwd_layout_constants_mirror_the_kernel():
    assert (mm.FW_ROWS, mm.FW_KEYS) == (_const("kFwRows"), _const("kFwKeys")) == (64, 32)
    text = CU.read_text()
    assert f"constexpr float kLazy = {LAZY:g}.f;" in text
    assert "constexpr int kFwVLd = kFwKeys * 4 + 16;" in text and "constexpr int kFwPLd = kFwRows * 4 + 16;" in text
    assert "constexpr int kFwQLd = kFwRows * 4;" in text and "constexpr int kFwKLd = kFwKeys * 4;" in text
    assert (mm.FW_Q_LD, mm.FW_K_LD, mm.FW_V_LD, mm.FW_P_LD) == (256, 128, 144, 272)


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


def _tile(x, ld):
    """A (rows, cols) matrix laid out as the kernel's tile of group stride ld."""
    rows, cols = x.shape
    buf = np.zeros((cols // 4) * ld)
    idx = np.array([[mm.wg_tile_index(r, c, ld) for c in range(cols)] for r in range(rows)])
    buf[idx] = x
    return buf


@pytest.mark.parametrize("rows,cols,ld", [(mm.FW_ROWS, DK, mm.FW_Q_LD), (mm.FW_KEYS, DK, mm.FW_K_LD),
                                          (mm.FW_KEYS, DK, mm.FW_V_LD), (mm.FW_ROWS, mm.FW_KEYS, mm.FW_P_LD)])
def test_fw_tiles_are_the_descriptor_layout(rows, cols, ld):
    """Each tile holds every element once, and each k-step of 8 columns read
    through its descriptor (start 2 s ld, LBO ld floats, SBO 128 bytes) is
    that step's columns: the Q tile (64 rows: wgmma's M of S), a K tile (32
    keys: N of S), a V tile and the P_a staging tile (64 query rows x 32
    keys: the B operand of O_a^T, N 64)."""
    x = np.random.default_rng(rows + ld).normal(size=(rows, cols))
    idx = np.array([[mm.wg_tile_index(r, c, ld) for c in range(cols)] for r in range(rows)])
    assert len(np.unique(idx)) == rows * cols and idx.max() < (cols // 4) * ld
    buf = _tile(x, ld)
    for s in range(cols // 8):
        np.testing.assert_array_equal(_descriptor_read(buf, 2 * s * ld, ld, rows, 8), x[:, 8 * s:8 * s + 8])
    assert ld - 4 * rows in (0, 16)  # the padding (V and P tiles) is never read


def test_fw_pos_gives_each_lane_its_columns():
    """fw_pos is a permutation of 0..63, and lane t's four 16-byte reads
    (floats 16 t + 4 j + u) are the factors of its O^T columns q = 8 n + 2 t
    + e, n = 2 j + u // 2, e = u % 2, in the order the kernel multiplies."""
    pos = [mm.fw_pos(q) for q in range(mm.FW_ROWS)]
    assert sorted(pos) == list(range(64))
    for t in range(4):
        for j in range(4):
            for u in range(4):
                q = 8 * (2 * j + u // 2) + 2 * t + u % 2
                assert pos[q] == 16 * t + 4 * j + u


def _v_index():
    """[c][k] -> (64, 8) float offsets of the A fragments of V^T (half c, k-step
    k), as mm_fwd_wg reads them from a V tile: lane (g, t) of warp w takes
    the float2 at key row 8 k + t, column 64 c + 16 w + 2 g (a0 = A(16 w +
    g, t), a1 = A(16 w + g + 8, t)) and the one 4 key rows further (a2, a3
    at k = t + 4)."""
    out = [[np.zeros((64, 8), dtype=np.int64) for _ in range(4)] for _ in range(2)]
    for c in range(2):
        for k in range(4):
            for w in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    off = (16 * c + 4 * w + g // 2) * mm.FW_V_LD + 4 * (8 * k + t) + 2 * (g % 2)
                    m = 16 * w + g
                    out[c][k][m, t], out[c][k][m + 8, t] = off, off + 1
                    out[c][k][m, t + 4], out[c][k][m + 8, t + 4] = off + 16, off + 17
    return out


A_V = _v_index()
ORDER = np.array([mm.wg_d_of_m(m) for m in range(64)])  # a half's head-dim order (< 64)


def _pv(vbuf, pbuf, c):
    """(64, 64): O^T (head-dim rows 64 c + ORDER, query columns) += V^T P^T as
    warpgroup c issues it: A from the V tile's fragment reads, B (64 query
    rows x 8 keys a k-step) through the staging tile's descriptor."""
    acc = np.zeros((64, mm.FW_ROWS))
    for k in range(4):
        acc += vbuf[A_V[c][k]] @ _descriptor_read(pbuf, 2 * k * mm.FW_P_LD, mm.FW_P_LD, mm.FW_ROWS, 8).T
    return acc


def test_pv_product_is_the_value_product():
    rng = np.random.default_rng(5)
    v, p = rng.normal(size=(mm.FW_KEYS, DK)), rng.normal(size=(mm.FW_ROWS, mm.FW_KEYS))  # V rows, P [q][key]
    vbuf, pbuf = _tile(v, mm.FW_V_LD), _tile(p, mm.FW_P_LD)
    for c in range(2):
        want = (p @ v).T[64 * c + ORDER]  # (d, q): O^T of the half's columns
        np.testing.assert_allclose(_pv(vbuf, pbuf, c), want, rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------
# the tile algorithm against the JAX package
# --------------------------------------------------------------------------
RESCALES = []  # the emulation's count of (tile, arg, warp) rescales after a block's first tile, a call


def _emulate_fwd(qm, km, vm, cn, mask, fb, fid):
    """out, row max and denominator as mm_fwd_wg computes them (float64, no
    TF32 rounding): the algorithm and layouts, not the card's arithmetic."""
    RESCALES.append(0)
    B, H, T, dh = qm.shape
    A = cn.shape[2]
    out = np.zeros((B, H, A, T, dh))
    mrow, den = np.zeros((B, H, A, T)), np.zeros((B, H, A, T))

    def rows_of(x, idx):  # rows idx of a (T, dh) matrix, zero past T and from dh to 128
        t = np.zeros((len(idx), DK))
        ok = idx < T
        t[ok, :dh] = x[idx[ok]]
        return t

    slot = np.array([mm.fw_pos(q) for q in range(mm.FW_ROWS)])
    # lane t's columns in the order of its reads: column cols[16 t + 4 j + u]
    cols = np.array([8 * (2 * j + u // 2) + 2 * t + u % 2 for t in range(4) for j in range(4) for u in range(4)])
    for b in range(B):
        kv_all = np.arange(T)
        kc_all = np.where(mask[b] > 0, fid, MASKED)
        for h in range(H):
            for q0 in range(0, T, mm.FW_ROWS):
                qi = q0 + np.arange(mm.FW_ROWS)
                qv = qi < T
                qbuf = _tile(rows_of(qm[b, h], qi), mm.FW_Q_LD)
                fq = np.where(qv, fid[np.minimum(qi, T - 1)], 0)
                m = np.full((2, A, mm.FW_ROWS), NEG)  # each warpgroup's copy of the reference maxima
                mt = np.full((A, mm.FW_ROWS), NEG)  # the true running max
                lp = np.zeros((2, A, mm.FW_ROWS))  # each warpgroup's part of the sums
                ot = np.zeros((2, A, 64, mm.FW_ROWS))  # O_a^T of each warpgroup's 64 columns
                for j0 in range(0, T, mm.FW_KEYS):
                    keys = j0 + np.arange(mm.FW_KEYS)
                    kv = keys < T
                    kc = np.where(kv, kc_all[np.minimum(keys, T - 1)], PAST)
                    kbuf = _tile(rows_of(km[b, h], keys), mm.FW_K_LD)
                    vbuf = _tile(rows_of(vm[b, h], keys), mm.FW_V_LD)
                    s = sum(_descriptor_read(qbuf, 2 * k * mm.FW_Q_LD, mm.FW_Q_LD, mm.FW_ROWS, 8)
                            @ _descriptor_read(kbuf, 2 * k * mm.FW_K_LD, mm.FW_K_LD, mm.FW_KEYS, 8).T
                            for k in range(DK // 8))
                    s = np.where(kc[None, :] >= 0, s + fb[h][fq[:, None], np.maximum(kc, 0)[None, :]],
                                 np.where(kc[None, :] == MASKED, NEG, -np.inf))
                    cna = np.where(kv[None, :], cn[b, h][:, np.minimum(keys, T - 1)], 0.0)  # (A, keys)
                    pbuf = np.zeros((A, (mm.FW_KEYS // 4) * mm.FW_P_LD))
                    alpha = np.zeros((2, A, mm.FW_ROWS))  # each warpgroup's factors, in fw_pos order
                    flags = np.zeros((2, A, 4), bool)  # each warpgroup's warps' rescale flags
                    for c in range(2):  # each warpgroup: the whole tile's max, its 16 keys' exps
                        half = slice(16 * c, 16 * c + 16)
                        for a in range(A):
                            x = s + cna[a][None, :]
                            tmax = x.max(1)
                            if c == 0:
                                mt[a] = np.maximum(mt[a], tmax)
                            al = np.ones(mm.FW_ROWS)
                            for w in range(4):  # a warp's 16 rows move their reference together
                                rows = slice(16 * w, 16 * w + 16)
                                if np.any(tmax[rows] > m[c, a][rows] + LAZY):
                                    mn = np.maximum(m[c, a][rows], tmax[rows])
                                    al[rows] = np.exp(m[c, a][rows] - mn)
                                    m[c, a][rows] = mn
                                    flags[c, a, w] = True
                                    RESCALES[-1] += j0 > 0 and c == 0
                            alpha[c, a][slot] = al
                            with np.errstate(invalid="ignore"):
                                p = np.exp(x[:, half] - m[c, a][:, None])
                            assert np.all(p <= np.exp(LAZY))
                            lp[c, a] = lp[c, a] * al + p.sum(1)
                            stage = np.zeros((mm.FW_ROWS, mm.FW_KEYS))
                            stage[:, half] = p
                            idx = np.array([[mm.wg_tile_index(q, k, mm.FW_P_LD) for k in range(mm.FW_KEYS)]
                                            for q in range(mm.FW_ROWS)])
                            pbuf[a][idx[:, half]] = p
                    for c in range(2):
                        for a in range(A):
                            if flags[c, a].any():  # else every factor is 1
                                ot[c, a][:, cols] *= alpha[c, a][None, :]  # lane reads
                            ot[c, a] += _pv(vbuf, pbuf[a], c)
                assert np.array_equal(m[0], m[1])  # both warpgroups hold the same reference maxima
                dsum = lp[0] + lp[1]  # in order
                for c in range(2):
                    d = 64 * c + ORDER
                    ok = d < dh
                    for a in range(A):
                        o = (ot[c, a] / dsum[a][None, :]).T  # (q, m)
                        out[b, h, a][np.ix_(qi[qv], d[ok])] = o[qv][:, ok]
                mrow[b, h][:, qi[qv]] = mt[:, qv]
                den[b, h][:, qi[qv]] = (dsum * np.exp(m[0] - mt))[:, qv]  # relative to the row max
    return out, mrow, den


def _inputs(seed, B, H, A, T, dh, F, all_masked=False, mixed=False, scale=1.0):
    """Frame ids in order (the model's: a frame's proposals together), or
    ``mixed``: in no order; the scores' spread times ``scale``."""
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
    return q * (scale * dh ** -0.5), k, v, cn, mask, fb, fid


def _emulated(args):
    return _emulate_fwd(*(x.astype(np.float64) if x.dtype == np.float32 else x for x in args))


def _fooled_rows(fid, T, blk):
    """The query rows of the JAX package's Pallas blocks (``blk`` rows)
    whose bias tile takes the frame-pure fast path wrongly: its test
    ``fq[0] == fq[bq - 1]`` (vog_tpu/kernels/attention.py §_bias_block)
    assumes frame ids in order, so a block of frame ids in no order whose
    first and last ids (the last padded by repeating fid[T - 1]) are equal
    gets one frame's bias row for all its rows (ROADMAP, reference-side
    faults)."""
    Tp = -(-T // blk) * blk
    fp = np.pad(fid, (0, Tp - T), mode="edge")
    bad = np.zeros(T, bool)
    for i in range(Tp // blk):
        blkf = fp[i * blk:(i + 1) * blk]
        if blkf[0] == blkf[-1] and len(set(blkf)) > 1:
            bad[i * blk:min((i + 1) * blk, T)] = True
    return bad


# (B, H, A, T, dh, F): one partial block and tile (13), a second key tile
# and a partial 64-row block (70), three blocks (150), the GT5 length
# (200); dh not a multiple of 8, frames past 64.  Frame ids in order: every
# row against the JAX package's Pallas forward.  In no order: every row
# against the port's plain forward in fp64 (which the JAX forward matches
# where its bias tile is right: tests/test_torch_port_kernels.py
# §test_mm_plain_vs_pallas), and the rows whose Pallas block is not fooled
# by its frame-pure test (``_fooled_rows``) against the JAX forward too.
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 1, 13, 16, 10), (1, 2, 3, 70, 40, 10), (2, 1, 5, 150, 8, 10),
                                   (1, 1, 5, 200, 24, 80), (1, 2, 3, 200, 36, 10)])
def test_fwd_wg_tiles_match_jax(shape, mixed):
    B, H, A, T, dh, F = shape
    args = _inputs(3, B, H, A, T, dh, F, mixed=mixed)
    got = _emulated(args)
    j = [jnp.asarray(x) for x in args]
    qf, kf, vf, ct, mk, fbc, fid, dims = jmm._prep(*j)
    out_ref, m_ref, den_ref = jmm._fwd(qf, kf, vf, ct, mk, fbc, fid, dims, True)
    Tp = dims[5]
    stat = lambda x: np.asarray(x).reshape(B, H, Tp, A).transpose(0, 1, 3, 2)[..., :T]  # noqa: E731
    ref = (np.asarray(out_ref).reshape(B, H, A, Tp, -1)[:, :, :, :T, :dh], stat(m_ref), stat(den_ref))
    pub = np.asarray(jmm.mm_shared_qk_attention(*j, interpret=True))  # the JAX package's entry point
    ok = ~_fooled_rows(args[6], T, dims[7]) if mixed else np.ones(T, bool)
    for name, a, b in zip(("out", "max", "den", "out (entry point)"), got + got[:1], ref + (pub,)):
        np.testing.assert_allclose(a[:, :, :, ok], b[:, :, :, ok], atol=1e-4, rtol=1e-3, err_msg=name)
    if mixed:
        plain = mm.mm_attention_plain(*(torch.from_numpy(np.array(a)).double() if a.dtype == np.float32
                                        else torch.from_numpy(np.array(a)) for a in args))
        for name, a, b in zip(("out", "max", "den"), got, plain):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("shape", [(1, 2, 3, 150, 16, 10), (2, 1, 5, 200, 40, 80)])
def test_fwd_wg_rescales_where_a_later_tile_passes_the_reference(shape):
    """Scores spread 6x wider (std ~6): later key tiles pass a row's
    reference max by more than kLazy, so the reference moves and O_a^T is
    rescaled by the factors read through fw_pos (which the default spread
    rarely needs); against the JAX package's Pallas forward."""
    B, H, A, T, dh, F = shape
    args = _inputs(5, B, H, A, T, dh, F, scale=6.0)
    got = _emulated(args)
    assert RESCALES[-1] > 0
    j = [jnp.asarray(x) for x in args]
    qf, kf, vf, ct, mk, fbc, fid, dims = jmm._prep(*j)
    out_ref, m_ref, den_ref = jmm._fwd(qf, kf, vf, ct, mk, fbc, fid, dims, True)
    Tp = dims[5]
    stat = lambda x: np.asarray(x).reshape(B, H, Tp, A).transpose(0, 1, 3, 2)[..., :T]  # noqa: E731
    ref = (np.asarray(out_ref).reshape(B, H, A, Tp, -1)[:, :, :, :T, :dh], stat(m_ref), stat(den_ref))
    for name, a, b in zip(("out", "max", "den"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3, err_msg=name)


def test_fwd_wg_tiles_with_all_masked_row_match_the_plain_forward():
    """Batch row 1's keys all masked: every key at -1e30, so each row's max
    is -1e30, every key below T weighs 1 and the denominator is T (the
    port's plain forward, which the JAX package's Pallas kernel does not
    share: deliberate difference (a))."""
    args = _inputs(8, 2, 2, 3, 70, 12, 5, all_masked=True)
    got = _emulated(args)
    ref = mm.mm_attention_plain(*(torch.from_numpy(np.array(a)) for a in args))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b.double().numpy(), atol=1e-4, rtol=1e-3)
    assert np.all(got[1][1] == NEG) and np.all(got[2][1] == 70.0)
