"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These need a GPU with nvcc (they build the kernels) and skip
without one; run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's host
need not have.)

Small shapes with ragged edges (T not a multiple of the tiles, T = 1,
dh < 128 and not a multiple of 8 or of 4, a row with every key masked,
every arg count of the mm attention, out-of-range, negative and empty
gather rows at 1, 4 and 64 rows a call), and the attention kernels at the
P100 length (T = 4000).  The mm and head backwards also give bitwise-equal
gradients on a second call.  Both backward modes of the flash and mm
attention (``bwd_mode``): each against the plain backward, and against
each other (their sums differ only by rounding); the head's forward at A
up to 8 in one launch, bitwise on a repeat call, and its backward at A =
6 and 8 (two launches of at most 5 args).  Tolerance as in chip_smoke.py: bitwise for the
gather, max |err| <= 1e-4 * max(1, max|ref|) for the fp32 kernels (and
|err| / |ref| <= 1e-3 for the mm forward).

CUDA graphs (train/graphs.py), on a narrow model at GT5's token count
(T = 200) with index-only batches: a captured K-step dispatch and its
shorter tail bitwise equal to eager steps (state, aux and launches), freeze
on NaN, a captured eval dispatch, a captured B = 16 step whose head
backward forks onto its second stream (gradients bitwise the eager
step's), the graphed Predictor bitwise the eager one in every bucket, and
a capture that fails raising with the state untouched; and the dropout
keep mask's bits equal on the CPU and the card.

The wide instances (``test_wide_instance_matches_plain``): the flash
kernels at dh 64 and 40 and at 65, 80 and 160 frames, the mm kernels
past 64 frames and at 9 and 12 args (in groups of at most 8), and both
past dh 128 on a thread block cluster (every kernel: dh 136 to 1100, the
frame tiles on grid.x, A 8 in one backward launch), each forward and
backward in both modes at "highest" and at "default" against its plain
version, bitwise on a repeat call; the wrappers at dh 264 without a bias; the fused head past D
512 (1024, 2080) and at D 300 (padded), its backward against the plain
backward given its own ReLU decisions (``test_head_wider_matches_plain``),
and its weight stream at two hidden groups bitwise.

The production numerics: each kernel's "default" variant (one TF32 pass)
forward and backward, in both backward modes, against its plain version
(max |err| <= 2e-2 forward and 5e-2 gradients of max(1, max |ref|), the
JAX package's bounds for its "default" kernels, and 5e-3 relative in the
Frobenius norm; the head backward given its own ReLU decisions),
launches counted under ``name@default``; the emit modes'
bf16 ds / comb at "default"; a switch of precision between two dispatches
capturing a second graph; and a bf16 model's graphed steps bitwise equal
to its eager steps.

The Learner's keys and the artifact's graph: an asynchronous save's host
copy lands before the next graphed dispatch writes the state (the file
loads bitwise as the state before it); ``misc.checkify``'s checked step
passes clean on the card, its dispatch mode is active on autograd's
worker thread, and a NaN in the head's backward kernel output raises
naming the kernel; the artifact's CUDA-graph replay bitwise its eager
replay; an artifact capture that fails raises.

Data parallelism across processes: an NCCL world of one rank whose
graphed dispatch (collectives captured) is bitwise its eager steps and
the single-device dispatch, and a gloo world of two ranks on one card
against one process on the global batch (``chip_smoke.py``'s worlds at
narrow widths).

The mesh's model axis, in gloo worlds of two ranks on one card: the
tensor-parallel steps, the ring (``decomposed_mm`` on and off) and a
served flush through the follower against one process
(``chip_smoke.model_axis_gloo_rank``), and the ring alone against the
dense path.
"""

import json

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels build and run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    lim = 1e-4 * max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= lim


def _close_rel(got, ref):
    """max |err| <= 1e-4 * max(1, max|ref|) and |err| / |ref| <= 1e-3
    (Frobenius norms): a zeroed or halved result fails."""
    _close(got, ref)
    d, n = float((got.double() - ref.double()).norm()), float(ref.double().norm())
    assert (d / n if n > 0 else d) <= 1e-3


# widths: 3200 B (a multiple of 16 B), 200 f32 / bf16 / int8 values, 7
# values (28, 14 or 7 B: the byte path for bf16 and int8), a GT5 feats
# row (800 x 128: 200 KB in bf16, several pieces a row)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("width", [(25, 128), (200,), (7,), (800, 128)])
@pytest.mark.parametrize("n_req", [1, 4, 64])
def test_gather_bitwise(dev, dtype, width, n_req):
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.gather import gather_rows, gather_rows_plain

    t = (torch.randn((37, *width), device=dev) * 50).to(dtype)
    base = torch.tensor([0, 5, 5, 36, 1, -3, 99, 2], dtype=torch.int32)  # out of range, negative
    rows = base.repeat(8)[:n_req].to(dev)
    rows = rows.reshape(-1, 2) if n_req > 1 else rows
    _build.reset_counts()
    got = gather_rows(t, rows)
    torch.cuda.synchronize()
    assert _build.launches == {"gather_rows": 1}
    assert torch.equal(got, gather_rows_plain(t, rows))


def test_gather_empty_rows(dev):
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.gather import gather_rows

    t = torch.randn((5, 800, 128), device=dev).to(torch.bfloat16)
    _build.reset_counts()
    got = gather_rows(t, torch.zeros((0, 4), dtype=torch.int32, device=dev))
    assert got.shape == (0, 4, 800, 128) and got.dtype == t.dtype
    assert _build.launches == {}


# (B, H, T, dh, bias): batch row B - 1 has every key masked when B > 1
FLASH_CASES = [(3, 2, 37, 16, False), (3, 2, 70, 40, True), (3, 2, 200, 128, True),
               (3, 2, 45, 20, True), (3, 2, 1, 128, True), (3, 2, 1, 20, False),
               (3, 2, 50, 37, True), (1, 1, 4000, 128, True)]


@pytest.mark.parametrize("B,H,T,dh,bias", FLASH_CASES)
def test_flash(dev, B, H, T, dh, bias):
    from vog_tpu_torch.kernels.attention import flash_attention_fwd, flash_attention_plain

    F = 7
    q, k, v = (torch.randn((B, H, T, dh), device=dev) for _ in range(3))
    mask = (torch.rand((B, T), device=dev) > 0.3).float()
    mask[:, 0] = 1.0
    if B > 1:
        mask[B - 1] = 0.0
    fb = torch.randn((H, F, F), device=dev) if bias else None
    fid = torch.randint(0, F, (T,), dtype=torch.int32, device=dev) if bias else None
    o, lse = flash_attention_fwd(q, k, v, mask, fb, fid)
    ro, rl = flash_attention_plain(q, k, v, mask, fb, fid)
    _close(o, ro)
    n = B - 1 if B > 1 else B  # the lse of the all-masked row is -1e30 + log T
    _close(lse[:n], rl[:n])


# (B, A, T, dh, F): every A at GT5's T and dh (past 8 "highest" takes two
# launches, past 5 "default" does: mm_fwd_wg's groups); dh 20, 37 (not a
# multiple of 4), 64, 128; T = 1, 33 and 45 (not multiples of the 32-key
# tile), 90, 200; frames past 64 (the table read from device memory);
# batch row B - 1 has every key masked when B > 1; the P100 length
MM_CASES = ([(3, a, 200, 128, 5) for a in range(1, 10)]
            + [(3, 5, 45, dh, 5) for dh in (20, 37, 64, 128)]
            + [(3, 3, 1, 128, 5), (3, 3, 33, 128, 5), (3, 1, 33, 16, 5), (3, 8, 90, 64, 5), (1, 5, 4000, 128, 5),
               (3, 5, 200, 128, 80), (2, 9, 45, 37, 70)])


def _mm_fwd_launches(precision, dh, A):
    """The launch counts of one mm forward call: its wrapper's name once a
    group of ``fwd_groups``, and on the "wg" route (a one-pass precision,
    dh <= 128) mm_fwd_wg's too."""
    from vog_tpu_torch.kernels import _build, mm_attention

    groups = len(mm_attention.fwd_groups(A, dh, precision))
    out = {_build.variant(mm_attention.NAME, precision): groups}
    if mm_attention.fwd_route(precision, dh) == "wg":
        out[_build.variant(mm_attention.NAME_FWD_WG, precision)] = groups
    return out


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("B,A,T,dh,F", MM_CASES)
def test_mm(dev, B, A, T, dh, F, precision):
    """The forward against its plain version: at "highest" (mm_fwd, 3xTF32)
    within ``_close_rel``, at "default" (mm_fwd_wg) within the "default"
    bounds; launches counted once a group, and bitwise on a repeat call."""
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.mm_attention import mm_attention_fwd, mm_attention_plain

    H = 2 if B > 1 else 1
    g = torch.Generator(device=dev)
    g.manual_seed(A * 1000 + T + dh)
    qm, km, vm = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(3))
    cn = -3 * torch.rand((B, H, A, T), generator=g, device=dev)
    mask = (torch.rand((B, T), generator=g, device=dev) > 0.3).float()
    mask[:, 0] = 1.0
    if B > 1:
        mask[B - 1] = 0.0
    fb = torch.randn((H, F, F), generator=g, device=dev)
    fid = torch.randint(0, F, (T,), dtype=torch.int32, device=dev, generator=g)
    _build.reset_counts()
    got = mm_attention_fwd(qm, km, vm, cn, mask, fb, fid, precision=precision)
    torch.cuda.synchronize()
    assert _build.launches == _mm_fwd_launches(precision, dh, A)
    ref = mm_attention_plain(qm, km, vm, cn, mask, fb, fid)
    check = _close_rel if precision == "highest" else (lambda a, b: _close_default(a, b, True))
    check(got[0], ref[0])
    n = B - 1 if B > 1 else B  # the all-masked row's stats sit at -1e30 and T
    for x, y in zip(got[1:], ref[1:]):  # row max and denominator
        check(x[:n], y[:n])
    again = mm_attention_fwd(qm, km, vm, cn, mask, fb, fid, precision=precision)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


# the forward's items are 64 flattened (b, t) rows: B * T below, at and just
# past one item, T = 4000 (P100), the GT5 shape, A up to 8 in one launch,
# D = 32 .. 512 (zero-padded to a multiple of 64), Dh = D / 2
@pytest.mark.parametrize("B,T,A,D", [
    (2, 13, 5, 512), (1, 40, 3, 96), (3, 200, 5, 256), (2, 37, 1, 64),
    (1, 63, 5, 512), (1, 64, 3, 512), (1, 65, 1, 512), (2, 4000, 5, 512), (16, 200, 5, 512),
    (2, 37, 6, 256), (3, 45, 8, 96), (2, 1, 1, 32),
])
def test_head(dev, B, T, A, D):
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.grounding_head import fused_grounding_head, grounding_head_plain

    Dh = D // 2
    args = (torch.randn((B, T, D), device=dev), torch.randn((B, A, D), device=dev),
            torch.randn((B, T, D), device=dev), torch.randn((B, A, D), device=dev),
            torch.randn((D, D), device=dev) / D**0.5, torch.randn((D, Dh), device=dev) / D**0.5,
            torch.randn((Dh,), device=dev), torch.randn((Dh,), device=dev), torch.randn((), device=dev))
    _build.reset_counts()
    got = fused_grounding_head(*args)
    torch.cuda.synchronize()
    assert _build.launches == {"fused_grounding_head": 1}  # any A in one launch
    _close_rel(got, grounding_head_plain(*args))
    assert torch.equal(got, fused_grounding_head(*args))  # bitwise on a repeat call


@pytest.mark.parametrize("D,Dh", [(512, 256), (96, 48), (32, 16), (640, 320), (2080, 1040)])
def test_head_fwd_stream_matches_plain(dev, D, Dh):
    """head_fwd_prep's weight stream, bitwise against its plain version
    (past Dh 256: a z1 part a hidden group of 256 columns)."""
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.grounding_head import fwd_stream_floats, fwd_stream_plain

    wx, w1 = torch.randn((D, D), device=dev), torch.randn((D, Dh), device=dev)
    got = torch.full((fwd_stream_floats(D, "highest", Dh),), float("nan"), device=dev)
    fn = _build.function("grounding_head.cu", "vog_head_fwd_prep", [_build.P] * 3 + [_build.I] * 2 + [_build.P])
    assert fn(wx.device.index, wx.data_ptr(), w1.data_ptr(), got.data_ptr(), D, Dh, _build.stream_ptr(wx)) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, fwd_stream_plain(wx, w1))


def test_wrappers_raise_on_bad_input(dev):
    from vog_tpu_torch.kernels.attention import flash_attention
    from vog_tpu_torch.kernels.gather import gather_rows
    from vog_tpu_torch.kernels.grounding_head import fused_grounding_head

    q = torch.randn((1, 1, 8, 16), device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q, q.double(), torch.ones((1, 8), device=dev))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((4, 8), device=dev), torch.zeros(2, dtype=torch.int64, device=dev))
    B, T, A, D = 1, 8, 3, 48
    x = torch.zeros((B, T, D), device=dev)
    y = torch.zeros((B, A, D), device=dev)
    w = torch.zeros((D, D + 1), device=dev)  # Wx not (D, D)
    with pytest.raises(ValueError):
        fused_grounding_head(x, y, x, y, w, w[:, :24].contiguous(), w[0, :24].contiguous(),
                             w[0, :24].contiguous(), w[0, 0])
    with pytest.raises(ValueError):
        flash_attention(q, q, q, torch.ones((1, 8), device=dev), bwd_mode="bogus")


# --------------------------------------------------------------------------
# backward kernels: each against its plain backward (T = 200 and a ragged
# T), and the autograd Function against autograd of the plain forward
# --------------------------------------------------------------------------
def _attn_inputs(dev, B, H, T, dh, F, all_masked=True):
    g = torch.Generator(device=dev)
    g.manual_seed(T * 7 + dh)
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(3))
    mask = (torch.rand((B, T), generator=g, device=dev) > 0.3).float()
    mask[:, 0] = 1.0
    if all_masked:
        mask[B - 1] = 0.0
    fb = torch.randn((H, F, F), generator=g, device=dev)
    fid = torch.randint(0, F, (T,), generator=g, device=dev, dtype=torch.int32)
    return g, q, k, v, mask, fb, fid


@pytest.mark.parametrize("B,H,T,dh,bias", [
    (3, 2, 200, 128, True), (3, 2, 200, 128, False), (3, 2, 45, 40, True), (3, 2, 45, 20, True),
    (3, 2, 1, 128, True), (3, 2, 1, 20, False), (3, 2, 50, 37, True), (1, 1, 4000, 128, True),
])
def test_flash_bwd_kernel(dev, B, H, T, dh, bias):
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    )

    g, q, k, v, mask, fb, fid = _attn_inputs(dev, B, H, T, dh, 10, all_masked=B > 1)
    fb, fid = (fb, fid) if bias else (None, None)
    o, lse = flash_attention_fwd(q, k, v, mask, fb, fid)
    do = torch.randn(o.shape, generator=g, device=dev)
    _build.reset_counts()
    got = flash_attention_bwd(q, k, v, mask, fb, fid, o, lse, do)
    torch.cuda.synchronize()
    assert _build.launches == {"flash_attention_bwd": 1}
    ref = flash_attention_bwd_plain(q, k, v, mask, fb, fid, o, lse, do)
    for a, b in zip(got[:3], ref[:3]):
        _close(a, b)
    if bias:
        _close(got[3], ref[3])
    else:  # one frame: sum_ij ds_ij, zero up to the plain version's rounding
        assert not got[3].any()


def test_flash_no_bias_gt5_one_launch_each(dev):
    """The object transformer's call at GT5 (no frame bias): one launch of
    each wrapper, each within the limits of its plain version."""
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd, flash_attention_plain,
    )

    g, q, k, v, mask, _, _ = _attn_inputs(dev, 16, 4, 200, 128, 10)
    _build.reset_counts()
    o, lse = flash_attention_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    assert _build.launches == {"flash_attention": 1}
    ro, rl = flash_attention_plain(q, k, v, mask)
    _close(o, ro)
    _close(lse[:15], rl[:15])
    do = torch.randn(o.shape, generator=g, device=dev)
    got = flash_attention_bwd(q, k, v, mask, None, None, o, lse, do)
    torch.cuda.synchronize()
    assert _build.launches == {"flash_attention": 1, "flash_attention_bwd": 1}
    ref = flash_attention_bwd_plain(q, k, v, mask, None, None, o, lse, do)
    for a, b in zip(got[:3], ref[:3]):
        _close(a, b)


def _mm_bwd_launches(mode, precision, dh, groups):
    """The launch counts of one mm backward call: its wrapper's name, and
    on the "wg" route (emit at "default", dh <= 128) mm_bwd_dkv_wg's too,
    once a group of args."""
    from vog_tpu_torch.kernels import _build, mm_attention

    name = mm_attention.NAME_BWD if mode == "emit" else mm_attention.NAME_BWD_RECOMPUTE
    out = {_build.variant(name, precision): groups}
    if mm_attention.bwd_route(mode, precision, dh) == "wg":
        out[_build.variant(mm_attention.NAME_WG, precision)] = groups
    return out


# T = 13 (below one 64-key block), 65 (one key past it), 300 (past two of
# the "default" kernel's 128-key blocks: its third block's second
# warpgroup holds no key below T), dh = 40, 128 and 37 (padded to 40),
# every A from 1 to 8, 10 frames and past 64 (the table read from device
# memory); batch row 1 has every key masked.  At "highest" mm_bwd_dkv
# within 1e-4; at "default" the emit route's mm_bwd_dkv_wg within the
# "default" bounds, comb stored in bf16, given the plain forward.
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("A,T,dh,F", [(5, 200, 128, 10), (3, 45, 40, 10), (1, 13, 40, 10), (8, 13, 40, 10),
                                      (1, 65, 40, 10), (8, 65, 40, 10), (1, 200, 128, 10), (8, 200, 128, 10),
                                      (2, 300, 128, 80), (4, 45, 40, 80), (6, 300, 40, 10), (7, 65, 128, 70),
                                      (3, 45, 37, 10)])
def test_mm_bwd_kernel(dev, A, T, dh, F, precision, monkeypatch):
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.mm_attention import (
        mm_attention_bwd, mm_attention_bwd_plain, mm_attention_fwd, mm_attention_plain,
    )

    g, qm, km, vm, mask, fb, fid = _attn_inputs(dev, 2, 3, T, dh, F)
    cn = -3 * torch.rand((2, 3, A, T), generator=g, device=dev)
    high = precision == "highest"
    fwd = mm_attention_fwd(qm, km, vm, cn, mask, fb, fid) if high else mm_attention_plain(qm, km, vm, cn, mask, fb, fid)
    go = torch.randn(fwd[0].shape, generator=g, device=dev)
    seen = []
    real = _build.bmm_wide
    monkeypatch.setattr(_build, "bmm_wide", lambda a, b: seen.append(a.dtype) or real(a, b))
    _build.reset_counts()
    got = mm_attention_bwd(qm, km, vm, cn, mask, fb, fid, *fwd, go, bwd_mode="emit", precision=precision)
    torch.cuda.synchronize()
    assert _build.launches == _mm_bwd_launches("emit", precision, dh, 1)
    assert seen and set(seen) == {torch.float32 if high else torch.bfloat16}  # comb as stored
    for a, b in zip(got, mm_attention_bwd_plain(qm, km, vm, cn, mask, fb, fid, *fwd, go)):
        assert a.dtype == torch.float32
        _close(a, b) if high else _close_default(a, b, False)
    again = mm_attention_bwd(qm, km, vm, cn, mask, fb, fid, *fwd, go, bwd_mode="emit", precision=precision)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # fixed order, no atomics


def _head_inputs(dev, B, T, A, D):
    g = torch.Generator(device=dev)
    g.manual_seed(B * T + D)
    Dh = D // 2
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    return (torch.relu(r(B, T, D)), torch.relu(r(B, A, D)), r(B, T, D) * 0.5, r(B, A, D) * 0.5,
            r(D, D) / D**0.5, r(D, Dh) / D**0.5, r(Dh) * 0.1, r(Dh) / Dh**0.5, r(1)), g


# Dh = D / 2; A = 1 at D = 32, Dh = 16, and T = 1
@pytest.mark.parametrize("B,T,A,D", [(16, 200, 5, 512), (3, 37, 3, 96), (2, 1, 1, 32), (3, 37, 1, 32),
                                     (2, 1, 5, 512)])
def test_head_bwd_kernel(dev, B, T, A, D):
    from chip_smoke import away_from_kinks
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.grounding_head import grounding_head_bwd, grounding_head_bwd_plain

    args, g = _head_inputs(dev, B, T, A, D)
    go, share = away_from_kinks(*args[:7], torch.randn((B, A, T), generator=g, device=dev))
    assert share < 0.05
    _build.reset_counts()
    got = grounding_head_bwd(*args, go)
    torch.cuda.synchronize()
    assert _build.launches == {"fused_grounding_head_bwd": 1}
    for a, b in zip(got, grounding_head_bwd_plain(*args, go)):
        _close(a, b)
    again = grounding_head_bwd(*args, go)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # partials summed in a fixed order


# the narrow backward's tiling edges: items of 64 tokens of one (b, a), so
# B * T and T not multiples of 64 (T 37, 65, 129), A = 1 and A = 8 (two
# launches of 4), D not a multiple of 64 (96, 160: a chunk half past D),
# at both precisions (the "default" variant given its own ReLU decisions)
@pytest.mark.parametrize("B,T,A,D", [(3, 37, 1, 64), (2, 65, 8, 128), (1, 129, 5, 512), (5, 13, 2, 96),
                                     (2, 64, 3, 160)])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_head_bwd_narrow_tiling_edges(dev, B, T, A, D, precision):
    from chip_smoke import away_from_kinks, head_bwd_given
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.grounding_head import arg_groups, grounding_head_bwd, grounding_head_bwd_plain

    args, g = _head_inputs(dev, B, T, A, D)
    go, share = away_from_kinks(*args[:7], torch.randn((B, A, T), generator=g, device=dev))
    assert share < 0.05
    _build.reset_counts()
    scratch = {} if A <= 5 else None
    got = grounding_head_bwd(*args, go, precision=precision, scratch=scratch)
    torch.cuda.synchronize()
    assert _build.launches == {_build.variant("fused_grounding_head_bwd", precision): len(arg_groups(A))}
    if precision == "highest":
        for a, b in zip(got, grounding_head_bwd_plain(*args, go)):
            _close(a, b)
    elif scratch is not None:
        ref, _ = head_bwd_given(args, go, scratch["h"], scratch["dz1"])
        for a, b in zip(got, ref):
            _close_default(a, b.to(a.dtype), False)
    again = grounding_head_bwd(*args, go, precision=precision)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # fixed-order partials, no atomics


@pytest.mark.parametrize("D,Dh", [(512, 256), (96, 48), (32, 16), (160, 208)])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_head_bwd_stream_matches_plain(dev, D, Dh, precision):
    """head_bwd_prep's weight streams (the forward's, then dh's and
    dcross's), bitwise against their plain versions."""
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.grounding_head import bwd_stream_plain, fwd_stream_plain

    wx, w1 = torch.randn((D, D), device=dev), torch.randn((D, Dh), device=dev)
    ref = torch.cat([fwd_stream_plain(wx, w1, precision, natural=True), bwd_stream_plain(wx, w1, precision)])
    got = torch.full_like(ref, float("nan"))
    fn = _build.function("grounding_head.cu", "vog_head_bwd_prep", [_build.P] * 3 + [_build.I] * 2 + [_build.P],
                         precision)
    assert fn(wx.device.index, wx.data_ptr(), w1.data_ptr(), got.data_ptr(), D, Dh, _build.stream_ptr(wx)) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _autograd_pair(fn, plain, args, diff):
    """Gradients of sum(out * w) through ``fn`` and through ``plain``."""
    outs = []
    for f in (fn, plain):
        xs = [a.detach().clone().requires_grad_(i in diff) if a is not None else None
              for i, a in enumerate(args)]
        out = f(*xs)
        w = torch.linspace(-1, 1, out.numel(), device=out.device).reshape(out.shape)
        outs.append(torch.autograd.grad((out * w).sum(), [xs[i] for i in diff]))
    return outs


def test_functions_match_autograd_of_plain(dev):
    from vog_tpu_torch.kernels import attention, grounding_head, mm_attention

    g, q, k, v, mask, fb, fid = _attn_inputs(dev, 2, 2, 21, 16, 4)
    got, ref = _autograd_pair(attention.flash_attention,
                              lambda *a: attention.flash_attention_plain(*a)[0],
                              (q, k, v, mask, fb, fid), (0, 1, 2, 4))
    for a, b in zip(got, ref):
        _close(a, b)
    cn = -3 * torch.rand((2, 2, 3, 21), generator=g, device=dev)
    got, ref = _autograd_pair(mm_attention.mm_shared_qk_attention,
                              lambda *a: mm_attention.mm_attention_plain(*a)[0],
                              (q, k, v, cn, mask, fb, fid), (0, 1, 2, 3, 5))
    for a, b in zip(got, ref):
        _close(a, b)
    args, _ = _head_inputs(dev, 2, 19, 3, 64)
    got, ref = _autograd_pair(grounding_head.fused_grounding_head,
                              grounding_head.grounding_head_plain, args, tuple(range(9)))
    for a, b in zip(got, ref):
        _close(a, b)


# --------------------------------------------------------------------------
# the backward modes that are not the TPU package's default, and the head
# at more args than one launch takes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("A,T,dh,F", [(1, 45, 40, 10), (5, 200, 128, 10), (8, 65, 40, 10), (8, 200, 128, 10),
                                      (5, 1, 128, 10), (5, 1000, 128, 10), (8, 200, 128, 64),
                                      (5, 4000, 128, 40)])
def test_mm_bwd_recompute_kernel(dev, A, T, dh, F):
    """mm_bwd_dkv without comb, then mm_bwd_dq; batch row 1 has every key
    masked (its dq and its share of dfb are 0, as autograd of the plain
    forward gives)."""
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.mm_attention import (
        mm_attention_bwd, mm_attention_bwd_plain, mm_attention_fwd,
    )

    g, qm, km, vm, mask, fb, fid = _attn_inputs(dev, 2, 3, T, dh, F)
    cn = -3 * torch.rand((2, 3, A, T), generator=g, device=dev)
    fwd = mm_attention_fwd(qm, km, vm, cn, mask, fb, fid)
    go = torch.randn(fwd[0].shape, generator=g, device=dev)
    _build.reset_counts()
    got = mm_attention_bwd(qm, km, vm, cn, mask, fb, fid, *fwd, go, bwd_mode="recompute")
    torch.cuda.synchronize()
    assert _build.launches == {"mm_shared_qk_attention_bwd_recompute": 1}
    check = _close_rel if T > 1 else _close  # at T = 1 every ds is 0 up to rounding
    for a, b in zip(got, mm_attention_bwd_plain(qm, km, vm, cn, mask, fb, fid, *fwd, go)):
        check(a, b)
    assert not got[0][1].any()  # the all-masked row's dq
    again = mm_attention_bwd(qm, km, vm, cn, mask, fb, fid, *fwd, go, bwd_mode="recompute")
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # fixed order, no atomics


@pytest.mark.parametrize("B,H,T,dh,bias", [
    (3, 2, 200, 128, True), (3, 2, 200, 128, False), (3, 2, 45, 40, True), (3, 2, 1, 128, True),
    (2, 2, 1000, 128, True), (1, 1, 4000, 128, True),
])
def test_flash_bwd_emit_kernel(dev, B, H, T, dh, bias):
    """flash_bwd_dkv storing ds, then the two products; flash_bwd_dq is not
    launched."""
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    )

    g, q, k, v, mask, fb, fid = _attn_inputs(dev, B, H, T, dh, 10, all_masked=B > 1)
    fb, fid = (fb, fid) if bias else (None, None)
    o, lse = flash_attention_fwd(q, k, v, mask, fb, fid)
    do = torch.randn(o.shape, generator=g, device=dev)
    _build.reset_counts()
    got = flash_attention_bwd(q, k, v, mask, fb, fid, o, lse, do, bwd_mode="emit")
    torch.cuda.synchronize()
    assert _build.launches == {"flash_attention_bwd_emit": 1}
    ref = flash_attention_bwd_plain(q, k, v, mask, fb, fid, o, lse, do)
    for a, b in zip(got[:3], ref[:3]):
        _close(a, b)
    if bias:
        _close(got[3], ref[3])
    else:
        assert not got[3].any()


def test_bwd_modes_agree_through_autograd(dev):
    """Each function's two modes through its autograd Function (the mode
    carried in ctx) against each other and autograd of the plain forward;
    the launches name the mode."""
    from vog_tpu_torch.kernels import _build, attention, mm_attention

    g, q, k, v, mask, fb, fid = _attn_inputs(dev, 2, 2, 300, 128, 10)
    cn = -3 * torch.rand((2, 2, 5, 300), generator=g, device=dev)
    cases = (
        (attention.flash_attention, lambda *a: attention.flash_attention_plain(*a)[0],
         (q, k, v, mask, fb, fid), (0, 1, 2, 4), ("flash_attention_bwd", "flash_attention_bwd_emit")),
        (mm_attention.mm_shared_qk_attention, lambda *a: mm_attention.mm_attention_plain(*a)[0],
         (q, k, v, cn, mask, fb, fid), (0, 1, 2, 3, 5),
         ("mm_shared_qk_attention_bwd_recompute", "mm_shared_qk_attention_bwd")),
    )
    for fn, plain, args, diff, names in cases:
        grads = {}
        for mode, name in zip(("recompute", "emit"), names):
            _build.reset_counts()
            grads[mode], ref = _autograd_pair(lambda *a: fn(*a, bwd_mode=mode), plain, args, diff)
            torch.cuda.synchronize()
            assert _build.launches.get(name) == 1 and sum(
                _build.launches.get(n, 0) for n in names) == 1, _build.launches
            for a, b in zip(grads[mode], ref):
                _close(a, b)
        for a, b in zip(grads["recompute"], grads["emit"]):
            _close_rel(a, b)


@pytest.mark.parametrize("B,T,A,D", [(2, 37, 6, 512), (3, 200, 8, 256), (2, 4000, 8, 512)])
def test_head_more_args_than_a_launch(dev, B, T, A, D):
    from chip_smoke import away_from_kinks
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.grounding_head import (
        fused_grounding_head, grounding_head_bwd, grounding_head_bwd_plain, grounding_head_plain,
    )

    args, g = _head_inputs(dev, B, T, A, D)
    _build.reset_counts()
    out = fused_grounding_head(*args)
    torch.cuda.synchronize()
    assert _build.launches == {"fused_grounding_head": 1}  # the forward takes any A
    _close_rel(out, grounding_head_plain(*args))
    go, share = away_from_kinks(*args[:7], torch.randn((B, A, T), generator=g, device=dev))
    assert share < 0.05
    got = grounding_head_bwd(*args, go)
    torch.cuda.synchronize()
    assert _build.launches == {"fused_grounding_head": 1, "fused_grounding_head_bwd": 2}
    for a, b in zip(got, grounding_head_bwd_plain(*args, go)):
        _close(a, b)


# --------------------------------------------------------------------------
# CUDA graphs: the fused dispatches and the serving forward
# --------------------------------------------------------------------------
def _tiny(dropout=0.1, skip=2, bs=4):
    """A narrow VOGNet at GT5's shapes (SPAT, T = 200), its device tables
    (features and annotations) made from a seed."""
    import numpy as np

    from chip_smoke import random_ann_arrays, serve_cfg
    from vog_tpu_torch.data.ann_store import AnnTables
    from vog_tpu_torch.data.device_store import DeviceFeatureTables

    cfg = serve_cfg()
    m = cfg.mdl
    cfg.ds.prop_dim, cfg.ds.seg_dim = 64, 48
    m.emb_dim, m.lstm_dim, m.vis_dim, m.role_dim, m.n_heads = 32, 16, 32, 8, 2
    m.dropout = dropout
    t = cfg.train
    t.bs, t.lr, t.lr_schedule, t.warmup_steps, t.total_steps = bs, 1e-3, "cosine", 3, 50
    t.skip_nonfinite, t.pos_weight, t.grad_clip = skip, 5.0, 1.0
    n_rows, n_anns = 40, 60
    feats = DeviceFeatureTables.random(cfg, n_rows, seed=0, device="cuda")
    anns, vids = random_ann_arrays(cfg, n_anns, n_rows, seed=1)
    tables = {**feats.tables, **AnnTables.from_arrays(cfg, anns, vids, device="cuda").tables}
    return cfg, tables, n_anns, n_rows


def _stack(batches):
    import numpy as np

    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _state(cfg, seed=3):
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState

    return TrainState.create(cfg, get_model(cfg, 5000, device="cuda", seed=seed, train=True))


def _assert_states_equal(a, b):
    ta, tb = a.tensors(), b.tensors()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_graph_multi_step_bitwise_eager(dev):
    from chip_smoke import make_index_batches
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.train import make_multi_train_step, make_train_step

    cfg, tables, n_anns, n_rows = _tiny()
    batches = make_index_batches(cfg, 6, cfg.train.bs, n_anns, n_rows, seed=2)
    graph, eager = _state(cfg), _state(cfg)
    multi, step = make_multi_train_step(cfg), make_train_step(cfg)
    _, aux0 = multi(graph, _stack(batches[:4]), 7, tables)  # capture, then 4 replays
    _build.reset_counts()
    _, aux1 = multi(graph, _stack(batches[4:]), 7, tables)  # the tail: 2 replays of the same graph
    torch.cuda.synchronize()
    replayed = dict(_build.launches)
    assert len(graph.graphs) == 1
    eager_aux = []
    for i, b in enumerate(batches):
        if i == 4:
            _build.reset_counts()
        eager_aux.append(step(eager, {k: torch.as_tensor(v).cuda() for k, v in b.items()}, 7, tables)[1])
    torch.cuda.synchronize()
    assert replayed == dict(_build.launches) and len(replayed) == 7, (replayed, _build.launches)
    _assert_states_equal(graph, eager)
    for k in aux0:
        got = torch.cat([aux0[k], aux1[k]])
        assert torch.equal(got, torch.stack([a[k] for a in eager_aux])), k
    assert int(graph.step) == 6


def test_graph_freeze_on_nan(dev):
    from chip_smoke import make_index_batches
    from vog_tpu_torch.train import make_multi_train_step, make_train_step

    cfg, tables, n_anns, n_rows = _tiny(skip=0)
    batches = make_index_batches(cfg, 4, cfg.train.bs, n_anns, n_rows, seed=3)
    bad = int(batches[2]["vid_rows"][0, 0])
    for b in batches[:2]:
        b["vid_rows"][b["vid_rows"] == bad] = (bad + 1) % n_rows  # only step 3 reads the row
    graph, eager = _state(cfg), _state(cfg)
    for b in batches[:2]:
        make_train_step(cfg)(eager, {k: torch.as_tensor(v).cuda() for k, v in b.items()}, 0, tables)
    tables["feats"][bad] = float("nan")
    _, aux = make_multi_train_step(cfg)(graph, _stack(batches), 0, tables)
    assert torch.isnan(aux["loss"][2]) and torch.isfinite(aux["loss"][:2]).all()
    _assert_states_equal(graph, eager)
    assert int(graph.step) == 2


def test_graph_multi_eval_bitwise(dev):
    from chip_smoke import make_index_batches
    from vog_tpu_torch.train import make_eval_step, make_multi_eval_step

    cfg, tables, n_anns, n_rows = _tiny()
    batches = make_index_batches(cfg, 5, cfg.train.bs, n_anns, n_rows, seed=4)
    state = _state(cfg)
    got = make_multi_eval_step(cfg)(state, _stack(batches), tables)
    step = make_eval_step(cfg)
    ref = [step(state, {k: torch.as_tensor(v).cuda() for k, v in b.items()}, tables) for b in batches]
    for k in got:
        assert torch.equal(got[k], torch.stack([r[k] for r in ref])), k
    assert float(got["n_pairs"].sum()) > 0


def test_graph_step_with_head_side_stream(dev):
    """B = 16 at T = 200: more row blocks than one wave of the SMs (the
    wide path's row kernel forks its second stream there,
    grounding_head.cu §launch_bwd; the narrow path's persistent row kernel
    walks them), and the captured step's gradients are bitwise the eager
    step's."""
    from chip_smoke import make_index_batches
    from vog_tpu_torch.train import make_multi_train_step, make_train_step

    cfg, tables, n_anns, n_rows = _tiny(bs=16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert sms // -(-200 // 16) < 16  # the rows past the first wave go to the second stream
    batches = make_index_batches(cfg, 2, 16, n_anns, n_rows, seed=5)
    graph, eager = _state(cfg), _state(cfg)
    make_multi_train_step(cfg)(graph, _stack(batches), 1, tables)
    step = make_train_step(cfg)
    for b in batches:
        step(eager, {k: torch.as_tensor(v).cuda() for k, v in b.items()}, 1, tables)
    torch.cuda.synchronize()
    for (k, p), q in zip(graph.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(p.grad, q.grad), k
    _assert_states_equal(graph, eager)


def test_graphed_predictor_equals_eager(dev):
    import numpy as np

    from chip_smoke import make_requests
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.serve import Predictor

    cfg, tables, n_anns, n_rows = _tiny()
    eager = Predictor(cfg, None, 5000, tables=tables, device="cuda", cuda_graphs=False)
    sd = eager.model.state_dict()
    graphed = Predictor(cfg, sd, 5000, tables=tables, device="cuda")
    reqs = make_requests(cfg, 8, n_rows, 5000, seed=6)
    for bucket in (1, 2, 4):
        batch = {k: np.stack([r[k] for r in reqs[:bucket]]) for k in reqs[0]}
        batch["batch_mask"] = np.ones((bucket,), np.uint8)
        ref = eager(batch)
        pend = [graphed.dispatch(batch) for _ in range(graphed.ring_depth)]  # the whole ring in flight
        _build.reset_counts()
        outs = [graphed.fetch(p) for p in pend] + [graphed(batch)]
        assert _build.launches == {"gather_rows": 2, "flash_attention": 1, "mm_shared_qk_attention": 1,
                                   "fused_grounding_head": 1}, _build.launches
        for out in outs:
            assert set(out) == set(ref)
            for k in ref:
                assert np.array_equal(out[k], ref[k]), (bucket, k)
    assert len(graphed.graphs) == 3


def test_dropout_bits_cpu_equal_card(dev):
    from vog_tpu_torch.model.transformer import dropout_keep, dropout_key

    for seed, step, micro, site, shape in [(0, 0, 0, 0, (7, 33)), (5, 123, 1, 3, (16, 200, 512)),
                                           (2**40 + 1, 2**31 - 1, 2, 9, (80, 200, 2048))]:
        masks = [dropout_keep(dropout_key(seed, torch.tensor(step, dtype=torch.int32, device=d), micro),
                              site, shape, 0.1) for d in ("cpu", dev)]
        assert torch.equal(masks[0], masks[1].cpu()), (seed, step, micro, site)


# --------------------------------------------------------------------------
# the wide instances: head dims past 128, more frames than a block's shared
# table (65, 80, 160), more args than a launch (9, 12)
# --------------------------------------------------------------------------
# (kernel, dh, F, A): flash at each head-dim instance and past 64 frames; mm
# past 64 frames, and in groups of args (9 -> 5 + 4, 12 -> 6 + 6).  Past dh
# 128 all four kernels (the forward and both backward kernels of flash and
# of mm) are the cluster instances (csrc/cluster.cuh): 2 slices at dh
# 136-256, 3 at 300, 4 at 385 (padded to 388) and 512, 8 at 1024, 9 at 1100
# (two passes of 5 blocks)
WIDE_CASES = [("flash", 64, 10, None), ("flash", 200, 10, None), ("flash", 256, 65, None),
              ("flash", 40, 80, None), ("flash", 256, 160, None), ("flash", 64, 160, None),
              ("mm", 200, 10, 5), ("mm", 256, 80, 5), ("mm", 128, 65, 3), ("mm", 40, 160, 2),
              ("mm", 64, 10, 9), ("mm", 256, 10, 12),
              # past 256: 4 slices, 3 (dh 300 not a multiple of 8), 8 (dh 1024)
              ("flash", 512, 10, None), ("flash", 300, 80, None), ("flash", 1024, 2, None),
              ("mm", 512, 10, 5), ("mm", 300, 80, 9), ("mm", 1024, 10, 2),
              # the cluster instances' edges: dh 136, dh 385 (padded), past 1024 (two passes), A 1
              ("flash", 136, 10, None), ("flash", 385, 65, None), ("flash", 1100, 160, None),
              ("mm", 136, 65, 1), ("mm", 385, 160, 5), ("mm", 1100, 10, 12), ("mm", 1024, 65, 9),
              # the mm backward's: A 8 in one launch (dh 385; dh 1100, two passes), the dq kernel's frame
              # tiles on grid.x (F 65 over 4 blocks, F 160 over 2: two groups of clusters)
              ("mm", 385, 65, 8), ("mm", 1100, 160, 8), ("mm", 256, 160, 3)]


# and with every row matrix (q, k, v and the output gradient) a contiguous
# view one float past a 16-byte boundary: past dh 128 the cluster kernels'
# TMA needs 16-byte base addresses, so the wrappers copy such a view
# (``pad_cols``), also where dh needs no padding (388, 256, 260)
MISALIGNED_CASES = [("flash", 388, 10, None), ("flash", 256, 65, None), ("flash", 300, 10, None),
                    ("mm", 260, 10, 5), ("mm", 1100, 10, 2)]


def _misaligned(t):
    """``t``'s values in a contiguous view that starts one float past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("kernel,dh,F,A,misaligned",
                         [c + (False,) for c in WIDE_CASES] + [c + (True,) for c in MISALIGNED_CASES],
                         ids=["-".join(map(str, c)) for c in WIDE_CASES]
                         + ["-".join(map(str, c)) + "-misaligned" for c in MISALIGNED_CASES])
def test_wide_instance_matches_plain(dev, kernel, dh, F, A, misaligned, precision):
    """Each wide instance's forward and its backward in both modes against
    the plain versions (at "highest": ``_close`` / ``_close_rel``, a batch
    row with every key masked; at "default": ``_close_default``), launches
    counted once a group of args (the mm forward's ``fwd_groups``), and
    every output bitwise on a repeat call (frame sums and the cluster's
    score partials in a fixed order, no atomics); ``misaligned``: the row
    matrices are ``_misaligned`` views."""
    from vog_tpu_torch.kernels import _build, attention, mm_attention

    high = precision == "highest"
    rows = _misaligned if misaligned else (lambda t: t)
    T = 3 * F + 5 if F > 10 else 77
    g, q, k, v, mask, fb, fid = _attn_inputs(dev, 2, 2, T, dh, F, all_masked=high)
    q, k, v = rows(q), rows(k), rows(v)
    n = 1 if high else 2  # rows checked of the forward's statistics (the all-masked row's sit at -1e30)
    fwd_check = _close if high else (lambda a, b: _close_default(a, b, True))
    bwd_check = _close if high else (lambda a, b: _close_default(a, b, False))
    if kernel == "flash":
        ro, rl = attention.flash_attention_plain(q, k, v, mask, fb, fid)
        _build.reset_counts()
        o, lse = attention.flash_attention_fwd(q, k, v, mask, fb, fid, precision=precision)
        torch.cuda.synchronize()
        assert _build.launches == {_build.variant("flash_attention", precision): 1}
        assert all(torch.equal(a, b) for a, b in zip(
            (o, lse), attention.flash_attention_fwd(q, k, v, mask, fb, fid, precision=precision)))
        fwd_check(o, ro)
        fwd_check(lse[:n], rl[:n])
        do = rows(torch.randn(o.shape, generator=g, device=dev))
        ref = attention.flash_attention_bwd_plain(q, k, v, mask, fb, fid, ro, rl, do)
        for mode, name in (("recompute", "flash_attention_bwd"), ("emit", "flash_attention_bwd_emit")):
            _build.reset_counts()
            got = attention.flash_attention_bwd(q, k, v, mask, fb, fid, ro, rl, do, bwd_mode=mode,
                                                precision=precision)
            torch.cuda.synchronize()
            assert _build.launches == {_build.variant(name, precision): 1}
            for a, b in zip(got, ref):
                bwd_check(a, b)
            again = attention.flash_attention_bwd(q, k, v, mask, fb, fid, ro, rl, do, bwd_mode=mode,
                                                  precision=precision)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
        return
    groups = len(mm_attention.bwd_groups(A, dh))  # cluster_plan's bwd_groups past dh 128
    qm = rows(q * dh ** -0.5)
    cn = -3 * torch.rand((2, 2, A, T), generator=g, device=dev)
    rf = mm_attention.mm_attention_plain(qm, k, v, cn, mask, fb, fid)
    _build.reset_counts()
    out = mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid, precision=precision)
    torch.cuda.synchronize()
    assert _build.launches == _mm_fwd_launches(precision, dh, A)  # mm_fwd_wg's too at "default", dh <= 128
    assert all(torch.equal(a, b) for a, b in zip(
        out, mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid, precision=precision)))
    (_close_rel if high else fwd_check)(out[0], rf[0])
    for x, y in zip(out[1:], rf[1:]):
        fwd_check(x[:n], y[:n])
    go = rows(torch.randn(rf[0].shape, generator=g, device=dev))
    ref = mm_attention.mm_attention_bwd_plain(qm, k, v, cn, mask, fb, fid, *rf, go)
    for mode in ("emit", "recompute"):
        _build.reset_counts()
        got = mm_attention.mm_attention_bwd(qm, k, v, cn, mask, fb, fid, *rf, go, bwd_mode=mode,
                                            precision=precision)
        torch.cuda.synchronize()
        assert _build.launches == _mm_bwd_launches(mode, precision, dh, groups)
        for a, b in zip(got, ref):
            (_close_rel if high else bwd_check)(a, b)
        again = mm_attention.mm_attention_bwd(qm, k, v, cn, mask, fb, fid, *rf, go, bwd_mode=mode,
                                              precision=precision)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_wrappers_raise_past_the_widest_head_dim(dev):
    """Past the widest instance the wrappers do not raise: at dh 264 (the
    cluster instances, three 128-column blocks) they launch their kernel,
    which matches the plain version."""
    from vog_tpu_torch.kernels import _build, attention, mm_attention

    g = torch.Generator(device=dev)
    g.manual_seed(264)
    q, k, v = (torch.randn((1, 1, 8, 264), generator=g, device=dev) for _ in range(3))
    mask = torch.ones((1, 8), device=dev)
    _build.reset_counts()
    o, lse = attention.flash_attention_fwd(q, k, v, mask)
    ro, rl = attention.flash_attention_plain(q, k, v, mask)
    _close_rel(o, ro)
    _close(lse, rl)
    fb = torch.zeros((1, 1, 1), device=dev)
    fid = torch.zeros((8,), dtype=torch.int32, device=dev)
    cn = -torch.rand((1, 1, 2, 8), generator=g, device=dev)
    out = mm_attention.mm_attention_fwd(q * 264 ** -0.5, k, v, cn, mask, fb, fid)
    _close_rel(out[0], mm_attention.mm_attention_plain(q * 264 ** -0.5, k, v, cn, mask, fb, fid)[0])
    do = torch.randn(o.shape, generator=g, device=dev)  # and the backward without a bias, both modes
    ref = attention.flash_attention_bwd_plain(q, k, v, mask, None, None, ro, rl, do)
    for mode in ("recompute", "emit"):
        got = attention.flash_attention_bwd(q, k, v, mask, None, None, o, lse, do, bwd_mode=mode)
        for a, b in zip(got[:3], ref[:3]):
            _close_rel(a, b)
    torch.cuda.synchronize()
    assert _build.launches == {"flash_attention": 1, "mm_shared_qk_attention": 1, "flash_attention_bwd": 1,
                               "flash_attention_bwd_emit": 1}


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("B,T,A,D", [(2, 45, 5, 1024), (1, 37, 6, 2080), (2, 45, 3, 300)])
def test_head_wider_matches_plain(dev, B, T, A, D, precision):
    """The fused head past D 512 (its wide path: the cross tile in K
    slices, a pass a hidden group of 256, the row kernel's column groups
    over staged K slices) and at D 300 (padded to 320): the forward against
    the plain version, the 9 gradients against the plain backward given
    the kernel's ReLU decisions (``chip_smoke.head_bwd_given``, fp64; a
    kink mask would drop most rows at these widths), one forward launch and
    one backward launch a group of at most 5 args."""
    from chip_smoke import head_bwd_given, tf32
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels.grounding_head import (
        arg_groups, grounding_head_bwd, grounding_head_fwd, grounding_head_plain,
    )

    high = precision == "highest"
    args, g = _head_inputs(dev, B, T, A, D)
    gh = torch.randn((B, A, T), generator=g, device=dev)
    ref = grounding_head_plain(*args)
    _build.reset_counts()
    with tf32(not high):
        got = grounding_head_fwd(*args, precision=precision)
        scratch = {} if A <= 5 else None
        grads = grounding_head_bwd(*args, gh, precision=precision, scratch=scratch)
    torch.cuda.synchronize()
    assert _build.launches == {_build.variant("fused_grounding_head", precision): 1,
                               _build.variant("fused_grounding_head_bwd", precision): len(arg_groups(A))}
    (_close_rel if high else (lambda a, b: _close_default(a, b, True)))(got, ref)
    if scratch is None:  # two groups: the decisions of each are not kept; the first group's args alone
        a1 = arg_groups(A)[0][1]
        sub = (args[0], args[1][:, :a1].contiguous(), args[2], args[3][:, :a1].contiguous(), *args[4:])
        scratch = {}
        with tf32(not high):
            grads = grounding_head_bwd(*sub, gh[:, :a1].contiguous(), precision=precision, scratch=scratch)
        args, gh = sub, gh[:, :a1].contiguous()
    want, flips = head_bwd_given(args, gh, scratch["h"], scratch["dz1"])
    assert max(flips) < 1e-3
    for a, b in zip(grads, want):
        (_close if high else (lambda x, y: _close_default(x, y, False)))(a, b.float())


# --------------------------------------------------------------------------
# the production numerics: "default" (one TF32 pass) variants, bf16 emit
# --------------------------------------------------------------------------
def _close_default(got, ref, fwd):
    """A "default" kernel against its plain version at "highest": max |err|
    <= 2e-2 (forward) or 5e-2 (gradients) of max(1, max |ref|), the JAX
    package's bounds for its "default" kernels (relative max-diff, as its
    tools/verify_kernels.py measures it), and |err| / |ref| <= 5e-3
    (Frobenius)."""
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= (2e-2 if fwd else 5e-2) * scale
    d, n = float((got.double() - ref.double()).norm()), float(ref.double().norm())
    assert (d / n if n > 0 else d) <= 5e-3


@pytest.mark.parametrize("kernel,mode", [("flash", "recompute"), ("flash", "emit"), ("mm", "emit"),
                                         ("mm", "recompute"), ("head", None)])
def test_default_variant_matches_plain(dev, kernel, mode):
    """Each kernel's "default" variant, forward and backward (both modes;
    emit stores its ds / comb in bf16), against its plain version, with
    its launches counted under the variant's name; the mm backward fed by
    the "default" forward's outputs (mm_fwd_wg's row max and denominator)."""
    from vog_tpu_torch.kernels import _build, attention, grounding_head, mm_attention

    d = "default"
    if kernel == "head":
        from chip_smoke import head_bwd_given

        args, g = _head_inputs(dev, 3, 37, 3, 96)
        go = torch.randn((3, 3, 37), generator=g, device=dev)
        _build.reset_counts()
        out = grounding_head.grounding_head_fwd(*args, precision=d)
        scratch = {}
        got = grounding_head.grounding_head_bwd(*args, go, precision=d, scratch=scratch)
        torch.cuda.synchronize()
        assert _build.launches == {"fused_grounding_head@default": 1, "fused_grounding_head_bwd@default": 1}
        _close_default(out, grounding_head.grounding_head_plain(*args), True)
        # given the kernel's own ReLU decisions: one TF32 pass puts a few
        # pre-activations across a kink from fp64's, which flips whole terms
        ref, _ = head_bwd_given(args, go, scratch["h"], scratch["dz1"])
    else:
        g, q, k, v, mask, fb, fid = _attn_inputs(dev, 3, 2, 45, 40, 5)
        mask[2] = 1.0  # no all-masked row: its outputs sit at the masked fill
        if kernel == "flash":
            ro, rl = attention.flash_attention_plain(q, k, v, mask, fb, fid)
            do = torch.randn(ro.shape, generator=g, device=dev)
            _build.reset_counts()
            o, lse = attention.flash_attention_fwd(q, k, v, mask, fb, fid, precision=d)
            got = attention.flash_attention_bwd(q, k, v, mask, fb, fid, ro, rl, do, bwd_mode=mode, precision=d)
            name = "flash_attention_bwd" + ("_emit" if mode == "emit" else "")
            torch.cuda.synchronize()
            assert _build.launches == {"flash_attention@default": 1, f"{name}@default": 1}
            _close_default(o, ro, True)
            _close_default(lse, rl, True)
            ref = attention.flash_attention_bwd_plain(q, k, v, mask, fb, fid, ro, rl, do)
        else:
            cn = -3 * torch.rand((3, 2, 4, 45), generator=g, device=dev)
            rf = mm_attention.mm_attention_plain(q * 0.2, k, v, cn, mask, fb, fid)
            go = torch.randn(rf[0].shape, generator=g, device=dev)
            _build.reset_counts()
            out = mm_attention.mm_attention_fwd(q * 0.2, k, v, cn, mask, fb, fid, precision=d)
            # the backward fed by the "default" forward's out, row max and denominator (mm_fwd_wg's)
            got = mm_attention.mm_attention_bwd(q * 0.2, k, v, cn, mask, fb, fid, *out, go, bwd_mode=mode,
                                                precision=d)
            torch.cuda.synchronize()
            assert _build.launches == {**_mm_fwd_launches(d, 40, 4), **_mm_bwd_launches(mode, d, 40, 1)}
            for x, y in zip(out, rf):
                _close_default(x, y, True)
            ref = mm_attention.mm_attention_bwd_plain(q * 0.2, k, v, cn, mask, fb, fid, *rf, go)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        _close_default(a, b.to(a.dtype), False)


@pytest.mark.parametrize("kernel", ["flash", "mm"])
def test_default_emit_stores_bf16(dev, kernel, monkeypatch):
    """At "default" the emit modes' (T, T) score gradient is bf16 (half the
    bytes), and the products over it widen it to fp32."""
    from vog_tpu_torch.kernels import _build, attention, mm_attention

    seen = []
    real = _build.bmm_wide
    monkeypatch.setattr(_build, "bmm_wide", lambda a, b: seen.append(a.dtype) or real(a, b))
    g, q, k, v, mask, fb, fid = _attn_inputs(dev, 2, 2, 200, 128, 10)
    for prec, want in (("highest", torch.float32), ("default", torch.bfloat16)):
        seen.clear()
        if kernel == "flash":
            o, lse = attention.flash_attention_fwd(q, k, v, mask, fb, fid, precision=prec)
            got = attention.flash_attention_bwd(q, k, v, mask, fb, fid, o, lse, torch.ones_like(o),
                                                bwd_mode="emit", precision=prec)
        else:
            cn = -torch.rand((2, 2, 5, 200), generator=g, device=dev)
            fwd = mm_attention.mm_attention_fwd(q * 0.1, k, v, cn, mask, fb, fid, precision=prec)
            got = mm_attention.mm_attention_bwd(q * 0.1, k, v, cn, mask, fb, fid, *fwd,
                                                torch.ones_like(fwd[0]), bwd_mode="emit", precision=prec)
        torch.cuda.synchronize()
        assert seen and set(seen) == {want} and all(x.dtype == torch.float32 for x in got)


def test_graph_recaptures_on_precision_switch(dev):
    """A captured step records the kernels' variant and cuBLAS's TF32
    switch: after a switch of ``misc.matmul_precision`` the next dispatch
    captures anew (the "default" variants launch), and switching back
    replays the first capture."""
    from chip_smoke import make_index_batches
    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.train import make_multi_train_step

    cfg, tables, n_anns, n_rows = _tiny()
    batches = make_index_batches(cfg, 6, cfg.train.bs, n_anns, n_rows, seed=9)
    state, multi = _state(cfg), make_multi_train_step(cfg)
    try:
        for i, prec in enumerate(("highest", "default", "highest")):
            cfg.misc.matmul_precision = prec
            apply_matmul_precision(cfg)
            _build.reset_counts()
            _, aux = multi(state, _stack(batches[2 * i:2 * i + 2]), 0, tables)
            torch.cuda.synchronize()
            assert torch.isfinite(aux["loss"]).all()
            assert len(state.graphs) == min(i + 1, 2)
            names = set(_build.launches)
            assert ("flash_attention@default" in names) == (prec == "default"), names
            assert ("flash_attention" in names) == (prec == "highest"), names
    finally:
        cfg.misc.matmul_precision = "highest"
        apply_matmul_precision(cfg)


def test_bf16_model_trains_and_serves_on_the_card(dev):
    """The production numerics (bf16 activations, "default") on the card:
    a graphed dispatch bitwise equal to its eager steps, fp32 parameters
    and logits, and the "default" kernels launched."""
    import numpy as np

    from chip_smoke import make_index_batches, make_requests
    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.train import make_multi_train_step, make_train_step

    cfg, tables, n_anns, n_rows = _tiny()
    cfg.mdl.dtype, cfg.misc.matmul_precision = "bfloat16", "default"
    try:
        batches = make_index_batches(cfg, 3, cfg.train.bs, n_anns, n_rows, seed=10)
        graph, eager = _state(cfg), _state(cfg)
        _build.reset_counts()
        make_multi_train_step(cfg)(graph, _stack(batches), 0, tables)
        step = make_train_step(cfg)
        for b in batches:
            step(eager, {k: torch.as_tensor(v).cuda() for k, v in b.items()}, 0, tables)
        torch.cuda.synchronize()
        _assert_states_equal(graph, eager)
        assert all(t.dtype == torch.float32 for t in graph.tensors().values() if t.is_floating_point())
        assert {"flash_attention_bwd@default", "mm_shared_qk_attention_bwd@default",
                "fused_grounding_head_bwd@default"} <= set(_build.launches), _build.launches
        pred = Predictor(cfg, graph.model.state_dict(), 5000, tables=tables, device="cuda")
        reqs = make_requests(cfg, 2, n_rows, 5000, seed=11)
        batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
        batch["batch_mask"] = np.ones((2,), np.uint8)
        out = pred(batch)
        assert out["scores"].dtype == np.float32 and np.isfinite(out["pred_score"]).all()
    finally:
        cfg.misc.matmul_precision = "highest"
        apply_matmul_precision(cfg)


def test_capture_failure_raises(dev, monkeypatch):
    """A host read inside the step fails its capture: the dispatch raises,
    runs nothing eagerly in its place, and leaves the state as it was.
    (Last in the file: a failed capture is the one test that leaves the
    context's error state to the tests after it.)"""
    from chip_smoke import make_index_batches
    from vog_tpu_torch.train import make_multi_train_step
    from vog_tpu_torch.train import state as st

    cfg, tables, n_anns, n_rows = _tiny()
    batches = make_index_batches(cfg, 2, cfg.train.bs, n_anns, n_rows, seed=7)
    state = _state(cfg)
    real = st.compute_loss

    def reads_the_host(*a, **k):
        loss, aux = real(*a, **k)
        float(loss.detach())  # a host read: legal eagerly, not under capture
        return loss, aux

    monkeypatch.setattr(st, "compute_loss", reads_the_host)
    before = state.snapshot()
    with pytest.raises(RuntimeError):
        make_multi_train_step(cfg)(state, _stack(batches), 0, tables)
    torch.cuda.synchronize()
    assert not state.graphs
    for k, v in state.tensors().items():
        assert torch.equal(v, before[k]), k


# -- the Learner on the card ---------------------------------------------------


def _learner_argv(tmp_path, uid, *extra):
    """A narrow model of the production recipe (configs/gt5_production.yml:
    bf16, "default", half_feats, device and annotation tables, index-only)
    on a fixture written by the port, K = 3, E = 2."""
    from pathlib import Path

    from vog_tpu_torch.data.fixtures import generate_fixture

    data = tmp_path / "data"
    if not (data / "featpack.bin").exists():
        generate_fixture(data, n_train=24, n_valid=8, n_test=4, prop_dim=64, seg_dim=48, glove_dim=32, seed=1)
    yml = Path(__file__).resolve().parents[1] / "configs" / "gt5_production.yml"
    return [uid, f"--cfg={yml}", f"--ds.data_dir={data}", f"--misc.tmp_path={tmp_path / 'tmp'}",
            "--ds.prop_dim=64", "--ds.seg_dim=48", "--ds.glove_dim=32", "--mdl.emb_dim=32", "--mdl.lstm_dim=16",
            "--mdl.vis_dim=32", "--mdl.role_dim=8", "--mdl.n_heads=2", "--train.bs=2", "--train.epochs=2",
            "--train.steps_per_dispatch=3", "--train.eval_batches_per_dispatch=2", "--misc.progress=off", *extra]


def test_learner_fit_replays_graphs_bitwise_eager_steps(dev, tmp_path):
    """An epoch of ``Learner.fit`` on the card runs its dispatches as
    captured graphs (train and eval), launches every "default" kernel, and
    ends bitwise at the state of the same batches as eager single steps."""
    import math

    from vog_tpu_torch.cli.train import build
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.train import make_train_step

    try:
        fit, _ = build(_learner_argv(tmp_path, "graphs", "--train.epochs=1"))
        assert fit.device.type == "cuda" and "ann_i32" in fit._tables
        _build.reset_counts()
        m = fit.fit()
        kinds = {k[0] for k in fit.state.graphs}
        assert kinds == {"train", "eval"} and math.isfinite(m["val_loss"])
        launched = {k for k, v in _build.launches.items() if v > 0}
        assert {f"{n}@default" for n in ("flash_attention", "flash_attention_bwd", "mm_shared_qk_attention",
                                         "mm_shared_qk_attention_bwd", "fused_grounding_head",
                                         "fused_grounding_head_bwd")} | {"gather_rows"} <= launched

        eager, _ = build(_learner_argv(tmp_path, "eager", "--train.epochs=1"))
        step = make_train_step(eager.cfg)
        for stacked in eager.data.train_dl:
            for i in range(len(stacked["batch_mask"])):
                step(eager.state, {k: torch.as_tensor(v[i]).cuda() for k, v in stacked.items()}, eager.seed,
                     eager._tables)
        _assert_states_equal(fit.state, eager.state)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def test_learner_resume_on_the_card_is_bitwise(dev, tmp_path):
    """SIGTERM after a dispatch, then ``train.resume``: the card's final
    state equals the uninterrupted run's, bitwise."""
    import os
    import signal

    from vog_tpu_torch.cli.train import build

    try:
        full, _ = build(_learner_argv(tmp_path, "full"))
        full.fit()
        cut, _ = build(_learner_argv(tmp_path, "cut"))
        orig, calls = cut._train_multi, {"n": 0}

        def step(*a, **kw):
            out = orig(*a, **kw)
            calls["n"] += 1
            if calls["n"] == 6:  # epoch 1's second dispatch (an epoch: 12 batches, 4 dispatches)
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        cut._train_multi = step
        cut.fit()
        assert cut._preempted and (cut.epoch, cut.batch_in_epoch) == (1, 6)
        res, _ = build(_learner_argv(tmp_path, "cut", "--train.resume=true"))
        res.fit(epochs=1)
        _assert_states_equal(res.state, full.state)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def test_async_save_copy_lands_before_the_next_dispatch(dev, tmp_path):
    """``save(blocking=False)`` queues the state's host copy; the next
    graphed dispatch, which writes the state in place, runs after it: the
    file loads bitwise as the state before that dispatch."""
    from vog_tpu_torch.cli.train import build

    try:
        lrn, _ = build(_learner_argv(tmp_path, "async", "--train.epochs=1", "--train.async_ckpt=true"))
        lrn.fit()  # captures the graphs
        want = lrn.state.snapshot()
        stacked = next(iter(lrn.data.train_dl))
        lrn.save("mid", blocking=False)
        lrn._train_multi(lrn.state, stacked, lrn.seed, lrn._tables)  # at once: no wait for the copy
        moved = lrn.state.snapshot()
        assert any(not torch.equal(moved[k], v) for k, v in want.items())
        lrn.load(tag="mid")
        got = lrn.state.tensors()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        rec = [r for r in map(json.loads, open(lrn.events_log)) if r["event"] == "save"][-1]
        assert rec["tag"] == "mid" and rec["blocking"] is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def test_checkify_catches_a_backward_kernels_nan(dev, monkeypatch):
    """Under ``misc.checkify`` on the card: a clean checked step passes
    (no false alarm from the kernels or cuDNN); the dispatch mode is active
    on autograd's worker thread, where the head's backward kernel runs; a
    NaN in that kernel's output, written where no aten op sees it, raises
    naming the kernel."""
    import threading

    from chip_smoke import make_index_batches
    from torch.utils._python_dispatch import _disable_current_modes

    from vog_tpu_torch.kernels import grounding_head
    from vog_tpu_torch.train.checkify import CheckifyError, make_checked_train_step

    cfg, tables, n_anns, n_rows = _tiny(dropout=0.0)
    batches = make_index_batches(cfg, 2, cfg.train.bs, n_anns, n_rows, seed=5)
    state = _state(cfg)
    step = make_checked_train_step(cfg)
    _, aux = step(state, _stack(batches[:1]), 0, tables)
    assert torch.isfinite(aux["loss"]).all()
    real, seen = grounding_head.grounding_head_bwd, {}

    def poisoned(*a, **kw):
        grads = real(*a, **kw)
        seen.update(thread=threading.current_thread(), modes=torch._C._len_torch_dispatch_stack())
        with _disable_current_modes():  # as a raw kernel writes: no aten op the checks see
            grads[4].view(-1)[0] = float("nan")
        return grads

    monkeypatch.setattr(grounding_head, "grounding_head_bwd", poisoned)
    with pytest.raises(CheckifyError, match="kernel fused_grounding_head_bwd in the backward of "
                                            "FusedGroundingHeadBackward"):
        step(state, _stack(batches[1:]), 0, tables)
    assert seen["thread"] is not threading.main_thread() and seen["modes"] > 0


def test_graphed_artifact_equals_its_eager_replay(dev, tmp_path):
    """A narrow model's artifact with tables, on the card: its CUDA-graph
    replay (captured at the first request, then replayed) is bitwise its
    eager replay, with the whole output ring in flight, and launches the
    four forward kernels each replay."""
    import numpy as np

    from chip_smoke import make_requests
    from vog_tpu_torch.export import ExportedPredictor, export_predictor
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.serve import Predictor

    cfg, tables, _, n_rows = _tiny()
    feats = {k: v for k, v in tables.items() if k in ("feats", "seg", "feats_scale", "seg_scale")}
    live = Predictor(cfg, None, 5000, tables=feats, device="cuda", cuda_graphs=False)
    path = export_predictor(live, 4, tmp_path / "art", with_tables=True)
    eager, graphed = ExportedPredictor(path, cuda_graphs=False), ExportedPredictor(path)
    assert graphed.cuda_graphs and not eager.cuda_graphs
    reqs = make_requests(cfg, 4, n_rows, 5000, seed=2)
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    batch["batch_mask"] = np.ones((4,), np.uint8)
    ds = cfg.ds
    batch["targets"] = np.zeros((4, ds.num_cmp, ds.max_srl_args, ds.num_frms, ds.num_prop_per_frm), np.uint8)
    ref = eager(batch)
    graphed(batch)  # the capture
    pend = [graphed.dispatch(batch) for _ in range(graphed.ring_depth)]
    _build.reset_counts()
    outs = [graphed.fetch(p) for p in pend] + [graphed(batch)]
    assert _build.launches == {"gather_rows": 2, "flash_attention": 1, "mm_shared_qk_attention": 1,
                               "fused_grounding_head": 1}, _build.launches
    for out in outs:
        for k in ref:
            assert np.array_equal(out[k], ref[k]), k
    assert len(graphed.graphs) == 1 and not eager.graphs


# --------------------------------------------------------------------------
# the device guard, the forward ops, the exported program
# --------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_wrappers_bitwise_on_a_fresh_thread(dev, precision):
    """Every wrapper's forward and backward (through autograd, both modes of
    flash and mm) from a fresh thread is bitwise the main thread's."""
    from chip_smoke import fresh_thread_mismatches, tf32, thread_calls

    with tf32(precision == "default"):
        assert fresh_thread_mismatches(thread_calls(B=2, H=2, T=37, dh=40, F=3, A=5, D=64)) == []


def test_forward_ops_match_plain(dev):
    """The four ``torch.ops.vog`` forward ops on CUDA tensors launch their
    kernels (counted) and agree with the plain versions."""
    from vog_tpu_torch.kernels import _build, attention, gather, grounding_head, mm_attention

    g = torch.Generator(device=dev)
    g.manual_seed(9)
    table = torch.randn((30, 7, 128), generator=g, device=dev).to(torch.bfloat16)
    rows = torch.randint(-2, 33, (3, 4), generator=g, device=dev, dtype=torch.int32)
    _build.reset_counts()
    assert torch.equal(torch.ops.vog.gather_rows(table, rows), gather.gather_rows_plain(table, rows))
    B, H, T, dh, F, A, D = 2, 2, 45, 32, 3, 4, 64
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(3))
    mask = torch.ones((B, T), device=dev)
    fb = torch.randn((H, F, F), generator=g, device=dev)
    fid = torch.randint(0, F, (T,), generator=g, device=dev, dtype=torch.int32)
    for got, ref in zip(torch.ops.vog.flash_attention_fwd(q, k, v, mask, fb, fid, "highest"),
                        attention.flash_attention_plain(q, k, v, mask, fb, fid)):
        _close(got, ref)
    cn = -torch.rand((B, H, A, T), generator=g, device=dev)
    for got, ref in zip(torch.ops.vog.mm_attention_fwd(q, k, v, cn, mask, fb, fid, "highest"),
                        mm_attention.mm_attention_plain(q, k, v, cn, mask, fb, fid)):
        _close(got, ref)
    vis, arg = torch.relu(torch.randn((B, T, D), generator=g, device=dev)), torch.randn((B, A, D), device=dev)
    args = (vis, arg, torch.randn((B, T, D), device=dev), torch.randn((B, A, D), device=dev),
            torch.randn((D, D), device=dev) / 8, torch.randn((D, 32), device=dev) / 8, torch.zeros(32, device=dev),
            torch.randn(32, device=dev), torch.zeros((), device=dev))
    _close(torch.ops.vog.grounding_head_fwd(*args, "highest"), grounding_head.grounding_head_plain(*args))
    assert _build.launches == {"gather_rows": 1, "flash_attention": 1, "mm_shared_qk_attention": 1,
                               "fused_grounding_head": 1}, _build.launches


def test_export_on_the_card_holds_the_four_ops(dev, tmp_path):
    """A narrow model's artifact with tables, exported on the card: its
    program calls each forward op; its eager replay (``cuda_graphs=False``;
    the graphed one: ``test_graphed_artifact_equals_its_eager_replay``)
    launches the kernels and equals the eager live predictor bitwise, with
    the LSTMs' weights in cuDNN's one buffer; the program does not keep its
    example inputs."""
    import warnings

    import numpy as np

    from chip_smoke import make_requests
    from vog_tpu_torch.export import ExportedPredictor, export_predictor, forward_op_counts
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.serve import Predictor

    cfg, tables, _, n_rows = _tiny()
    feats = {k: v for k, v in tables.items() if k in ("feats", "seg", "feats_scale", "seg_scale")}
    live = Predictor(cfg, None, 5000, tables=feats, device="cuda", cuda_graphs=False)
    path = export_predictor(live, 4, tmp_path / "art", with_tables=True)
    ep = torch.export.load(str(path / "program.pt2"))
    counts = forward_op_counts(ep.graph)
    assert counts == {"gather_rows": 2, "flash_attention_fwd": 1, "mm_attention_fwd": 1,
                      "grounding_head_fwd": 1}, counts
    assert ep.example_inputs is None
    rep = ExportedPredictor(path, cuda_graphs=False)
    reqs = make_requests(cfg, 4, n_rows, 5000, seed=2)
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    batch["batch_mask"] = np.ones((4,), np.uint8)
    ds = cfg.ds
    batch["targets"] = np.zeros((4, ds.num_cmp, ds.max_srl_args, ds.num_frms, ds.num_prop_per_frm), np.uint8)
    ref = live(batch)
    _build.reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = rep(batch)
    assert _build.launches == {"gather_rows": 2, "flash_attention": 1, "mm_shared_qk_attention": 1,
                               "fused_grounding_head": 1}, _build.launches
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    # the LSTMs' weights lie in cuDNN's one buffer (no copy at each call)
    assert not [w for w in caught if "contiguous chunk" in str(w.message)]


def test_artifact_capture_failure_raises(dev, tmp_path):
    """A host read inside the artifact's program fails its capture: the
    request raises and nothing replays eagerly in its place.  (Last in the
    file, as ``test_capture_failure_raises``: a failed capture may leave the
    context's error state to the tests after it.)"""
    import numpy as np

    from chip_smoke import make_requests
    from vog_tpu_torch.export import ExportedPredictor, export_predictor
    from vog_tpu_torch.serve import Predictor

    cfg, tables, _, n_rows = _tiny()
    feats = {k: v for k, v in tables.items() if k in ("feats", "seg", "feats_scale", "seg_scale")}
    live = Predictor(cfg, None, 5000, tables=feats, device="cuda", cuda_graphs=False)
    rep = ExportedPredictor(export_predictor(live, 2, tmp_path / "art", with_tables=True))
    program = rep.program

    def reads_the_host(*a):
        out = program(*a)
        float(out[0].sum())  # a host read: legal eagerly, not under capture
        return out

    rep.program = reads_the_host
    reqs = make_requests(cfg, 2, n_rows, 5000, seed=4)
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    batch["batch_mask"] = np.ones((2,), np.uint8)
    ds = cfg.ds
    batch["targets"] = np.zeros((2, ds.num_cmp, ds.max_srl_args, ds.num_frms, ds.num_prop_per_frm), np.uint8)
    with pytest.raises(RuntimeError):
        rep(batch)
    assert not rep.graphs


# --------------------------------------------------------------------------
# data parallelism across processes (train/dist.py): chip_smoke.py's worlds
# at narrow widths
# --------------------------------------------------------------------------
def _dist_cfg(dtype: str, precision: str, K: int):
    from chip_smoke import serve_cfg

    cfg = serve_cfg()
    m = cfg.mdl
    cfg.ds.prop_dim, cfg.ds.seg_dim = 64, 48
    m.emb_dim, m.lstm_dim, m.vis_dim, m.role_dim, m.n_heads = 32, 16, 32, 8, 2
    m.dropout, m.dtype, cfg.misc.matmul_precision = 0.1, dtype, precision
    t = cfg.train
    t.bs, t.lr, t.lr_schedule, t.warmup_steps, t.total_steps = 4, 1e-3, "cosine", 3, 50
    t.skip_nonfinite, t.pos_weight, t.grad_clip, t.steps_per_dispatch = 2, 5.0, 1.0, K
    cfg.misc.multihost, cfg.ds.device_store = True, "shard"
    return cfg


def test_dist_nccl_world1_dispatch_bitwise(dev):
    """An NCCL world of one rank (spawned): the graphed dispatch of K = 4
    with the all-reduce, the loss's count and the sharded store's
    collectives captured, bitwise its eager steps and the single-device
    dispatch (``chip_smoke.dist_nccl_rank`` raises otherwise)."""
    from chip_smoke import dist_nccl_rank, path_names, run_world

    cfg = _dist_cfg("bfloat16", "default", 4)
    (r,) = run_world(dist_nccl_rank, 1, "nccl", cfg, None, 250, 60)
    assert r["single_bitwise"] and len(r["losses"]) == 4
    assert set(r["counts"]) == path_names(cfg)  # every wrapper's, and mm_bwd_dkv_wg's ("default", dh 16)


def test_dist_gloo_two_ranks_on_one_card(dev):
    """A gloo world of two ranks on one card: eager steps with the sharded
    store, one eval through ``gather_eval``, against one process on the
    global batch (``chip_smoke.dist_gloo_rank``); the ranks' states bitwise
    equal."""
    from chip_smoke import KERNEL_NAMES, dist_gloo_rank, run_world

    cfg = _dist_cfg("float32", "highest", 1)
    r0, r1 = run_world(dist_gloo_rank, 2, "gloo", cfg, 250, 60, 3)
    assert r0["digest"] == r1["digest"] and "one_process" in r0
    assert set(r0["counts"]) == set(KERNEL_NAMES)


# --------------------------------------------------------------------------
# the mesh's model axis (tensor parallelism, the sequence-parallel ring):
# gloo worlds on one card
# --------------------------------------------------------------------------
def test_model_axis_gloo_world_on_one_card(dev):
    """A gloo world of two ranks on one card, mesh (1, 2), at narrow widths
    (one head a rank): the tensor-parallel eager steps (every kernel
    launched), the ring with ``decomposed_mm`` on and off, and one serve
    flush through the follower, each against one process on the card
    (``chip_smoke.model_axis_gloo_rank`` raises otherwise); the ranks'
    whole parameters and gathered states bitwise equal, and a rerun's."""
    from chip_smoke import KERNEL_NAMES, ma_cfg, model_axis_gloo_rank, run_world, serve_cfg

    tp = ma_cfg(_dist_cfg("float32", "highest", 1), 2)
    tp.ds.device_store = "on"
    sps = [ma_cfg(tp, 2, sp=True, decomposed=d) for d in (True, False)]
    serve = ma_cfg(serve_cfg(), 2, sp=True)
    m = serve.mdl
    serve.ds.prop_dim, serve.ds.seg_dim = 64, 48
    m.emb_dim, m.lstm_dim, m.vis_dim, m.role_dim, m.n_heads = 32, 16, 32, 8, 2
    r0, r1 = run_world(model_axis_gloo_rank, 2, "gloo", tp, sps, serve, 250, 60, 3)
    assert set(r0["counts"]) == set(KERNEL_NAMES)
    assert r0["gathered"] == r1["gathered"] == r0["rerun_gathered"] and r0["replicated"] == r1["replicated"]
    assert set(r0["sp"]) == {"decomposed", "materialised"} and r1["followed"] >= 1 and "serve" in r0


def test_ring_on_one_card_matches_dense(dev):
    """``ring_attention`` in a gloo world of two ranks on one card (the P2P
    staged through the host), with and without the frame bias, against
    the flash kernel's plain version over the whole T on the CPU: the
    output within 2e-5 and the gradients within 3e-5."""
    import pathlib
    import sys

    from vog_tpu_torch.kernels.attention import flash_attention

    # by its own name: a package named ``tests`` on the card's host may shadow this directory
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from _torch_dist_worker import ring_cases, run_world

    g = torch.Generator().manual_seed(5)
    B, H, F, Pn, dh = 2, 2, 8, 8, 16
    T = F * Pn
    q, k, v, cot = (torch.randn(B, H, T, dh, generator=g) for _ in range(4))
    mask = (torch.rand(B, T, generator=g) > 0.3).float()
    mask[:, :Pn] = 1.0
    fids = torch.arange(T, dtype=torch.int32) // Pn
    bias = 0.1 * torch.randn(H, F, F, generator=g)
    cases = [(q, k, v, mask, b, fids, cot) for b in (None, bias)]
    ranks = run_world(ring_cases, 2, cases, "cuda")
    for i, b in enumerate((None, bias)):
        got = [torch.cat([r[i][j] for r in ranks], dim=2) for j in range(4)]
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        bb = None if b is None else b.clone().requires_grad_(True)
        o = flash_attention(*leaves, mask) if b is None else flash_attention(*leaves, mask, bb, fids)
        o.backward(cot)
        assert (got[0] - o.detach()).abs().max() <= 2e-5
        for a, ref in zip(got[1:], leaves):
            assert (a - ref.grad).abs().max() <= 3e-5
        if b is not None:
            assert (sum(r[i][4] for r in ranks) - bb.grad).abs().max() <= 3e-5
