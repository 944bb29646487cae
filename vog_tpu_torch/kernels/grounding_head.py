"""Fused cross-MLP grounding head, fp32 operands, forward and backward.

  logit[b,a,t] = w2 . relu(relu(wv_t + wl_a + (vis_t * arg_a) @ Wx) @ W1 + b1) + b2

Replaces vog_tpu/kernels/grounding_head.py §_fwd_call (_fwd_kernel).  CUDA
kernels: csrc/grounding_head.cu.  Bound by operations on the H100 (12.6
GFLOP against ~13 MB of inputs at GT5, B=16), so the products run on the
tensor cores in 3xTF32 (fp32-level accuracy), as Hopper's wgmma:
``head_fwd_prep`` lays Wx^T and W1^T out once a call as the stream of
K-major k-steps that wgmma reads (into the buffer ``wstream``), and
``head_fwd``, a persistent grid of one warpgroup an SM, walks the items
(64 flattened (b, t) rows, one arg): the cross tile in shared memory, the
two products chained chunk by chunk in registers, the weights streamed by
the copy engine.  It writes only the (B,A,T) logits and takes any A in
one launch.  The stems ``wv`` (with its bias) and ``wl`` are computed by
the caller.  Weights keep the JAX layout: Wx (D_in, D), W1 (D, Dh).  No
single library call computes this function.

Backward: replaces §_fused_head_bwd (``_bwd_kernel``, all 9 gradients).
The TPU kernel accumulates the (D,D) and (D,Dh) weight gradients in VMEM
across its sequential grid; CUDA blocks run in parallel, so the card runs
a row kernel and a weight kernel (csrc/grounding_head.cu).  Up to D 512
and Dh 256 (``_bwd_launch_narrow``, one C call): ``head_bwd_prep`` lays
out the weight streams, ``head_bwd_rows_wg`` (a persistent grid on
wgmma, tiles of 64 flattened (b, a, t) rows, the weights streamed by bulk
copies from a producer warpgroup) recomputes z0, h and z1 and forms dz1,
dz0 and dcross, writing cross and h transposed (the K-major operands of
the weight products), dz0 and dz1 rows and its parts of the other
gradients; ``head_bwd_w_wg`` forms dWx and dW1 on wgmma in row chunks; and
``head_bwd_finish`` adds every part up in a fixed order, so the gradients
do not change between runs.  Past either width the wide path's two
kernels on mma.sync (``head_bwd_rows``, ``head_bwd_w``), the batch rows
past the row kernel's first wave on a second stream, so that the weight
kernel's first chunks fill the SMs its second wave leaves idle; their
partials are added up here in a fixed order (``sum`` over a dimension).

Widths: the kernels take D % 32 == 0 and Dh % 16 == 0, at any size; the
wrapper zero-pads other widths (``pad_head``: exact, the padded z0 and z1
columns are 0 and stay 0 through the ReLUs) and slices the gradients
back.  Up to D 512 and Dh 256 they run whole cross tiles and one z1
accumulator; past either, their wide path (csrc/grounding_head.cu): the
forward computes z0 by K slices of 512 columns of the cross tile into a
scratch of 64 rows a block (``zs``, allocated here), then z1 a group of
256 columns at a time (the stream lays W1 out a group at a time); the
row kernel's warps walk column groups over K slices staged from its own
(B,A,T,.) outputs.  The weight kernel's row chunks fall with D
(``w_chunks``), so its partials stay small.

Args: the backward's kernels take 1 <= A <= 5 (their row tile holds the
A args of 16 tokens; at A=5 the accumulators fill the register file).  A
head's logits are independent across args, so for A > 5 the backward
splits the args into groups of at most 5, as even as possible
(``arg_groups``: 6 -> 3 + 3, 8 -> 4 + 4), launches the kernels once a
group, concatenates the per-arg gradients (darg, dwl), and adds the shared
ones (dvis, dwv and the weight gradients) group by group in order.  The
CPU path takes the same groups.
``fused_grounding_head`` is a ``torch.autograd.Function``: the CUDA
kernels on the card, ``grounding_head_bwd_plain`` on the CPU.

Precision (``config.kernel_precision``): at "highest" the products are
3xTF32, as above; at "default" (the library built with
``-DVOG_ONE_PASS=1``) they are one TF32 pass: ``head_fwd_prep`` lays out
each weight once, rounded to the nearest TF32, so the stream halves, each
k-step issues one wgmma instead of three (the backward's too: its weight
streams and transposed operands hold one rounded part), and the wide
backward's mma.sync products take one pass.  Launches count as
``fused_grounding_head@default`` and ``fused_grounding_head_bwd@default``.  The operands stay fp32 (as the
JAX package keeps them, its grounding.py:92-98); the forward reads the
precision and its ctx carries it to the backward.
"""

from __future__ import annotations

import torch

from vog_tpu_torch.config.defaults import kernel_precision
from vog_tpu_torch.kernels import _build

NAME = "fused_grounding_head"
NAME_BWD = "fused_grounding_head_bwd"
# row chunks of the weight-gradient kernel: at GT5 its 48 output tiles x 11
# chunks = 528 blocks, two blocks on each of the H100's 132 SMs twice over
# (split 6 + 5 between the row kernel's two parts)
W_CHUNKS = 11
ROW_TOKENS = 16  # tokens a block of the row kernel (kBT in csrc/grounding_head.cu)
KERNEL_ARGS = 5  # the most args a backward launch takes (vog_head_bwd's cases)
FWD_CHUNK = 64  # z0 columns a chunk of the forward (kNC in csrc/grounding_head.cu)
HIDDEN_GROUP = 256  # z1 columns a pass of the forward (kNZ)
WIDE_D = 512  # past this D (or Dh past HIDDEN_GROUP) the kernels take their wide path (kMaxD)
FWD_ROWS = 64  # flattened (b, t) rows of a forward item (kFRows)
D_ALIGN, DH_ALIGN = 32, 16  # the widths the kernels take are multiples of these


def arg_groups(A: int):
    """[(a0, a1), ...]: A args in ceil(A / KERNEL_ARGS) groups of at most
    KERNEL_ARGS, as even as possible, in order (the backward's launches)."""
    n = -(-A // KERNEL_ARGS)
    bounds = [A * i // n for i in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def w_chunks(D: int, Dh: int) -> int:
    """Row chunks of the weight-gradient kernel: W_CHUNKS up to D 512 (its
    48 output tiles there x 11 = 528 blocks, two waves); past it, as many
    as keep about 528 blocks (2 at D 1024, 1 from D 1536), so that the
    (chunks, D, D) partials stay near D^2 floats (11 D^2 is 738 MB at D
    4096)."""
    tiles = -(-D // 128) * (-(-D // 64) + -(-Dh // 64))
    return max(1, min(W_CHUNKS, 528 // tiles))


def pad_head(vis, arg, wv, wl, wx, w1, b1, w2):
    """The head's operands zero-padded to the widths the kernels take: D
    to a multiple of 32 (vis, arg, wv, wl, the rows and columns of Wx, the
    rows of W1) and Dh to a multiple of 16 (the columns of W1, b1, w2); the
    operands themselves where both already are.  Exact: the padded z0
    columns are 0 (relu 0), the padded rows of W1 meet them, and the padded
    z1 columns are 0 with w2 0 there, so the logits are the same and the
    gradients' padded entries are dropped by slicing."""
    D, Dh = wx.shape[0], w1.shape[1]
    Dp, Dhp = -(-D // D_ALIGN) * D_ALIGN, -(-Dh // DH_ALIGN) * DH_ALIGN
    if (Dp, Dhp) == (D, Dh):
        return vis, arg, wv, wl, wx, w1, b1, w2
    pad = lambda t, *n: torch.nn.functional.pad(t, [x for k in reversed(n) for x in (0, k)])  # noqa: E731
    dd, dhh = Dp - D, Dhp - Dh
    return (pad(vis, dd), pad(arg, dd), pad(wv, dd), pad(wl, dd), pad(wx, dd, dd), pad(w1, dd, dhh),
            pad(b1, dhh), pad(w2, dhh))


def unpad_grads(grads, D: int, Dh: int):
    """The 9 gradients of a padded head sliced back to D and Dh."""
    dvis, darg, dwv, dwl, dwx, dw1, db1, dw2, db2 = grads
    return (dvis[..., :D].contiguous(), darg[..., :D].contiguous(), dwv[..., :D].contiguous(),
            dwl[..., :D].contiguous(), dwx[:D, :D].contiguous(), dw1[:D, :Dh].contiguous(),
            db1[:Dh].contiguous(), dw2[:Dh].contiguous(), db2)


def fwd_stream_floats(D: int, precision: str = "highest", Dh: int = HIDDEN_GROUP) -> int:
    """Floats of the forward's weight stream (``head_fwd_prep``): for each
    of the D_pad / 64 chunks, D_pad / 8 z0 k-steps of 64 x 8 and, for each
    of the ceil(Dh / 256) hidden groups (one up to Dh 256), 8 z1 k-steps of
    256 x 8 (D_pad = D rounded up to 64), each stored as its big and its
    small parts ("highest") or once, rounded ("default")."""
    dp = -(-D // FWD_CHUNK) * FWD_CHUNK
    ng = -(-Dh // HIDDEN_GROUP)
    parts = 2 if precision == "highest" else 1
    return parts * (dp // FWD_CHUNK) * (dp // 8 * FWD_CHUNK * 8 + ng * 8 * HIDDEN_GROUP * 8)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to the nearest TF32, ties away from zero, the low
    13 bits cleared: ``cvt.rna.tf32.f32`` (csrc/tf32.cuh §round_tf32) for
    finite values."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def fwd_stream_plain(wx, w1, precision: str = "highest", natural: bool = False) -> torch.Tensor:
    """Plain version of ``head_fwd_prep``: Wx (D, D) and W1 (D, Dh) as the
    forward's weight stream, zero-padded to D_pad (a multiple of 64) and
    to ng = ceil(Dh / 256) groups of 256 hidden columns.  Chunk c holds the
    z0 k-steps s (Wx rows 8s .. 8s+7, columns 64c ..) and then, for each
    hidden group hg, the z1 k-steps j (W1 rows 64c + 8j .., columns 256 hg
    .. 256 hg + 255); a k-step is [k half e][column n][k slot u], where slot
    u of half e holds row 2u + e of the step (the K-major core matrices of
    TF32 wgmma, k in pair order).  The stream is cut into stages of 2048
    weights (4 z0 k-steps or 1 z1 k-step), each stored as its big parts (the
    low 13 mantissa bits cleared: TF32 toward zero), then its small parts
    (the rest, exact): big + small rebuilds every weight.  At "default" a
    stage holds each weight once, rounded to the nearest TF32
    (``round_tf32``).  ``natural``: the z0 k-steps in natural order, slot
    u of half e holding row 4e + u (the backward's layout, whose z0 A
    operand is read from shared memory, ``head_bwd_prep``)."""
    D, Dh = wx.shape[0], w1.shape[1]
    dp = -(-D // FWD_CHUNK) * FWD_CHUNK
    nch, ng = dp // FWD_CHUNK, -(-Dh // HIDDEN_GROUP)
    wxp = wx.new_zeros((dp, dp))
    wxp[:D, :D] = wx
    w1p = w1.new_zeros((dp, ng * HIDDEN_GROUP))
    w1p[:D, :Dh] = w1
    # row k = 8 step + 2 u + e -> (step, u, e); Wx column 64 c + n -> (c, n);
    # W1 column 256 hg + n -> (hg, n)
    if natural:  # row k = 8 step + 4 e + u
        z0 = wxp.reshape(dp // 8, 2, 4, nch, FWD_CHUNK).permute(3, 0, 1, 4, 2).reshape(nch, -1)
    else:
        z0 = wxp.reshape(dp // 8, 4, 2, nch, FWD_CHUNK).permute(3, 0, 2, 4, 1).reshape(nch, -1)
    z1 = w1p.reshape(nch, 8, 4, 2, ng, HIDDEN_GROUP).permute(0, 4, 1, 3, 5, 2).reshape(nch, -1)
    raw = torch.cat([z0, z1], dim=1).reshape(-1, 2048).contiguous()
    if precision != "highest":
        return round_tf32(raw).reshape(-1)
    big = (raw.view(torch.int32) & -8192).view(torch.float32)  # 0xffffe000
    return torch.stack([big, raw - big], dim=1).reshape(-1).contiguous()


def grounding_head_plain(vis, arg, wv, wl, wx, w1, b1, w2, b2, precision=None) -> torch.Tensor:
    """Plain PyTorch version -> (B,A,T) (``precision`` is taken for the
    wrapper's signature only)."""
    cross = vis[:, None] * arg[:, :, None]  # (B,A,T,D)
    h = torch.relu(wv[:, None] + wl[:, :, None] + torch.matmul(cross, wx))
    h1 = torch.relu(torch.matmul(h, w1) + b1)
    return torch.matmul(h1, w2) + b2


def _check_cuda(vis, arg, wv, wl, wx, w1, b1, w2, b2, max_args=KERNEL_ARGS) -> torch.Tensor:
    """The kernels' argument checks (at most ``max_args`` args, None: any)
    -> b2 as a (1,) tensor."""
    if vis.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {vis.device}")
    dev = vis.device
    B, T, D = vis.shape
    A = arg.shape[1]
    Dh = w1.shape[1]
    if A < 1 or (max_args is not None and A > max_args):
        raise ValueError(f"{NAME}: a launch takes 1 <= A <= {max_args} (A={A})")
    f32 = torch.float32
    for name, t, shape in (
        ("vis", vis, (B, T, D)), ("wv", wv, (B, T, D)), ("arg", arg, (B, A, D)),
        ("wl", wl, (B, A, D)), ("wx", wx, (D, D)), ("w1", w1, (D, Dh)),
        ("b1", b1, (Dh,)), ("w2", w2, (Dh,)),
    ):
        _build.require(t, name, f32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} shape {tuple(t.shape)} != {shape}")
    if b2.numel() != 1 or b2.device != dev or b2.dtype != f32:
        raise ValueError(f"{NAME}: b2 must be one fp32 value on {dev}")
    return b2.reshape(1).contiguous()


def _groups(arg, wl, g):
    """(arg, wl, g) sliced to each of ``arg_groups``."""
    for a0, a1 in arg_groups(arg.shape[1]):
        sl = lambda t: t[:, a0:a1].contiguous()  # noqa: E731
        yield sl(arg), sl(wl), sl(g)


def grounding_head_fwd(vis, arg, wv, wl, wx, w1, b1, w2, b2, precision=None) -> torch.Tensor:
    """vis (B,T,D), arg (B,A,D), wv (B,T,D), wl (B,A,D), wx (D,D),
    w1 (D,Dh), b1 (Dh,), w2 (Dh,), b2 () or (1,) -> logits (B,A,T), through
    the op ``vog::grounding_head_fwd``: the CUDA kernels at ``precision``
    (None: ``kernel_precision()``) on the card (one launch, any A), the
    plain version on the CPU."""
    if vis.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME}: unsupported device {vis.device}")
    return torch.ops.vog.grounding_head_fwd(vis, arg, wv, wl, wx, w1, b1, w2, b2,
                                            precision or kernel_precision())


def _head_fwd_cuda(vis, arg, wv, wl, wx, w1, b1, w2, b2, prec) -> torch.Tensor:
    """The forward kernels' launch, one a call of any A, on the operands
    padded to the widths the kernels take (the op's CUDA implementation)."""
    b2 = _check_cuda(vis, arg, wv, wl, wx, w1, b1, w2, b2, max_args=None)
    vis, arg, wv, wl, wx, w1, b1, w2 = pad_head(vis, arg, wv, wl, wx, w1, b1, w2)
    dev = vis.device
    B, T, D = vis.shape
    A, Dh = arg.shape[1], w1.shape[1]
    out = torch.empty((B, A, T), dtype=torch.float32, device=dev)
    stream = torch.empty((fwd_stream_floats(D, prec, Dh),), dtype=torch.float32, device=dev)
    # the wide path's z0 scratch: 64 rows of D_pad a block of its grid
    blocks = 0 if D <= WIDE_D and Dh <= HIDDEN_GROUP else min(
        -(-B * T // FWD_ROWS) * A, torch.cuda.get_device_properties(dev).multi_processor_count)
    zs = torch.empty((blocks * FWD_ROWS * -(-D // FWD_CHUNK) * FWD_CHUNK,), dtype=torch.float32, device=dev)
    P, I = _build.P, _build.I
    prep = _build.function("grounding_head.cu", "vog_head_fwd_prep", [P] * 3 + [I] * 2 + [P], prec)
    _build.check(prep(dev.index, wx.data_ptr(), w1.data_ptr(), stream.data_ptr(), D, Dh,
                      _build.stream_ptr(vis)), NAME)
    fn = _build.function("grounding_head.cu", "vog_head_fwd", [P] * 10 + [I] * 6 + [P], prec)
    rc = fn(dev.index, vis.data_ptr(), arg.data_ptr(), wv.data_ptr(), wl.data_ptr(), stream.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), zs.data_ptr() if blocks else None,
            blocks, B, A, T, D, Dh, _build.stream_ptr(vis))
    _build.check(rc, NAME)
    _build.count(NAME, prec)
    return out


# the op ``vog::grounding_head_fwd`` (``_build.define_op``)
_build.define_op(
    "grounding_head_fwd(Tensor vis, Tensor arg, Tensor wv, Tensor wl, Tensor wx, Tensor w1, Tensor b1, "
    "Tensor w2, Tensor b2, str precision) -> Tensor",
    cuda=_head_fwd_cuda, cpu=grounding_head_plain,
    fake=lambda vis, arg, wv, wl, wx, w1, b1, w2, b2, precision: vis.new_empty(
        (vis.shape[0], arg.shape[1], vis.shape[1])))


def grounding_head_bwd_plain(vis, arg, wv, wl, wx, w1, b1, w2, b2, g, precision=None):
    """Plain PyTorch backward -> (dvis, darg, dwv, dwl, dwx, dw1, db1, dw2,
    db2), as the TPU kernel's ``_bwd_kernel`` defines it (relu' is 0 at 0;
    ``precision`` is taken for the wrapper's signature only)."""
    cross = vis[:, None] * arg[:, :, None]  # (B,A,T,D)
    z0 = wv[:, None] + wl[:, :, None] + torch.matmul(cross, wx)
    h = torch.relu(z0)
    z1 = torch.matmul(h, w1) + b1
    gg = g[..., None]  # (B,A,T,1)
    dz1 = torch.where(z1 > 0, gg * w2, torch.zeros_like(z1))
    dz0 = torch.where(z0 > 0, torch.matmul(dz1, w1.t()), torch.zeros_like(z0))
    dcross = torch.matmul(dz0, wx.t())
    D, Dh = wx.shape[0], w1.shape[1]
    return (
        (dcross * arg[:, :, None]).sum(1),
        (dcross * vis[:, None]).sum(2),
        dz0.sum(1),
        dz0.sum(2),
        torch.matmul(cross.reshape(-1, D).t(), dz0.reshape(-1, D)),
        torch.matmul(h.reshape(-1, D).t(), dz1.reshape(-1, Dh)),
        dz1.reshape(-1, Dh).sum(0),
        (torch.relu(z1) * gg).reshape(-1, Dh).sum(0),
        g.sum().reshape(b2.shape),
    )


def grounding_head_bwd(vis, arg, wv, wl, wx, w1, b1, w2, b2, g, precision=None, scratch=None):
    """Backward of ``grounding_head_fwd`` at ``precision`` (None:
    ``kernel_precision()``) -> the 9 gradients, the args in the forward's
    groups: per-arg gradients concatenated, the others added group by group
    in order.  ``scratch`` (a dict, at most KERNEL_ARGS args, on the card):
    filled with the row kernel's h = relu(z0) and dz1 = [z1 > 0] g w2
    (B, A, T, .), its ReLU decisions, for a check that holds the arithmetic
    apart from the kinks (chip_smoke.py)."""
    prec = precision or kernel_precision()
    if arg.shape[1] <= KERNEL_ARGS:
        return _bwd(vis, arg, wv, wl, wx, w1, b1, w2, b2, g, prec, scratch)
    parts = [_bwd(vis, a, wv, l, wx, w1, b1, w2, b2, gg, prec) for a, l, gg in _groups(arg, wl, g)]
    cat = lambda i: torch.cat([p[i] for p in parts], dim=1)  # noqa: E731
    add = lambda i: sum(p[i] for p in parts)  # noqa: E731  (in group order)
    return (add(0), cat(1), add(2), cat(3), add(4), add(5), add(6), add(7),
            g.sum().reshape(b2.shape))


def _bwd(vis, arg, wv, wl, wx, w1, b1, w2, b2, g, prec, scratch=None):
    """One group's 9 gradients: the two CUDA kernels on the card (on the
    operands padded to the widths they take, the gradients sliced back),
    the plain version on the CPU."""
    if vis.device.type == "cpu":
        return grounding_head_bwd_plain(vis, arg, wv, wl, wx, w1, b1, w2, b2, g)
    _check_cuda(vis, arg, wv, wl, wx, w1, b1, w2, b2)
    D0, Dh0 = wx.shape[0], w1.shape[1]
    padded = pad_head(vis, arg, wv, wl, wx, w1, b1, w2)
    if padded[4] is wx:
        return _bwd_launch(vis, arg, wv, wl, wx, w1, b1, w2, b2, g, prec, scratch)
    grads = unpad_grads(_bwd_launch(*padded, b2, g, prec, scratch), D0, Dh0)
    if scratch is not None:
        scratch.update(h=scratch["h"][..., :D0], dz1=scratch["dz1"][..., :Dh0])
    return grads


def bwd_stream_floats(D: int, precision: str = "highest", Dh: int = HIDDEN_GROUP) -> int:
    """Floats of the narrow backward's weight stream (``head_bwd_prep``):
    for each of the D_pad / 64 chunks, ceil(Dh / 32) stages of dh = dz1 .
    W1^T and then, for each chunk, D_pad / 32 stages of dcross = dz0 . Wx^T,
    2048 weights a stage, each stored as its big and small parts
    ("highest") or once, rounded ("default")."""
    dp = -(-D // FWD_CHUNK) * FWD_CHUNK
    parts = 2 if precision == "highest" else 1
    return parts * (dp // FWD_CHUNK) * (-(-Dh // 32) + dp // 32) * 2048


def bwd_stream_plain(wx, w1, precision: str = "highest") -> torch.Tensor:
    """Plain version of the backward's part of ``head_bwd_prep`` (which
    writes ``fwd_stream_plain(..., natural=True)`` first): W1^T and Wx^T as
    the stream of the narrow backward's dh and dcross products, in the
    forward's z0 format (``fwd_stream_plain``): for each 64-column chunk c,
    the k-steps s of dh (B(k, n) = W1[64c + n, 8s + k], k over Dh
    zero-padded to 32), then for each chunk the k-steps of dcross (B(k, n)
    = Wx[64c + n, 8s + k]); a k-step is [k half e][column n][k slot u],
    slot u of half e holding k 2u + e for dh (its A operand comes from
    registers in pair order) and k 4e + u for dcross (from shared memory);
    stages of 2048 weights, big then small parts, or rounded at
    "default"."""
    D, Dh = wx.shape[0], w1.shape[1]
    dp = -(-D // FWD_CHUNK) * FWD_CHUNK
    nch, kh = dp // FWD_CHUNK, -(-Dh // 32) * 32

    def steps(m, K, natural):  # m (D_pad, K): B(k, n) = m[64c + n, k] -> (nch, K * 64) in k-step order
        if natural:  # k = 8 s + 4 e + u
            return m.reshape(nch, FWD_CHUNK, K // 8, 2, 4).permute(0, 2, 3, 1, 4).reshape(nch, -1)
        return m.reshape(nch, FWD_CHUNK, K // 8, 4, 2).permute(0, 2, 4, 1, 3).reshape(nch, -1)

    w1p = w1.new_zeros((dp, kh))
    w1p[:D, :Dh] = w1
    wxp = wx.new_zeros((dp, dp))
    wxp[:D, :D] = wx
    raw = torch.cat([steps(w1p, kh, False).reshape(-1), steps(wxp, dp, True).reshape(-1)]).reshape(-1, 2048)
    if precision != "highest":
        return round_tf32(raw).reshape(-1)
    big = (raw.view(torch.int32) & -8192).view(torch.float32)  # 0xffffe000
    return torch.stack([big, raw - big], dim=1).reshape(-1).contiguous()


T_GROUP = 32  # rows of a group of the narrow backward's transposed layout (kTGroup)
NARROW_MIN_T = 16  # the narrow backward's shortest T (a 16-row block meets at most two (b, a))
BWD_ROWS = 64  # rows (b, a, t) of an item of the narrow backward's row kernel (kBRows)
W_TILES = (128, 256)  # output rows (dz columns) and columns of a block of its weight kernel (kGM, kGN)


def untranspose(x: torch.Tensor, R: int, D: int) -> torch.Tensor:
    """The narrow backward's transposed layout back to rows: x holds planes
    of ceil(R / 32) groups of [(r % 32) / 4][i][r % 4] (D columns i) -> the
    planes added, (R, D) (big + small at "highest", the rounded values at
    "default")."""
    groups = -(-R // T_GROUP)
    y = x.reshape(-1, groups, T_GROUP // 4, D, 4).sum(0)
    return y.permute(0, 1, 3, 2).reshape(groups * T_GROUP, D)[:R]


def narrow_chunks(R: int, D: int, Dh: int, sms: int) -> tuple:
    """(chunks, groups a chunk) of the narrow weight kernel: about ``sms``
    blocks over its output tiles, every chunk holding at least one group of
    32 rows."""
    tm, tn = W_TILES
    tiles = (-(-D // tm) + -(-Dh // tm)) * -(-D // tn)
    groups = -(-R // T_GROUP)
    per = -(-groups // max(1, sms // tiles))
    return -(-groups // per), per


def _bwd_launch(vis, arg, wv, wl, wx, w1, b1, w2, b2, g, prec, scratch=None):
    """The CUDA kernels' launch for one group of args, at widths they
    take -> the 9 gradients: the narrow path's (D <= 512, Dh <= 256) or
    the wide path's."""
    dev = vis.device
    B, T, D = vis.shape
    A, Dh = arg.shape[1], w1.shape[1]
    _build.require(g, "g", torch.float32, 3, dev)
    if tuple(g.shape) != (B, A, T):
        raise ValueError(f"{NAME_BWD}: g shape {tuple(g.shape)} != {(B, A, T)}")
    if D <= WIDE_D and Dh <= HIDDEN_GROUP:
        return _bwd_launch_narrow(vis, arg, wv, wl, wx, w1, b1, w2, b2, g, prec, scratch)
    nt = -(-T // ROW_TOKENS)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    cross, h, dz0, dz1 = e(B, A, T, D), e(B, A, T, D), e(B, A, T, D), e(B, A, T, Dh)
    dvis, dwv = e(B, T, D), e(B, T, D)
    darg_p, dwl_p = e(B, nt, A, D), e(B, nt, A, D)
    db1_p, dw2_p = e(B, nt, Dh), e(B, nt, Dh)
    chunks = w_chunks(D, Dh)
    dwx_p, dw1_p = e(chunks, D, D), e(chunks, D, Dh)
    P, I = _build.P, _build.I
    fn = _build.function("grounding_head.cu", "vog_head_bwd", [P] * 21 + [I] * 6 + [P], prec)
    rc = fn(dev.index, vis.data_ptr(), arg.data_ptr(), wv.data_ptr(), wl.data_ptr(), wx.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), g.data_ptr(), cross.data_ptr(), h.data_ptr(),
            dz0.data_ptr(), dz1.data_ptr(), dvis.data_ptr(), dwv.data_ptr(),
            darg_p.data_ptr(), dwl_p.data_ptr(), db1_p.data_ptr(), dw2_p.data_ptr(),
            dwx_p.data_ptr(), dw1_p.data_ptr(), B, A, T, D, Dh, chunks,
            _build.stream_ptr(vis))
    _build.check(rc, NAME_BWD)
    _build.count(NAME_BWD, prec)
    if scratch is not None:
        scratch.update(h=h, dz1=dz1)
    return (
        dvis, darg_p.sum(1), dwv, dwl_p.sum(1), dwx_p.sum(0), dw1_p.sum(0),
        db1_p.sum((0, 1)), dw2_p.sum((0, 1)), g.sum().reshape(b2.shape),
    )


def _bwd_launch_narrow(vis, arg, wv, wl, wx, w1, b1, w2, b2, g, prec, scratch=None):
    """The narrow path's launch (``vog_head_bwd_wg``: the weight streams,
    ``fwd_stream_plain(natural=True)`` then ``bwd_stream_plain``, the row
    kernel, the weight kernel, and the kernel that adds up their parts in a
    fixed order) -> the 9 gradients.  T below NARROW_MIN_T is padded with
    zero tokens whose cotangent is zero."""
    T0 = vis.shape[1]
    if T0 < NARROW_MIN_T:  # zero tokens with a zero cotangent: every gradient exact, dvis and dwv sliced back
        pad = NARROW_MIN_T - T0
        vis, wv = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (vis, wv))
        g = torch.nn.functional.pad(g, (0, pad))
    dev = vis.device
    B, T, D = vis.shape
    A, Dh = arg.shape[1], w1.shape[1]
    R, nslots = B * A * T, -(-T // 16) + 1
    parts = 2 if prec == "highest" else 1
    chunks, per = narrow_chunks(R, D, Dh, torch.cuda.get_device_properties(dev).multi_processor_count)
    rp = -(-R // T_GROUP) * T_GROUP
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    wstream = e(fwd_stream_floats(D, prec, Dh) + bwd_stream_floats(D, prec, Dh))
    cross_t, h_t = e(parts, rp * D), e(parts, rp * D)
    dz0, dz1, dvis_p = e(rp, D), e(rp, Dh), e(B, A, T, D)
    darg_p, dwl_p = e(B * A, nslots, D), e(B * A, nslots, D)  # a slot a 16-row block meeting the (b, a)
    db1_p, dw2_p = e(-(-R // BWD_ROWS), 4, Dh), e(-(-R // BWD_ROWS), 4, Dh)
    dwx_p, dw1_p = e(chunks, D, D), e(chunks, D, Dh)
    grads = (e(B, T, D), e(B, A, D), e(B, T, D), e(B, A, D), e(D, D), e(D, Dh), e(Dh), e(Dh))
    dvis, darg, dwv, dwl, dwx, dw1, db1, dw2 = grads
    P, I = _build.P, _build.I
    fn = _build.function("grounding_head.cu", "vog_head_bwd_wg", [P] * 29 + [I] * 7 + [P], prec)
    rc = fn(dev.index, *(t.data_ptr() for t in (
        vis, arg, wv, wl, wx, w1, b1, w2, g, wstream, cross_t, h_t, dz0, dz1, dvis_p, darg_p, dwl_p,
        db1_p, dw2_p, dwx_p, dw1_p, dvis, dwv, dwx, dw1, darg, dwl, db1, dw2)), B, A, T, D, Dh, chunks, per,
            _build.stream_ptr(vis))
    _build.check(rc, NAME_BWD)
    _build.count(NAME_BWD, prec)
    if scratch is not None:
        scratch.update(h=untranspose(h_t, R, D).view(B, A, T, D)[:, :, :T0],
                       dz1=dz1[:R].view(B, A, T, Dh)[:, :, :T0])
    if T0 < T:
        dvis, dwv = dvis[:, :T0].contiguous(), dwv[:, :T0].contiguous()
    return (dvis, darg, dwv, dwl, dwx, dw1, db1, dw2, g.sum().reshape(b2.shape))


class FusedGroundingHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vis, arg, wv, wl, wx, w1, b1, w2, b2):
        ctx.save_for_backward(vis, arg, wv, wl, wx, w1, b1, w2, b2)
        ctx.precision = kernel_precision()
        return grounding_head_fwd(vis, arg, wv, wl, wx, w1, b1, w2, b2, ctx.precision)

    @staticmethod
    def backward(ctx, g):
        grads = grounding_head_bwd(*ctx.saved_tensors, g.contiguous(), precision=ctx.precision)
        _build.check_outputs(NAME_BWD, *grads)
        return grads


def fused_grounding_head(
    vis: torch.Tensor,  # (B,T,D)
    arg: torch.Tensor,  # (B,A,D)
    wv: torch.Tensor,  # (B,T,D)
    wl: torch.Tensor,  # (B,A,D)
    wx: torch.Tensor,  # (D,D)
    w1: torch.Tensor,  # (D,Dh)
    b1: torch.Tensor,  # (Dh,)
    w2: torch.Tensor,  # (Dh,)
    b2: torch.Tensor,  # () or (1,)
) -> torch.Tensor:
    """-> logits (B,A,T), with its gradient (``FusedGroundingHead``) where
    an input requires one, else the forward op alone."""
    if not _build.needs_grad(vis, arg, wv, wl, wx, w1, b1, w2, b2):
        return grounding_head_fwd(vis, arg, wv, wl, wx, w1, b1, w2, b2)
    return FusedGroundingHead.apply(vis, arg, wv, wl, wx, w1, b1, w2, b2)
