"""The narrow head backward's layouts (vog_tpu_torch/kernels/grounding_head.py,
csrc/grounding_head.cu §head_bwd_prep, §head_bwd_rows_wg, §head_bwd_w_wg),
on the CPU:

  * ``bwd_stream_plain``, the plain version of ``head_bwd_prep``'s second
    part: decoded by the rule the row kernel reads it by (64-column chunks,
    k-steps of 8, dh's in pair order and dcross's in natural order, stages
    of 2048 weights, big and small parts or rounded), it gives back W1^T
    (the dh product) and Wx^T (the dcross product), zero past D and Dh;
    its length is ``bwd_stream_floats``; ``fwd_stream_plain(natural=True)``
    (its first part) holds Wx in the same natural order;
  * ``untranspose`` inverts the transposed layout in which the row kernel
    writes cross and h for the weight kernel (``tpos``: groups of 32 rows,
    [(r % 32) / 4][i][r % 4]), with the planes of "highest" added;
  * ``narrow_chunks`` splits the rows in whole 32-row groups, every chunk
    holding at least one, about one block an SM over the output tiles.

The kernels themselves run on the card only (tests/test_torch_port_cuda.py,
chip_smoke.py); the CPU path of the backward is the plain version
(tests/test_torch_port_kernels.py against the JAX package).
"""

import pytest
import torch

from vog_tpu_torch.kernels import grounding_head as gh


def _decode(stream, D, Dh, precision):
    """The stream's dh and dcross operands as (D_pad, K) matrices m[n, k] = B(k, n)."""
    dp = -(-D // 64) * 64
    nch, kh = dp // 64, -(-Dh // 32) * 32
    st = stream.reshape(-1, 2048) if precision != "highest" else stream.reshape(-1, 2, 2048).sum(1)
    raw = st.reshape(-1)

    def mat(flat, K, natural):  # (nch, K / 8 k-steps, e, n, u) -> m[64 c + n, 8 s + k(e, u)]
        x = flat.reshape(nch, K // 8, 2, 64, 4)
        if natural:  # k = 4 e + u
            return x.permute(0, 3, 1, 2, 4).reshape(dp, K)
        return x.permute(0, 3, 1, 4, 2).reshape(dp, K)  # k = 2 u + e

    n1 = nch * kh * 64
    return mat(raw[:n1], kh, False), mat(raw[n1:], dp, True)


@pytest.mark.parametrize("D,Dh", [(64, 32), (96, 48), (512, 256), (160, 208)])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_bwd_stream_plain_is_the_transposed_weights(D, Dh, precision):
    g = torch.Generator().manual_seed(D + Dh)
    wx, w1 = torch.randn((D, D), generator=g), torch.randn((D, Dh), generator=g)
    stream = gh.bwd_stream_plain(wx, w1, precision)
    assert stream.numel() == gh.bwd_stream_floats(D, precision, Dh)
    dh_b, dc_b = _decode(stream, D, Dh, precision)
    want1, want2 = torch.zeros_like(dh_b), torch.zeros_like(dc_b)
    want1[:D, :Dh], want2[:D, :D] = w1, wx
    if precision == "highest":  # big + small is every weight exactly
        assert torch.equal(dh_b, want1) and torch.equal(dc_b, want2)
    else:
        assert torch.equal(dh_b, gh.round_tf32(want1)) and torch.equal(dc_b, gh.round_tf32(want2))


@pytest.mark.parametrize("D,Dh", [(64, 32), (160, 208), (512, 256)])
def test_fwd_stream_natural_order_only_reorders_z0(D, Dh):
    g = torch.Generator().manual_seed(D)
    wx, w1 = torch.randn((D, D), generator=g), torch.randn((D, Dh), generator=g)
    pair, nat = gh.fwd_stream_plain(wx, w1, "default"), gh.fwd_stream_plain(wx, w1, "default", natural=True)
    dp = -(-D // 64) * 64
    per = dp // 8 * 512 + 8 * 2048  # a chunk's floats: its z0 k-steps, then its z1 k-steps
    p, n = pair.reshape(dp // 64, per), nat.reshape(dp // 64, per)
    assert torch.equal(p[:, dp // 8 * 512:], n[:, dp // 8 * 512:])  # z1: pair order in both
    z0p = p[:, :dp // 8 * 512].reshape(dp // 64, dp // 8, 2, 64, 4)  # [c][s][e][n][u], k = 2u + e
    z0n = n[:, :dp // 8 * 512].reshape(dp // 64, dp // 8, 2, 64, 4)  # k = 4e + u
    want = torch.zeros((dp, dp))
    want[:D, :D] = gh.round_tf32(wx)
    assert torch.equal(z0p.permute(1, 4, 2, 0, 3).reshape(dp, dp), want)
    assert torch.equal(z0n.permute(1, 2, 4, 0, 3).reshape(dp, dp), want)


def _transposed(x, parts):
    """x (R, D) in the kernel's transposed layout (csrc §tpos), ``parts``
    planes: big and small (2) or the values (1)."""
    R, D = x.shape
    groups = -(-R // gh.T_GROUP)
    out = torch.zeros((parts, groups * gh.T_GROUP * D))
    r = torch.arange(R)[:, None]
    i = torch.arange(D)[None, :]
    pos = ((r // 32 * 8 + (r % 32) // 4) * D + i) * 4 + (r & 3)
    big = (x.view(torch.int32) & -8192).view(torch.float32) if parts == 2 else x
    out[0, pos.reshape(-1)] = big.reshape(-1)
    if parts == 2:
        out[1, pos.reshape(-1)] = (x - big).reshape(-1)
    return out


@pytest.mark.parametrize("R,D", [(1, 32), (37, 64), (64, 96), (1000, 512)])
@pytest.mark.parametrize("parts", [1, 2])
def test_untranspose_inverts_the_transposed_layout(R, D, parts):
    x = torch.randn((R, D), generator=torch.Generator().manual_seed(R))
    assert torch.equal(gh.untranspose(_transposed(x, parts), R, D), x)


@pytest.mark.parametrize("R,D,Dh,sms", [(16000, 512, 256, 132), (40000, 512, 256, 132), (30, 64, 32, 132),
                                        (640, 128, 64, 8), (16000, 480, 208, 114)])
def test_narrow_chunks_cover_the_rows_in_whole_groups(R, D, Dh, sms):
    chunks, per = gh.narrow_chunks(R, D, Dh, sms)
    groups = -(-R // gh.T_GROUP)
    assert per >= 1 and (chunks - 1) * per < groups <= chunks * per  # every chunk holds a group
    tm, tn = gh.W_TILES
    tiles = (-(-D // tm) + -(-Dh // tm)) * -(-D // tn)
    assert chunks <= max(1, sms // tiles) or chunks == groups
    if (R, D, sms) == (16000, 512, 132):
        assert (tiles, chunks) == (12, 11)  # GT5: 132 blocks, one wave on the H100
