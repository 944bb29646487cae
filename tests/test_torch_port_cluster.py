"""The attention kernels past head dim 128 on a thread block cluster
(``vog_tpu_torch/kernels/_cluster.py``, ``csrc/cluster.cuh``), on the CPU.

  * the launch plan that both wrappers use (``cluster_plan``, the one
    place that decides the split: the C entries take its cluster size),
    for every head dim 129..4096 and every arg count 1..16: the slices
    cover the padded head dim, each exactly once over the passes and the
    cluster's blocks; the cluster is at most the source's portable size
    and at most the slices (the C entries' ``cluster_fits``); the padded
    row stride is a multiple of 16 bytes (TMA's) and the padding is under
    4 columns; the mm forward's and the mm backward's arg groups cover A
    in order, at most the source's args a launch; the constants are the C
    sources';
  * ``pad_cols``: zero columns, and a copy of a view that does not start
    on 16 bytes (TMA's base address);
  * the wrappers' zero-column padding (dh 385 -> 388, TMA's row stride) on
    the plain versions, forward and every gradient, against the JAX
    package's Pallas kernels in interpret mode at dh 385, with
    tests/test_torch_port_grads.py's tolerances (values atol 3e-5 / rtol
    1e-4; gradients flash atol 5e-5 / rtol 1e-3, mm atol 1e-4 / rtol
    1e-3).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_grads import _attn_inputs, _jax_grads
from vog_tpu.kernels.attention import flash_attention as jflash
from vog_tpu.kernels.mm_attention import mm_shared_qk_attention as jmm
from vog_tpu_torch.kernels import _cluster as cluster
from vog_tpu_torch.kernels.attention import flash_attention_bwd_plain, flash_attention_plain
from vog_tpu_torch.kernels.mm_attention import bwd_groups, fwd_groups, mm_attention_bwd_plain, mm_attention_plain

CSRC = Path(__file__).resolve().parents[1] / "vog_tpu_torch" / "csrc"


def _const(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text())
    assert m, f"{name} not in {src}"
    return int(m.group(1))


def test_plan_constants_are_the_sources():
    assert cluster.SLICE == _const("cluster.cuh", "kSlice")
    assert cluster.MAX_CLUSTER == _const("cluster.cuh", "kMaxCluster") == 8
    assert cluster.FWD_KERNEL_ARGS == _const("mm_attention.cu", "kClArgs")
    assert cluster.FWD_KERNEL_ARGS_X == _const("mm_attention.cu", "kClXArgs")
    assert cluster.BWD_KERNEL_ARGS == _const("mm_attention.cu", "kClBwdArgs") == 8
    # the 8-warp kernels' halves: 16 rows and 64 columns a warp
    assert _const("cluster.cuh", "kRowGroups") == 4 and "kHalf = kSlice / 2;" in (CSRC / "cluster.cuh").read_text()
    # the TMA box's width, the shared row stride: a whole number of 16 bytes
    assert "kSliceLd = HeadDim<128>::kLd" in (CSRC / "cluster.cuh").read_text()
    assert (cluster.SLICE + 4) * 4 % 16 == 0


@pytest.mark.parametrize("A", range(1, 17))
def test_plan_covers_every_head_dim(A):
    for dh in range(129, 4097):
        p = cluster.cluster_plan(dh, A)
        assert p.dh == dh and dh <= p.dh_pad < dh + cluster.ROW_ALIGN
        assert p.dh_pad * 4 % 16 == 0  # TMA: 16-byte row strides
        assert p.slices == -(-p.dh_pad // cluster.SLICE)
        # the passes the C entries launch for this cluster (cluster.cuh §passes_of)
        assert p.passes == -(-p.slices // p.cluster) == -(-p.slices // cluster.MAX_CLUSTER)
        assert p.cols == cluster.SLICE and (p.slices - 1) * p.cols < p.dh_pad <= p.slices * p.cols
        assert 1 <= p.cluster <= min(cluster.MAX_CLUSTER, p.slices)
        # block z of pass q owns slice z + cluster * q: every slice once, none past the last
        owned = [z + p.cluster * q for q in range(p.passes) for z in range(p.cluster)]
        assert sorted(x for x in owned if x < p.slices) == list(range(p.slices))
        assert p.passes == 1 or p.cluster * (p.passes - 1) < p.slices
        most = cluster.FWD_KERNEL_ARGS if p.passes == 1 else cluster.FWD_KERNEL_ARGS_X
        bounds = [a for g in p.groups for a in g]
        assert bounds[0] == 0 and bounds[-1] == A
        assert all(a0 < a1 <= a0 + most for a0, a1 in p.groups)
        assert all(p.groups[i][1] == p.groups[i + 1][0] for i in range(len(p.groups) - 1))
        assert len(p.groups) == -(-A // most)
        assert fwd_groups(A, dh, "highest") == fwd_groups(A, dh, "default") == list(p.groups)
        most = cluster.BWD_KERNEL_ARGS
        bounds = [a for g in p.bwd_groups for a in g]
        assert bounds[0] == 0 and bounds[-1] == A
        assert all(a0 < a1 <= a0 + most for a0, a1 in p.bwd_groups)
        assert all(p.bwd_groups[i][1] == p.bwd_groups[i + 1][0] for i in range(len(p.bwd_groups) - 1))
        assert len(p.bwd_groups) == -(-A // most)
        assert bwd_groups(A, dh) == list(p.bwd_groups)


def test_plan_refuses_the_narrow_head_dims():
    with pytest.raises(ValueError):
        cluster.cluster_plan(128)


def test_pad_cols():
    x = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    assert cluster.pad_cols(x, 5) is x
    y = cluster.pad_cols(x, 8)
    assert y.shape == (2, 3, 8) and y.is_contiguous()
    assert torch.equal(y[..., :5], x) and not y[..., 5:].any()


def test_cluster_args_route_the_wrappers():
    """The wrappers' launch arguments: the narrow instances' head dim and no
    cluster up to 128, past it the plan's padded head dim and cluster with
    every tensor through ``pad_cols``."""
    x = torch.ones(2, 3, 128)
    assert cluster.cluster_args(128, x) == (128, 1, (x,))
    y = torch.ones(1, 4, 385)
    kd, n, (yp, zp) = cluster.cluster_args(385, y, y.clone())
    assert (kd, n) == (388, 4) == (cluster.cluster_plan(385).dh_pad, cluster.cluster_plan(385).cluster)
    for t in (yp, zp):
        assert t.shape == (1, 4, 388) and torch.equal(t[..., :385], y) and not t[..., 385:].any()


def test_pad_cols_copies_a_misaligned_view():
    base = torch.arange(1 + 2 * 3 * 8, dtype=torch.float32)
    x = base[1:].view(2, 3, 8)  # contiguous, one float past an aligned start
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    y = cluster.pad_cols(x, 8)
    assert y.data_ptr() != x.data_ptr() and y.data_ptr() % 16 == 0 and y.is_contiguous()
    assert torch.equal(y, x)
    z = cluster.pad_cols(base[1:13].view(2, 6), 8)  # padded and aligned at once
    assert z.data_ptr() % 16 == 0 and torch.equal(z[:, :6], base[1:13].view(2, 6)) and not z[:, 6:].any()


# --------------------------------------------------------------------------
# the zero-column padding at dh 385 against the JAX package
# --------------------------------------------------------------------------
DH = 385


def _padded(*xs):
    dk = cluster.cluster_plan(DH).dh_pad
    assert dk == 388
    return [cluster.pad_cols(torch.from_numpy(np.array(x)), dk) for x in xs]


def test_flash_padded_forward_matches_jax():
    _, q, k, v, mask, fb, fid = _attn_inputs(31, 1, 2, 40, DH, 5)
    qp, kp, vp = _padded(q, k, v)
    o, lse = flash_attention_plain(qp, kp, vp, *(torch.from_numpy(x) for x in (mask, fb, fid)),
                                   scale=1.0 / math.sqrt(DH))
    ref = jflash(*(jnp.asarray(x) for x in (q, k, v, mask, fb, fid)), interpret=True)
    assert not o[..., DH:].any()
    np.testing.assert_allclose(o[..., :DH].numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
    assert np.isfinite(lse.numpy()).all()


@pytest.mark.parametrize("mode", ["recompute", "emit"])
def test_flash_padded_grads_match_jax(mode):
    rng, q, k, v, mask, fb, fid = _attn_inputs(32, 1, 2, 40, DH, 5, all_masked=False)
    do = rng.normal(size=q.shape).astype(np.float32)
    qp, kp, vp, dop = _padded(q, k, v, do)
    mask_t, fb_t, fid_t = (torch.from_numpy(x) for x in (mask, fb, fid))
    scale = 1.0 / math.sqrt(DH)
    o, lse = flash_attention_plain(qp, kp, vp, mask_t, fb_t, fid_t, scale=scale)
    dq, dk, dv, dfb = flash_attention_bwd_plain(qp, kp, vp, mask_t, fb_t, fid_t, o, lse, dop, scale=scale)
    for g in (dq, dk, dv):
        assert not g[..., DH:].any()
    got = [dq[..., :DH].numpy(), dk[..., :DH].numpy(), dv[..., :DH].numpy(), dfb.numpy()]
    diff = (0, 1, 2, 4)
    ref = _jax_grads(lambda *a: jflash(*a, interpret=True, bwd_mode=mode), (q, k, v, mask, fb, fid), diff, do)
    for name, a, b in zip(("dq", "dk", "dv", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-3, err_msg=name)


def _mm_args(seed):
    rng, qm, km, vm, mask, fb, fid = _attn_inputs(seed, 1, 2, 40, DH, 5)
    cn = rng.uniform(-3.0, 0.0, (1, 2, 3, 40)).astype(np.float32)
    return rng, ((qm / np.sqrt(DH)).astype(np.float32), km, vm, cn, mask, fb, fid)


def test_mm_padded_forward_matches_jax():
    _, args = _mm_args(33)
    qp, kp, vp = _padded(*args[:3])
    out, m, den = mm_attention_plain(qp, kp, vp, *(torch.from_numpy(x) for x in args[3:]))
    ref = jmm(*(jnp.asarray(a) for a in args), interpret=True)
    assert not out[..., DH:].any()
    np.testing.assert_allclose(out[..., :DH].numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
    assert (den.numpy() >= 1).all()


@pytest.mark.parametrize("mode", ["emit", "recompute"])
def test_mm_padded_grads_match_jax(mode):
    rng, args = _mm_args(34)
    g = rng.normal(size=(1, 2, 3, 40, DH)).astype(np.float32)
    qp, kp, vp, gp = _padded(*args[:3], g)
    rest = [torch.from_numpy(x) for x in args[3:]]
    out, m, den = mm_attention_plain(qp, kp, vp, *rest)
    dq, dk, dv, dcn, dfb = mm_attention_bwd_plain(qp, kp, vp, *rest, out, m, den, gp)
    for x in (dq, dk, dv):
        assert not x[..., DH:].any()
    got = [dq[..., :DH].numpy(), dk[..., :DH].numpy(), dv[..., :DH].numpy(), dcn.numpy(), dfb.numpy()]
    diff = (0, 1, 2, 3, 5)
    ref = _jax_grads(lambda *a: jmm(*a, interpret=True, bwd_mode=mode), args, diff, g)
    for name, a, b in zip(("dq", "dk", "dv", "dcn", "dfb"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3, err_msg=name)
