"""The port's Predictor and ServingLoop against vog_tpu.serve.Predictor on
the same resident tables, weights and vid_rows requests (VOGNet, SPAT,
small widths, on the CPU).

Tolerance: scores within 2e-4 * max(1, max|score|) over real proposals
(fp32 on both sides, other summation order); argmaxes must agree wherever
the top-2 margin exceeds twice that; boxes follow the argmax exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _cfg, _glove, _random_batch
from tests.test_torch_port_model import port_cfg
from vog_tpu.data.device_store import _pack_rows
from vog_tpu.serve import Predictor as JPredictor
from vog_tpu.train.state import init_state
from vog_tpu_torch.data.device_store import DeviceFeatureTables
from vog_tpu_torch.serve import Predictor
from vog_tpu_torch.serving import ServingLoop, batch_to_requests

VOCAB = 200
N_ROWS = 11


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(tiny=True)
    cfg.mdl.dropout = 0.0
    cfg.misc.half_feats = True
    B = 6
    glove = _glove(cfg, VOCAB)
    state = init_state(cfg, glove, jax.random.PRNGKey(0), B)
    ds = cfg.ds
    rng = np.random.default_rng(5)
    feats = rng.normal(scale=0.3, size=(N_ROWS, ds.num_frms, ds.num_prop_per_frm, ds.prop_dim)).astype(np.float32)
    seg = rng.normal(scale=0.3, size=(N_ROWS, ds.num_frms, ds.seg_dim)).astype(np.float32)
    batch = _random_batch(cfg, B, seed=4)
    batch["tokens"] = rng.integers(2, VOCAB, batch["tokens"].shape).astype(np.int32)
    batch["prop_mask"][2, 1, :, 4] = 0.0
    del batch["props"], batch["seg_feats"]
    batch["vid_rows"] = rng.integers(0, N_ROWS, (B, ds.num_cmp)).astype(np.int32)

    jtables = {k: jnp.asarray(v) for k, v in _pack_rows({"feats": feats, "seg": seg}, jnp.bfloat16, False).items()}
    jpred = JPredictor(cfg, state.params, glove, tables=jtables)
    pcfg = port_cfg(cfg)
    tables = DeviceFeatureTables.from_arrays(pcfg, feats, seg, half=True, device="cpu")
    params = jax.tree.map(np.asarray, state.params)
    pred = Predictor(pcfg, params, VOCAB, tables=tables.tables, device="cpu")
    return cfg, batch, jpred(batch), pred


def _check_against(ref, got, P):
    valid = np.broadcast_to(got["scores"] > -1e29, got["scores"].shape)
    scale = max(1.0, np.abs(ref["scores"][valid]).max())
    tol = 2e-4 * scale
    assert np.abs(got["scores"][valid] - ref["scores"][valid]).max() <= tol
    np.testing.assert_array_equal(got["scores"] <= -1e29, ref["scores"] <= -1e29)
    s = ref["scores"]
    cand = s.transpose(0, 1, 3, 2, 4).reshape(*s.shape[:2], s.shape[3], -1)
    top2 = np.sort(cand, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * tol
    assert clear.mean() > 0.9
    for k in ("pred_vid", "pred_prop"):
        np.testing.assert_array_equal(got[k][clear], ref[k][clear], err_msg=k)
    np.testing.assert_allclose(got["pred_box"][clear], ref["pred_box"][clear], rtol=0, atol=0)
    np.testing.assert_allclose(got["pred_score"], ref["pred_score"], atol=tol, rtol=0)


def test_predictor_matches_jax_predictor(setup):
    cfg, batch, ref, pred = setup
    got = pred(batch)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == np.asarray(ref[k]).shape, k
    _check_against({k: np.asarray(v) for k, v in ref.items()}, got, cfg.ds.num_prop_per_frm)


@pytest.mark.parametrize("pipeline_depth,buckets", [(1, None), (2, [1, 2, 4])])
def test_serving_loop_matches_jax_predictor(setup, pipeline_depth, buckets):
    cfg, batch, ref, pred = setup
    ref = {k: np.asarray(v) for k, v in ref.items()}
    loop = ServingLoop(pred, max_batch=4, max_wait_ms=5.0, pipeline_depth=pipeline_depth,
                       bucket_sizes=buckets)
    try:
        futs = [loop.submit(r) for r in batch_to_requests(batch)]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        loop.close()
    got = {k: np.stack([o[k] for o in outs]) for k in outs[0]}
    _check_against(ref, got, cfg.ds.num_prop_per_frm)


def test_pipelined_error_resolves_future(setup):
    _, batch, _, pred = setup
    reqs = batch_to_requests(batch)
    loop = ServingLoop(pred, max_batch=4, max_wait_ms=1.0, pipeline_depth=2)
    try:
        bad = dict(reqs[0])
        bad["tokens"] = np.array(["x"] * len(reqs[0]["tokens"]))
        with pytest.raises(Exception):
            loop.submit(bad).result(timeout=60)
        assert np.isfinite(loop(reqs[0])["pred_score"]).all()
    finally:
        loop.close()


def test_predictor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    pcfg = port_cfg(_cfg(tiny=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(pcfg, None, VOCAB)
