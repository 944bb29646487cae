"""The port's deployment artifact (``vog_tpu_torch/export.py``) on the CPU,
at small widths (VOGNet, SPAT, the resident-table setup of
``test_torch_port_serve.py``).

  * The replay equals the live ``Predictor`` bitwise: in the f32 encoding,
    with tables (``vid_rows`` requests), and in bf16 and int8, where the
    live predictor gets the request the artifact decodes (the encoding's
    rounding applied on the host, exactly).
  * ``encode_features`` is bitwise ``vog_tpu.export.encode_features``
    (bf16 compared as bits).
  * The program holds the forward ops as nodes: flash, mm and the head
    once each, the gather once a table read (feats and seg), none without
    tables; it keeps no example inputs (the tables travel in tables.pt).
  * The schema is enforced (a missing key, a wrong shape), and the load
    sets the exported precision; the artifact drops into ``ServingLoop``,
    which refuses ``bucket_sizes`` around it.
  * Against ``vog_tpu.export.ExportedPredictor`` on the same params, tables
    and requests: scores within 2e-4 x max(1, max|score|), argmaxes equal
    where the top-2 margin is clear (``_check_against``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_port_model import port_cfg
from tests.test_torch_port_serve import VOCAB, _check_against
from vog_tpu import export as jexport
from vog_tpu.data.device_store import _pack_rows
from vog_tpu.serve import Predictor as JPredictor
from vog_tpu.train.state import init_state
from vog_tpu_torch.data.device_store import DeviceFeatureTables
from vog_tpu_torch.export import ExportedPredictor, encode_features, export_predictor, forward_op_counts
from vog_tpu_torch.serve import Predictor
from vog_tpu_torch.serving import ServingLoop, batch_to_requests
from __graft_entry__ import _cfg, _glove, _random_batch

B = 4
N_ROWS = 9


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(tiny=True)
    cfg.mdl.dropout = 0.0
    cfg.misc.half_feats = True
    glove = _glove(cfg, VOCAB)
    state = init_state(cfg, glove, jax.random.PRNGKey(0), B)
    ds = cfg.ds
    rng = np.random.default_rng(7)
    feats = rng.normal(scale=0.3, size=(N_ROWS, ds.num_frms, ds.num_prop_per_frm, ds.prop_dim)).astype(np.float32)
    seg = rng.normal(scale=0.3, size=(N_ROWS, ds.num_frms, ds.seg_dim)).astype(np.float32)
    batch = _random_batch(cfg, B, seed=3)
    batch["tokens"] = rng.integers(2, VOCAB, batch["tokens"].shape).astype(np.int32)
    batch["prop_mask"][1, 2, :, 3] = 0.0
    batch = {k: v.astype(np.uint8) if k in ("targets", "prop_mask", "srl_arg_mask", "batch_mask") else v
             for k, v in batch.items()}
    batch.pop("gt_frame_mask", None)
    rows = batch.copy()
    del rows["props"], rows["seg_feats"]
    rows["vid_rows"] = rng.integers(0, N_ROWS, (B, ds.num_cmp)).astype(np.int32)
    pcfg = port_cfg(cfg)
    tables = DeviceFeatureTables.from_arrays(pcfg, feats, seg, half=True, device="cpu")
    params = jax.tree.map(np.asarray, state.params)
    pred = Predictor(pcfg, params, VOCAB, tables=tables.tables, device="cpu")
    return dict(cfg=cfg, pcfg=pcfg, glove=glove, state=state, feats=feats, seg=seg, batch=batch, rows=rows,
                pred=pred)


def _request(s, with_tables):
    keep = set(jexport.request_spec(s["cfg"], B, vid_rows=with_tables))
    return {k: v for k, v in (s["rows"] if with_tables else s["batch"]).items() if k in keep}


def _decoded(req, enc):
    """The request the artifact sees after it decodes ``enc``."""
    if enc == "f32":
        return req
    q = encode_features(req, enc)
    out = dict(req)
    for k, sk in (("props", "props_scale"), ("seg_feats", "seg_scale")):
        if enc == "bf16":
            out[k] = (q[k].astype(np.uint32) << 16).view(np.float32)
        else:
            out[k] = q[k].astype(np.float32) * q[sk][..., None]
    return out


@pytest.mark.parametrize("enc,with_tables", [("f32", False), ("f32", True), ("bf16", False), ("int8", False)])
def test_replay_equals_live_predictor(setup, tmp_path, enc, with_tables):
    pred = setup["pred"]
    path = export_predictor(pred, B, tmp_path / "a", feature_encoding=enc, with_tables=with_tables)
    assert (path / "tables.pt").exists() == with_tables
    rep = ExportedPredictor(path, device="cpu")
    assert rep.batch_size == B and rep.manifest["device"] == "cpu"
    assert rep.manifest["feature_encoding"] == enc and rep.manifest["with_tables"] == with_tables
    req = _request(setup, with_tables)
    got, live = rep(req), pred(_decoded(req, enc))
    assert set(got) == set(live)
    for k in live:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)
    ep = torch.export.load(str(path / "program.pt2"))
    assert forward_op_counts(ep.graph) == {"gather_rows": 2 if with_tables else 0, "flash_attention_fwd": 1,
                                           "mm_attention_fwd": 1, "grounding_head_fwd": 1}
    assert ep.example_inputs is None  # the tables travel in tables.pt only


@pytest.mark.parametrize("enc", ["f32", "bf16", "int8"])
def test_encode_features_bitwise_jax(setup, enc):
    req = _request(setup, False)
    ref, got = jexport.encode_features(req, enc), encode_features(req, enc)
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        if enc == "bf16" and k in ("props", "seg_feats"):
            r = r.view(np.uint16)
        assert got[k].dtype == r.dtype, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)


def test_schema_enforced(setup, tmp_path):
    rep = ExportedPredictor(export_predictor(setup["pred"], B, tmp_path / "s"), device="cpu")
    req = _request(setup, False)
    with pytest.raises(KeyError, match="tokens"):
        rep({k: v for k, v in req.items() if k != "tokens"})
    with pytest.raises(ValueError, match="shape"):
        rep({**req, "tokens": req["tokens"][:, :5]})
    # the precision it was exported at: the TF32 switches as the live Predictor sets them
    manifest = tmp_path / "s" / "manifest.json"
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    manifest.write_text(manifest.read_text().replace('"matmul_precision": "highest"', '"matmul_precision": "default"'))
    try:
        ExportedPredictor(tmp_path / "s", device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    # an artifact replays on the device type it was exported on
    manifest.write_text(manifest.read_text().replace('"device": "cpu"', '"device": "cuda"'))
    with pytest.raises(ValueError, match="exported on cuda"):
        ExportedPredictor(tmp_path / "s", device="cpu")


def test_serving_loop_drop_in_and_buckets_raise(setup, tmp_path):
    rep = ExportedPredictor(export_predictor(setup["pred"], B, tmp_path / "l", with_tables=True), device="cpu")
    reqs = batch_to_requests(_request(setup, True))
    with pytest.raises(ValueError, match=r"bucket_sizes is incompatible with a fixed-shape predictor \(batch_size=4\)"):
        ServingLoop(rep, max_batch=B, bucket_sizes=[1, 2])
    live = setup["pred"](_request(setup, True))
    loop = ServingLoop(rep, max_batch=B, max_wait_ms=5.0, pipeline_depth=2)
    try:
        outs = [f.result(timeout=120) for f in [loop.submit(r) for r in reqs[:3]]]
    finally:
        loop.close()
    for i, o in enumerate(outs):
        for k in ("pred_vid", "pred_prop", "pred_score"):
            np.testing.assert_array_equal(o[k], live[k][i], err_msg=k)


def test_serving_loop_refuses_buckets_around_any_fixed_shape_predictor():
    class Fixed:
        batch_size = 8

        def __call__(self, batch):
            raise AssertionError("never called")

    with pytest.raises(ValueError, match="bucket_sizes=None"):
        ServingLoop(Fixed(), max_batch=8, bucket_sizes=[1, 2, 4])
    loop = ServingLoop(Fixed(), max_batch=8, pipeline_depth=1)  # no buckets: fine
    loop.close()


def test_replay_agrees_with_jax_exported_predictor(setup, tmp_path):
    cfg, glove = setup["cfg"], setup["glove"]
    jtables = {k: jnp.asarray(v) for k, v in
               _pack_rows({"feats": setup["feats"], "seg": setup["seg"]}, jnp.bfloat16, False).items()}
    jpred = JPredictor(cfg, setup["state"].params, glove, tables=jtables)
    jrep = jexport.ExportedPredictor(jexport.export_predictor(jpred, B, tmp_path / "j.vogx", with_tables=True))
    rep = ExportedPredictor(export_predictor(setup["pred"], B, tmp_path / "p", with_tables=True), device="cpu")
    req = _request(setup, True)
    ref = {k: np.asarray(v) for k, v in jrep(req).items()}
    _check_against(ref, rep(req), cfg.ds.num_prop_per_frm)
