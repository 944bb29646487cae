"""Checkpoints into the port's serving path, on the CPU at small widths.

  * ``Predictor.from_checkpoint`` on a port Learner's save scores a batch
    bitwise as the Learner's own model does (same device, same params).
  * A ``vog_tpu`` Learner's orbax checkpoint, converted by
    ``tools/orbax_to_torch_port.py``, serves in the port like
    ``vog_tpu.serve.Predictor.from_checkpoint``: scores within 2e-4 x
    max(1, max|score|), argmaxes equal where the top-2 margin is clear
    (``test_torch_port_serve.py §_check_against``).  The converted file
    carries the optimizer: Adam's count, the guard's counters, the step and
    the meta as the JAX run saved them, and moments whose sums match the
    JAX moments' (a transpose keeps a sum) with the embedding's bitwise.
  * A checkpoint with the pre-round-2 head names (``head/fuse_vis/kernel``)
    and no optimizer state takes the fallback: params and step only, folded
    as ``_migrate_head_params`` folds them; it serves alike, and the port's
    ``Learner.load`` starts the moments fresh and logs it.
  * A resume from an epoch that improved the best metric knows it (the
    JAX Learner saves "last" before it updates the best metric).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from tests.conftest import small_cfg
from tests.test_torch_port_learner import one_thread  # noqa: F401  (the module's Learners on one thread)
from tests.test_torch_port_model import port_cfg
from tests.test_torch_port_serve import _check_against
from vog_tpu.data import get_data as jget_data
from vog_tpu.serve import Predictor as JPredictor
from vog_tpu.train import Learner as JLearner
from vog_tpu.train import make_mesh
from vog_tpu_torch.data.loader import get_data
from vog_tpu_torch.serve import Predictor, predict_batch
from vog_tpu_torch.train.learner import Learner

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import orbax_to_torch_port as tool  # noqa: E402

OVER = {"mdl.name": "vog", "ds.conc_type": "spat", "train.bs": 4, "train.epochs": 1, "misc.mesh_data": 1,
        "train.log_every": 1000, "train.skip_nonfinite": 3, "misc.progress": "off"}


@pytest.fixture(scope="module")
def jax_run(fixture_dir, tmp_path_factory):
    """One epoch of the JAX Learner (VOGNet, SPAT), saved by orbax."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    cfg = small_cfg(fixture_dir, **OVER)
    cfg.misc.tmp_path = str(tmp / "tmp")
    data = jget_data(cfg, global_batch_size=cfg.train.bs)
    lrn = JLearner("jrun", data, cfg, mesh=make_mesh(cfg))
    lrn.fit()
    lrn.wait_for_checkpoints()
    return cfg, data, lrn, tmp / "tmp" / "models" / "jrun" / "last"


def _valid_batch(data):
    return {k: np.asarray(v) for k, v in next(iter(data.valid_dl)).items()}


def test_from_checkpoint_scores_as_the_learner(fixture_dir, tmp_path):
    cfg = port_cfg(small_cfg(fixture_dir, **{**OVER, "ds.device_store": "on", "ds.ann_store": "off",
                                            "misc.tmp_path": str(tmp_path)}))
    data = get_data(cfg)
    lrn = Learner("port", data, cfg, device="cpu")
    lrn.fit()
    pred = Predictor.from_checkpoint(cfg, lrn.ckpt_path("last"), tables=lrn._tables, device="cpu",
                                     glove=data.vocab.vectors)
    batch = next(iter(data.valid_dl))
    assert "vid_rows" in batch
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items() if k not in ("ann_idx",)}
    with torch.inference_mode():
        ref = predict_batch(lrn.model.eval(), cfg.ds.conc_type, batch, lrn._tables)
        got = pred.predict(batch)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_orbax_checkpoint_converts_and_serves(jax_run, tmp_path):
    cfg, data, lrn, ckpt = jax_run
    pcfg = port_cfg(cfg)
    out = tool.convert(ckpt, tmp_path / "models" / "jrun" / "last.pt", cfg, pcfg, uid="jrun")
    assert out["full"] and not out["stale"]
    glove = data.vocab.vectors
    batch = _valid_batch(data)
    ref = JPredictor.from_checkpoint(cfg, glove, ckpt)(batch)
    got = Predictor.from_checkpoint(pcfg, tmp_path / "models" / "jrun" / "last.pt", device="cpu", glove=glove)(batch)
    _check_against({k: np.asarray(v) for k, v in ref.items()}, got, cfg.ds.num_prop_per_frm)


def test_converted_checkpoint_carries_the_optimizer(jax_run, tmp_path):
    cfg, data, lrn, ckpt = jax_run
    pcfg = port_cfg(cfg)
    pcfg.misc.tmp_path = str(tmp_path)
    path = tmp_path / "conv.pt"
    tool.convert(ckpt, path, cfg, pcfg, uid="jrun")
    port = Learner("resume", get_data(pcfg), pcfg, device="cpu")
    port.load(str(path))
    adam, guard = tool._adam_and_guard(lrn.state.opt_state)
    st = port.state.tensors()
    assert int(st["step"]) == int(lrn.state.step) > 0
    assert int(st["opt:count"]) == int(adam.count) == int(lrn.state.step)
    assert int(st["opt:notfinite_count"]) == int(guard.notfinite_count)
    assert int(st["opt:total_notfinite"]) == int(guard.total_notfinite)
    meta = json.loads((ckpt.parent / "last.meta.json").read_text())
    assert (port.epoch, port.batch_in_epoch) == (meta["epoch"], meta["batch_in_epoch"])
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        leaves = [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]
        ref = sum(x.sum() for x in leaves)
        assert float(st[f"opt:{key}"].double().sum()) == pytest.approx(ref, rel=1e-9, abs=1e-12)
        emb = port.state.leaves(st[f"opt:{key}"])["lang.embed.weight"]
        np.testing.assert_array_equal(emb.numpy(), np.asarray(tree["lang"]["embed"]))
    assert float(st["opt:nu"].abs().max()) > 0


def _pre_round_2(params):
    """The params with the head's flat names split into the old Dense
    scopes (``fuse_vis_kernel`` -> ``fuse_vis/kernel``)."""
    from flax import traverse_util

    out = {}
    for path, leaf in traverse_util.flatten_dict(params).items():
        name = path[-1]
        for dense in JLearner._HEAD_DENSE_NAMES:
            for part in ("kernel", "bias"):
                if name == f"{dense}_{part}":
                    path = path[:-1] + (dense, part)
        out[path] = leaf
    return traverse_util.unflatten_dict(out)


def test_orbax_fallback_with_pre_round_2_head_names(jax_run, tmp_path):
    import orbax.checkpoint as ocp

    cfg, data, lrn, ckpt = jax_run
    params = jax.tree.map(np.asarray, lrn.state.params)
    old = _pre_round_2(params)
    assert old != params
    legacy = (tmp_path / "legacy").absolute()
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(legacy, {"params": old, "step": np.asarray(lrn.state.step)})
    ckptr.wait_until_finished()
    pcfg = port_cfg(cfg)
    pcfg.misc.tmp_path = str(tmp_path / "tmp")
    out_path = tmp_path / "legacy.pt"
    out = tool.convert(legacy, out_path, cfg, pcfg)
    assert not out["full"] and out["step"] == int(lrn.state.step)
    saved = torch.load(out_path, weights_only=True)["state"]
    assert not any(k.startswith("opt:") for k in saved)
    glove = data.vocab.vectors
    batch = _valid_batch(data)
    ref = JPredictor.from_checkpoint(cfg, glove, ckpt)(batch)
    got = Predictor.from_checkpoint(pcfg, out_path, device="cpu", glove=glove)(batch)
    _check_against({k: np.asarray(v) for k, v in ref.items()}, got, cfg.ds.num_prop_per_frm)
    port = Learner("legacy", get_data(pcfg), pcfg, device="cpu")
    port.load(str(out_path))
    st = port.state.tensors()
    assert int(st["step"]) == int(lrn.state.step) and int(st["opt:count"]) == 0
    assert float(st["opt:mu"].abs().max()) == 0.0
    assert "parameters and step only" in port.log_file.read_text()


def test_resume_keeps_the_last_epochs_best_metric(fixture_dir, tmp_path):
    """An epoch that improves the best metric has it in its "last" save, so
    a resume from there does not let a worse epoch overwrite "best"."""
    cfg = port_cfg(small_cfg(fixture_dir, **{**OVER, "misc.tmp_path": str(tmp_path)}))
    lrn = Learner("best", get_data(cfg), cfg, device="cpu")
    m = lrn.fit()
    assert lrn.best_metric == m["acc"]
    again = Learner("best", get_data(cfg), cfg, device="cpu")
    again.load(tag="last")
    assert again.best_metric == m["acc"] and again.epoch == 1
