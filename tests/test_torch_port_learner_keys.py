"""The Learner's last single-device keys in the port, on the CPU at narrow
widths (the fixture and the production-path config of
``test_torch_port_learner.py``: device and annotation tables, index-only
batches, SPAT VOGNet, fp32 "highest", dropout 0), against
``vog_tpu.train.Learner`` where it has the key.

  * ``misc.checkify``: with the JAX Learner's initial parameters, both
    Learners run one epoch of the image-grounding model under checkify (one step a dispatch on both
    sides, K ignored): every step's loss finite and within 2e-4 relative
    (the Learner's bound).  A NaN written into the props (the feature
    table) raises on both sides, the port's ``CheckifyError`` naming an
    op; an integer division by zero in a checked function raises on both
    sides; a NaN that a backward kernel's wrapper writes where no aten op
    sees it is caught and named by the kernel.
  * ``misc.tensorboard_dir``: in the same run, both Learners' event files,
    read back with tensorboard's event reader, hold the same tags at the
    same steps; the losses within 2e-4 relative, the metrics that count
    (acc, vacc, strict_acc, cons, num_pairs, num_queries) equal, val_loss
    within 1e-3 relative (``test_learner_tracks_jax_learner``'s bound),
    the epoch equal, and the two timings (train_time_s, pairs_per_sec)
    present.  Without the ``tensorboard`` package the port logs "off" and
    trains on.
  * ``train.async_ckpt``: ``save(blocking=False)`` returns before its file
    lands (a writer held at ``torch.save`` shows it); ``load`` after an
    asynchronous save is bitwise the saved state; a SIGTERM resume from
    asynchronous periodic and epoch saves is bitwise the uninterrupted
    run; a failed write raises at ``wait_for_checkpoints`` and at the
    next ``save``, once.
  * ``misc.profile_dir``: a CPU Chrome trace is written, and it covers the
    second dispatch of the epoch and not the first or the third.
  * The artifact on the CPU replays eagerly: no graph, outputs bitwise the
    live predictor's.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import checkify as jcheckify

from tests.test_torch_port_export import B as EXPORT_B
from tests.test_torch_port_export import _request, setup  # noqa: F401  (the export fixture)
from tests.test_torch_port_learner import (  # noqa: F401  (fx, one_thread: the module's fixtures)
    LOSS_RTOL,
    _cfg,
    _events,
    _port_learner,
    _sigterm_after,
    fx,
    one_thread,
)
from vog_tpu_torch.export import ExportedPredictor, export_predictor
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.train import checkify

COUNTS = ("acc", "vacc", "strict_acc", "cons", "num_pairs", "num_queries", "epoch")
TIMINGS = ("train_time_s", "pairs_per_sec")


@pytest.fixture(scope="module")
def keyed(fx, tmp_path_factory):
    """One epoch of each Learner with ``misc.checkify`` and
    ``misc.tensorboard_dir`` on, the port from the JAX Learner's initial
    parameters."""
    from vog_tpu.data import get_data as jget_data
    from vog_tpu.train import Learner as JLearner
    from vog_tpu.train import make_mesh

    tmp = tmp_path_factory.mktemp("keys")
    # the image-grounding model: the JAX step with the checks compiled in
    # builds in seconds (VOGNet's, with the mm kernel interpreted, in minutes)
    over = {"misc.checkify": True, "mdl.name": "img_grnd"}
    cfg = _cfg(fx, tmp / "jax", **over, **{"misc.tensorboard_dir": str(tmp / "tb_jax")})
    jl = JLearner("jx", jget_data(cfg, global_batch_size=cfg.train.bs), cfg, mesh=make_mesh(cfg))
    jparams = jax.tree.map(np.asarray, jax.device_get(jl.state.params))
    jlosses, orig = [], jl._train_step

    def record(*a, **kw):
        out = orig(*a, **kw)
        jlosses.append(float(out[1]["loss"]))
        return out

    jl._train_step = record
    jl.fit()
    pl = _port_learner(fx, tmp / "port", "pt", **over, **{"misc.tensorboard_dir": str(tmp / "tb_port")})
    pl.model.load_state_dict(params_from_jax(jparams, pl.cfg), strict=True)
    pl.fit()
    return dict(jl=jl, pl=pl, jlosses=jlosses, tmp=tmp)


def test_checkify_steps_track_the_jax_checkify_learner(keyed):
    pl, jl = keyed["pl"], keyed["jl"]
    assert pl.K == 1 and jl._multi == 0  # K ignored under checkify on both sides
    assert "train.steps_per_dispatch disabled" in pl.log_file.read_text()
    plosses = [v for r in _events(pl, "log") for v in r["losses"]]
    assert len(plosses) == len(keyed["jlosses"]) == 8 and all(np.isfinite(plosses))
    np.testing.assert_allclose(plosses, keyed["jlosses"], rtol=LOSS_RTOL)
    assert not pl.state.graphs


def test_checkify_nan_in_props_raises_on_both_sides(keyed):
    pl, jl = keyed["pl"], keyed["jl"]
    # the JAX side: its checked step on a batch of the epoch, the feature table NaN
    jbatch = next(iter(jl.data.train_dl))
    jtables = {**jl._tables, "feats": jnp.full_like(jl._tables["feats"], jnp.nan)}
    with pytest.raises(Exception):  # checkify's JaxRuntimeError
        _, aux = jl._train_step(jax.tree.map(jnp.copy, jl.state), jbatch, jl.rng, jtables)
        float(aux["loss"])
    # the port: the same through its dispatch; the first op with a NaN is
    # the gather of the props, in the step before the model
    stacked = next(iter(pl.data.train_dl))
    tables = {**pl._tables, "feats": torch.full_like(pl._tables["feats"], float("nan"))}
    with pytest.raises(checkify.CheckifyError, match=r"nan generated by vog\.gather_rows\.default in the step "
                                                     r"outside any module \(check \d+ of \d+ in the step\)"):
        pl._train_multi(pl.state, stacked, pl.seed, tables)


def test_checkify_integer_division_by_zero_raises():
    x, y = np.arange(6, dtype=np.int32), np.array([1, 2, 0, 3, 1, 2], np.int32)
    err, _ = jcheckify.checkify(lambda a, b: a // b, errors=jcheckify.float_checks | jcheckify.div_checks)(
        jnp.asarray(x), jnp.asarray(y))
    with pytest.raises(Exception, match="division by zero"):
        err.throw()

    def checked(f):
        with checkify.Checker() as c:
            out = f(torch.from_numpy(x), torch.from_numpy(y))
        c.check()
        return out

    with pytest.raises(checkify.CheckifyError, match="division by zero in aten"):
        checked(lambda a, b: a // b)
    with pytest.raises(checkify.CheckifyError, match="division by zero in aten"):
        checked(lambda a, b: torch.remainder(a, b))
    with pytest.raises(checkify.CheckifyError, match="nan generated by aten.sqrt"):
        checked(lambda a, b: torch.sqrt(a.float() - 3.0))
    assert torch.equal(checked(lambda a, b: a // (b + 1)), torch.from_numpy(x // (y + 1)))  # clean: no raise


def test_checkify_catches_nan_from_a_backward_kernel(fx, tmp_path, monkeypatch):
    """The head's backward gradients with a NaN written in place by numpy,
    as a raw kernel writes them: no aten op produces it, the kernel check
    names the kernel."""
    from vog_tpu_torch.kernels import grounding_head

    lrn = _port_learner(fx, tmp_path, "bwd", **{"misc.checkify": True})
    real = grounding_head.grounding_head_bwd

    def poisoned(*a, **kw):
        grads = real(*a, **kw)
        grads[4].detach().numpy().reshape(-1)[0] = np.nan  # dwx, behind the dispatcher's back
        return grads

    monkeypatch.setattr(grounding_head, "grounding_head_bwd", poisoned)
    stacked = next(iter(lrn.data.train_dl))
    with pytest.raises(checkify.CheckifyError, match="kernel fused_grounding_head_bwd in the backward of "
                                                     "FusedGroundingHeadBackward"):
        lrn._train_multi(lrn.state, stacked, lrn.seed, lrn._tables)


def _scalars(logdir):
    """tag -> {step: value} of every event file under ``logdir``."""
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
    from tensorboard.util import tensor_util

    out = {}
    files = sorted(logdir.rglob("events.out.tfevents.*"))
    assert files, logdir
    for f in files:
        for ev in EventFileLoader(str(f)).Load():
            for v in ev.summary.value:
                val = v.simple_value if v.HasField("simple_value") else float(tensor_util.make_ndarray(v.tensor))
                out.setdefault(v.tag, {})[ev.step] = val
    return out


def test_tensorboard_matches_the_jax_learner(keyed):
    tmp = keyed["tmp"]
    got, want = _scalars(tmp / "tb_port" / "pt"), _scalars(tmp / "tb_jax" / "jx")
    assert set(got) == set(want) and {"train/loss", "train/loss_smooth", "valid/acc"} <= set(got)
    for tag, ref in want.items():
        assert sorted(got[tag]) == sorted(ref), tag
        name = tag.split("/", 1)[1]
        g, r = np.array([got[tag][s] for s in sorted(ref)]), np.array([ref[s] for s in sorted(ref)])
        if tag.startswith("train/"):
            np.testing.assert_allclose(g, r, rtol=LOSS_RTOL, err_msg=tag)
        elif name == "val_loss":
            np.testing.assert_allclose(g, r, rtol=1e-3, err_msg=tag)
        elif name in COUNTS:
            np.testing.assert_array_equal(g, r, err_msg=tag)
        else:
            assert name in TIMINGS and np.all(np.isfinite(g)), tag
    assert sorted(got["train/loss"]) == list(range(1, 9))  # it_pos + epoch * len(train_dl), each step


def test_tensorboard_off_without_the_package(fx, tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the card's host has no tensorboard
    lrn = _port_learner(fx, tmp_path, "notb", **{"misc.tensorboard_dir": str(tmp_path / "tb")})
    m = lrn.fit()
    assert np.isfinite(m["val_loss"])
    assert "misc.tensorboard_dir set but tensorboard missing — off" in lrn.log_file.read_text()
    assert not (tmp_path / "tb").exists()


@pytest.fixture()
def held_writer(monkeypatch):
    """``torch.save`` on the checkpoint writer's thread waits for the
    returned event (or raises the exception put in ``fail``)."""
    gate, fail, real = threading.Event(), [], torch.save

    def save(*a, **kw):
        if threading.current_thread().name.startswith("ckpt-writer"):
            assert gate.wait(timeout=60)
            if fail:
                raise fail[0]
        return real(*a, **kw)

    monkeypatch.setattr(torch, "save", save)
    return gate, fail


def test_async_save_returns_before_the_file_lands(fx, tmp_path, held_writer):
    gate, _ = held_writer
    lrn = _port_learner(fx, tmp_path, "async")
    path = lrn.ckpt_path("held")
    want = lrn.state.snapshot()
    assert lrn.save("held", blocking=False) == path
    assert not path.exists()  # the writer is held: the loop went on
    with torch.no_grad():
        for p in lrn.model.parameters():
            p.add_(1.0)  # the state moves on after the copy
    gate.set()
    lrn.wait_for_checkpoints()
    saved = torch.load(path, weights_only=True)
    for k, v in want.items():
        assert torch.equal(saved["state"][k], v), k
    rec = _events(lrn, "save")[-1]
    assert rec["tag"] == "held" and rec["blocking"] is False and rec["bytes"] == path.stat().st_size


def test_load_after_async_save_is_bitwise(fx, tmp_path):
    lrn = _port_learner(fx, tmp_path, "reload")
    lrn.fit(epochs=1)
    want = lrn.state.snapshot()
    lrn.save("mid", blocking=False)
    lrn.fit(epochs=1)  # moves the state in place
    lrn.load(tag="mid")  # waits for the write first
    got = lrn.state.tensors()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_sigterm_resume_from_async_saves_is_bitwise(fx, tmp_path):
    over = {"train.epochs": 2, "train.steps_per_dispatch": 3, "train.log_every": 10, "train.ckpt_every_steps": 3,
            "train.async_ckpt": True}
    full = _port_learner(fx, tmp_path, "full", **over)
    full.fit()
    want = full.state.snapshot()

    pre = _port_learner(fx, tmp_path, "cut", **over)
    _sigterm_after(pre, 5)  # epoch 1's second dispatch
    pre.fit()
    saves = _events(pre, "save")
    assert [s["blocking"] for s in saves] == [False] * (len(saves) - 1) + [True]  # periodic and epoch, then SIGTERM
    assert len(saves) >= 5 and saves[-1]["batch_in_epoch"] == 6

    res = _port_learner(fx, tmp_path, "cut", **{**over, "train.resume": True})
    assert (res.epoch, res.batch_in_epoch) == (1, 6)
    res.fit()
    got = res.state.tensors()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_failed_write_surfaces_at_wait_and_next_save(fx, tmp_path, held_writer):
    gate, fail = held_writer
    fail.append(OSError("no space left on device"))
    lrn = _port_learner(fx, tmp_path, "fails")
    lrn.save("a", blocking=False)  # returns: the write fails later
    gate.set()
    with pytest.raises(OSError, match="no space left"):
        lrn.wait_for_checkpoints()
    lrn.wait_for_checkpoints()  # raised once
    lrn.save("b", blocking=False)
    lrn._writer._pending[-1].exception(timeout=60)
    with pytest.raises(OSError, match="no space left"):
        lrn.save("c", blocking=False)
    fail.clear()
    lrn.save("d")
    assert lrn.ckpt_path("d").exists() and not lrn.ckpt_path("a").exists()


def test_profile_dir_traces_the_second_dispatch(fx, tmp_path):
    # K=2 and 8 batches: dispatches at it 0, 2, 4, 6; profile_steps 3: the
    # trace starts at the second (it 2) and stops after it (2 + 2 > 3)
    lrn = _port_learner(fx, tmp_path, "prof", **{"misc.profile_dir": str(tmp_path / "prof"),
                                                 "misc.profile_steps": 3})
    lrn.fit()
    trace = tmp_path / "prof" / "prof.ep0.trace.json"
    assert trace.is_file()
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "train dispatch at it 2" in names
    assert not {"train dispatch at it 0", "train dispatch at it 4"} & names
    assert any(n and n.startswith("aten::") for n in names)  # the dispatch's ops are in it
    assert [r["path"] for r in _events(lrn, "profile")] == [str(trace)]


def test_artifact_replays_eagerly_on_the_cpu(setup, tmp_path):  # noqa: F811
    pred = setup["pred"]
    rep = ExportedPredictor(export_predictor(pred, EXPORT_B, tmp_path / "a", with_tables=True), device="cpu",
                            cuda_graphs=True)
    assert rep.cuda_graphs is False
    req = _request(setup, True)
    got, live = rep(req), pred(req)
    for k in live:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)
    assert rep.graphs == {}
