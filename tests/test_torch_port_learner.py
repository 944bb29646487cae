"""The port's Learner and CLIs on the CPU, at narrow widths.

  * Against ``vog_tpu.train.Learner``: one epoch on the same fixture (the
    production path: device feature tables and annotation tables, index-only
    batches, SPAT VOGNet, K=2 train steps and E=2 eval batches a dispatch),
    the JAX Learner's initial parameters carried over by ``params_from_jax``,
    dropout 0, fp32 with "highest".  Every step's loss within 2e-4 relative
    (every dispatch is a log point at ``log_every`` 1: the bound covers more
    than the log points); the final eval within one query (|n_strict| and
    |n_cons| by at most 1, |n_acc| and |n_vacc| by at most the pairs of one
    query); the port's predictions pickle scores the port's metrics exactly
    through both packages' ``eval_fun``.
  * Mid-epoch resume after a SIGTERM (delivered to the process after a
    dispatch) is bitwise equal to the uninterrupted run: every parameter,
    moment, guard counter and the step count.
  * A run driven non-finite raises ``FloatingPointError`` at the first
    dispatch whose guard count passes ``skip_nonfinite``, and no "last"
    after that dispatch is written (the periodic save runs every dispatch).
  * ``ProgressBar``'s first ``update`` draws, whatever the host's clock.
  * ``cli.train.main([... "--misc.platform=cpu"])`` writes its logs,
    checkpoints and predictions; ``cli.eval`` re-scores "best" to the same
    metrics, and a predictions file offline; without the flag and without a
    GPU, both raise.
"""

import json
import os
import pickle
import signal

import numpy as np
import pytest
import torch

import jax

from tests.conftest import SMALL, small_cfg
from tests.test_torch_port_model import port_cfg
from vog_tpu_torch.cli import eval as peval_cli
from vog_tpu_torch.cli import train as ptrain_cli
from vog_tpu_torch.data.fixtures import generate_fixture
from vog_tpu_torch.data.loader import get_data
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.train.learner import Learner
from vog_tpu_torch.train.progress import ProgressBar

LOSS_RTOL = 2e-4
SUMS = ("n_acc", "n_vacc", "n_strict", "n_cons")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's Learners on one intra-op thread: a Learner runs many
    small ops, and with the suite's workers sharing the cores the thread
    pool's waits for its descheduled threads slow each op a hundredfold (a
    resume test of 1 s alone took 400 s among the workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_learner_fx")
    generate_fixture(d, n_train=16, n_valid=8, n_test=4, num_props=5, seed=2, **SMALL)
    return d


def _cfg(fx, tmp, **over):
    base = {"ds.conc_type": "spat", "mdl.name": "vog", "ds.device_store": "on", "ds.ann_store": "on",
            "train.bs": 2, "train.epochs": 1, "train.log_every": 1, "train.steps_per_dispatch": 2,
            "train.eval_batches_per_dispatch": 2, "train.lr": 1e-3, "train.lr_schedule": "cosine",
            "train.warmup_steps": 2, "train.pos_weight": 5.0, "train.skip_nonfinite": 3,
            "misc.mesh_data": 1, "misc.progress": "off", "misc.tmp_path": str(tmp)}
    base.update(over)
    return small_cfg(fx, **base)


def _port_learner(fx, tmp, uid, **over):
    pcfg = port_cfg(_cfg(fx, tmp, **over))
    return Learner(uid, get_data(pcfg), pcfg, device="cpu")


def _events(lrn, kind):
    with open(lrn.events_log) as f:
        return [r for r in map(json.loads, f) if r["event"] == kind]


def _sums(metrics):
    return {"n_acc": metrics["acc"] * metrics["num_pairs"], "n_vacc": metrics["vacc"] * metrics["num_pairs"],
            "n_strict": metrics["strict_acc"] * metrics["num_queries"],
            "n_cons": metrics["cons"] * metrics["num_queries"]}


def test_learner_tracks_jax_learner(fx, tmp_path):
    from vog_tpu.data import get_data as jget_data
    from vog_tpu.evaluation.offline import eval_fun as jeval_fun
    from vog_tpu.train import Learner as JLearner
    from vog_tpu.train import make_mesh
    from vog_tpu_torch.evaluation.offline import eval_fun as peval_fun

    cfg = _cfg(fx, tmp_path / "jax")
    jl = JLearner("jx", jget_data(cfg, global_batch_size=cfg.train.bs), cfg, mesh=make_mesh(cfg))
    jparams = jax.tree.map(np.asarray, jax.device_get(jl.state.params))
    jlosses = []
    orig = jl._train_step_multi

    def record(*a, **kw):
        state, aux = orig(*a, **kw)
        jlosses.extend(np.asarray(aux["loss"]).reshape(-1).tolist())
        return state, aux

    jl._train_step_multi = record
    jm = jl.fit()

    pl = _port_learner(fx, tmp_path / "port", "pt")
    assert pl._tables is not None and "ann_i32" in pl._tables and pl.K == 2 and pl.E == 2
    pl.model.load_state_dict(params_from_jax(jparams, pl.cfg), strict=True)
    pm = pl.fit()
    plosses = [v for r in _events(pl, "log") for v in r["losses"]]
    assert len(plosses) == len(jlosses) == 8 and all(np.isfinite(plosses))
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)
    assert pl.cfg.train.total_steps == jl.cfg.train.total_steps == 8

    pred = tmp_path / "port" / "predictions" / "pt_valid_0.pkl"
    with open(pred, "rb") as f:
        preds = pickle.load(f)
    one_query = max(len(p["arg_idx"]) for p in preds)
    assert pm["num_pairs"] == jm["num_pairs"] and pm["num_queries"] == jm["num_queries"]
    ps, js = _sums(pm), _sums(jm)
    for k in SUMS:
        assert abs(ps[k] - js[k]) <= (1 if k in ("n_strict", "n_cons") else one_query) + 1e-6, (k, ps[k], js[k])
    assert abs(pm["val_loss"] - jm["val_loss"]) <= 1e-3 * abs(jm["val_loss"])
    keys = ("acc", "vacc", "strict_acc", "cons", "num_pairs", "num_queries")
    for scored in (peval_fun(pred, "valid", pl.cfg), jeval_fun(pred, "valid", cfg)):
        assert {k: scored[k] for k in keys} == {k: pm[k] for k in keys}


def _sigterm_after(lrn, n):
    orig, calls = lrn._train_multi, {"n": 0}

    def step(*a, **kw):
        out = orig(*a, **kw)
        calls["n"] += 1
        if calls["n"] == n:
            os.kill(os.getpid(), signal.SIGTERM)  # the handler flags it; fit saves after this dispatch
        return out

    lrn._train_multi = step


def test_resume_after_sigterm_is_bitwise(fx, tmp_path):
    over = {"train.epochs": 2, "train.steps_per_dispatch": 3, "train.log_every": 10}
    full = _port_learner(fx, tmp_path, "full", **over)
    full.fit()
    want = full.state.snapshot()

    pre = _port_learner(fx, tmp_path, "cut", **over)
    _sigterm_after(pre, 5)  # epoch 1's second dispatch (an epoch is 3 dispatches: 3 + 3 + 2 batches)
    pre.fit()
    assert pre._preempted and pre.epoch == 1 and pre.batch_in_epoch == 6
    meta = torch.load(pre.ckpt_path("last"), weights_only=True)["meta"]
    assert meta["epoch"] == 1 and meta["batch_in_epoch"] == 6

    res = _port_learner(fx, tmp_path, "cut", **{**over, "train.resume": True})
    assert res.epoch == 1 and res.batch_in_epoch == 6 and int(res.state.step) == 14
    res.fit(epochs=1)  # the rest of epoch 1
    got = res.state.tensors()
    assert int(got["step"]) == 16
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert res.best_metric == full.best_metric


def test_guard_give_up_raises_before_the_save(fx, tmp_path):
    lrn = _port_learner(fx, tmp_path, "nan", **{"train.skip_nonfinite": 2, "train.ckpt_every_steps": 1,
                                                 "ds.ann_store": "off"})
    lrn._tables["feats"].fill_(float("nan"))  # every loss non-finite from the first step
    with pytest.raises(FloatingPointError, match="guard gave up"):
        lrn.fit()
    # dispatch 1 (steps 1-2, guard counts 1, 2) saved "last"; dispatch 2
    # (counts 3, 4 > 2) raised before its save
    saves = _events(lrn, "save")
    assert [s["batch_in_epoch"] for s in saves] == [2]
    meta = torch.load(lrn.ckpt_path("last"), weights_only=True)["meta"]
    assert meta["batch_in_epoch"] == 2


def test_progress_bar_first_update_draws(monkeypatch):
    import io

    from vog_tpu_torch.train import progress

    # a host booted 0.1 s ago: perf_counter() below the throttle interval
    monkeypatch.setattr(progress.time, "perf_counter", lambda: 0.1)
    out = io.StringIO()
    bar = ProgressBar(10, desc="ep 0", enabled=True, file=out, min_interval=0.25)
    bar.update(1)
    assert "1/10" in out.getvalue()


def _cli_args(fx, tmp, uid, *extra):
    return [uid, f"--ds.data_dir={fx}", f"--misc.tmp_path={tmp}", "--cfg=configs/gt5_production.yml",
            f"--ds.prop_dim={SMALL['prop_dim']}", f"--ds.seg_dim={SMALL['seg_dim']}",
            f"--ds.glove_dim={SMALL['glove_dim']}", f"--mdl.emb_dim={SMALL['glove_dim']}", "--mdl.lstm_dim=16",
            "--mdl.vis_dim=32", "--mdl.role_dim=8", "--mdl.n_heads=2", "--train.bs=2", "--train.epochs=2",
            "--train.steps_per_dispatch=3", "--train.eval_batches_per_dispatch=2", "--misc.progress=off", *extra]


@pytest.fixture()
def restore_precision():
    """The recipe's yml turns the TF32 switches on; later tests in this
    process expect PyTorch's defaults."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_cli_train_and_eval_on_cpu(fx, tmp_path, monkeypatch, restore_precision):
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tmp = tmp_path / "tmp"
    m = ptrain_cli.main(_cli_args(fx, tmp, "demo", "--misc.platform=cpu"))
    assert np.isfinite(m["val_loss"]) and m["epoch"] == 1
    for f in ("txt_logs/demo.txt", "ext_logs/demo.jsonl", "ext_logs/demo.events.jsonl", "models/demo/best.pt",
              "models/demo/last.pt", "predictions/demo_valid_0.pkl", "predictions/demo_valid_1.pkl"):
        assert (tmp / f).is_file(), f
    pred = tmp / "predictions" / "demo_valid_1.pkl"  # the last epoch's (cli.eval below writes its own)
    offline = peval_cli.main(_cli_args(fx, tmp, "demo", "--misc.platform=cpu", f"--pred_file={pred}"))
    assert offline["acc"] == m["acc"] and offline["strict_acc"] == m["strict_acc"]
    records = [json.loads(line) for line in open(tmp / "ext_logs" / "demo.jsonl")]
    best = max(records, key=lambda r: r["acc"])
    again = peval_cli.main(_cli_args(fx, tmp, "demo", "--misc.platform=cpu", "--tag=best"))
    assert again["acc"] == best["acc"] and again["num_pairs"] == best["num_pairs"]
    if not torch.cuda.is_available():
        for cli in (ptrain_cli, peval_cli):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main(_cli_args(fx, tmp_path / "gpu", "nogpu"))
    with pytest.raises(ValueError, match="misc.platform"):
        ptrain_cli.main(_cli_args(fx, tmp_path / "tpu", "tpu", "--misc.platform=tpu"))
