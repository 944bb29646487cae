"""The port's data-parallel input, eval gather and Learner on the CPU, in
worlds of two gloo processes (``tests/_torch_dist_worker.py``):

  * (3) ``BatchIterator.local_rows``: each rank's batches bitwise equal to
    its rows of the full batch and to the JAX loader's with the same
    ``local_rows`` (the valid split's last batch is short: its padded rows
    and sliced ``batch_mask`` too); ``get_data(cfg, mesh)`` sizes the
    global batch by the world, and the Learner sets each rank's rows;
  * (4) ``gather_eval`` over 2 ranks equal to ``vog_tpu``'s
    ``gather_eval`` on the concatenated inputs (sums summed, predictions in
    rank order), with empty sums and empty predictions;
  * (6) the Learner in a 2-rank world (row-sharded feature store,
    annotation tables, K=2 and E=2 a dispatch) against one process on the
    global batch of 4: two epochs, every step's loss within 1e-5 relative
    (fp32; the world splits each sum at the ranks and the difference grows
    with the steps), each epoch's metric counts equal and val_loss within
    1e-5 relative; only rank 0 writes (one line a log point, one
    predictions file an eval); and a run cut after its first epoch and
    resumed from rank 0's "last" by both ranks ends bitwise at the
    uninterrupted run's state; a SIGTERM on one rank stops both after the
    same dispatch; ``cli.train`` with ``--misc.multihost=true`` in a world.

Each world is killed and fails at 50 s (``run_world``).
"""

import json

import numpy as np
import pytest
import torch

from tests._torch_dist_worker import cli_train, eval_gather, learner_runs, learner_sigterm, run_world
from tests.conftest import SMALL, small_cfg
from tests.test_torch_port_data import _datasets, _equal
from tests.test_torch_port_model import port_cfg
from vog_tpu.data.featpack import build_featpack as jbuild_featpack
from vog_tpu.data.fixtures import generate_fixture as jgenerate_fixture
from vog_tpu.data.loader import BatchIterator as JBatchIterator
from vog_tpu_torch.data.fixtures import generate_fixture as pgenerate_fixture
from vog_tpu_torch.data.loader import BatchIterator as PBatchIterator
from vog_tpu_torch.data.loader import get_data
from vog_tpu_torch.train.dist import Mesh
from vog_tpu_torch.train.learner import Learner


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    kw = dict(n_train=14, n_valid=6, n_test=5, num_props=5, seed=7, **SMALL)
    j = tmp_path_factory.mktemp("jax_fx")
    jgenerate_fixture(j, **kw)
    jbuild_featpack(j)
    p = tmp_path_factory.mktemp("port_fx")
    pgenerate_fixture(p, **kw)
    return j, p


@pytest.mark.parametrize("split", ["train", "valid"])
@pytest.mark.parametrize("rank", [0, 1])
def test_local_rows_batches_equal_full_and_jax(dirs, split, rank):
    jdir, pdir = dirs
    _, _, jds, pds = _datasets(jdir, pdir, split)
    bs, train = 4, split == "train"
    rows = (rank * 2, rank * 2 + 2)

    def it(cls, ds, local):
        b = cls(ds, bs, shuffle=train, drop_last=train, seed=3, prefetch=0)
        b.local_rows = rows if local else None
        return b

    full, local, jlocal = it(PBatchIterator, pds, False), it(PBatchIterator, pds, True), it(JBatchIterator, jds, True)
    n = 0
    for f, lb, jb in zip(full, local, jlocal):
        _equal(lb, jb, f"{split} batch {n}")
        _equal(lb, {k: v[rows[0]:rows[1]] for k, v in f.items()}, f"{split} batch {n} of the full batch")
        n += 1
    assert n == len(full) and n > 0
    if not train:  # the short last batch: rank 1 holds its padding alone
        assert lb["batch_mask"].tolist() == ([1, 1] if rank == 0 else [0, 0])


def test_get_data_sizes_the_global_batch(dirs):
    jdir, pdir = dirs
    pcfg = port_cfg(small_cfg(jdir, **{"ds.conc_type": "spat"}))
    pcfg.ds.data_dir = str(pdir)
    one = get_data(pcfg)
    assert one.train_dl.bs == pcfg.train.bs and one.train_dl.local_rows is None
    two = get_data(pcfg, Mesh(rank=1, world=2))
    bs = pcfg.train.bs
    for dl in (two.train_dl, two.valid_dl, two.test_dl):
        assert dl.bs == 2 * bs and dl.local_rows is None
    pcfg.ds.device_store = "off"
    lrn = Learner("rows", two, pcfg, device="cpu", mesh=Mesh(rank=1, world=2))
    for dl in (two.train_dl, two.valid_dl, two.test_dl):
        assert dl.local_rows == (bs, 2 * bs)
    with pytest.raises(ValueError, match="get_data"):
        Learner("rows", one, pcfg, device="cpu", mesh=Mesh(rank=1, world=2))
    assert not lrn.main


def _pred(i: int, n: int = 2):
    return {"ann_idx": i, "pred_vid": list(range(n)), "scores": [0.25 * i] * n}


# per case, each rank's (sums, preds); the counters are dyadic, so float32
# sums are exact in any order
GATHER_CASES = {
    "sums and preds": [({"n_acc": 3.0, "loss_sum": 1.25, "n_batch": 4.0}, [_pred(0), _pred(1, 3)]),
                       ({"n_acc": 2.0, "loss_sum": 0.5, "n_batch": 0.0}, [_pred(2)])],
    "empty sums": [({}, [_pred(5)]), ({}, [_pred(6), _pred(7, 0)])],
    "empty preds": [({"n_pairs": 8.0}, []), ({"n_pairs": 2.5}, [])],
    "one rank empty": [({"n_pairs": 1.0}, [_pred(9)]), ({"n_pairs": 0.0}, [])],
}


def test_gather_eval_matches_jax():
    from vog_tpu.train.multihost import gather_eval as jgather_eval

    cases = list(GATHER_CASES.values())
    ranks = run_world(eval_gather, 2, cases)
    for c, (name, per_rank) in enumerate(GATHER_CASES.items()):
        sums = {k: sum(s[k] for s, _ in per_rank) for k in per_rank[0][0]}
        want = jgather_eval(sums, [p for _, preds in per_rank for p in preds])
        for r in ranks:
            assert r[c] == want, name


def test_gather_eval_without_a_group_is_the_identity():
    from vog_tpu_torch.train.multihost import gather_eval

    sums, preds = {"n_acc": 0.1}, [_pred(1)]
    assert gather_eval(sums, preds) == (sums, preds)


@pytest.fixture(scope="module")
def learner_fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_dp_fx")
    pgenerate_fixture(d, n_train=16, n_valid=5, n_test=4, num_props=5, seed=2, **SMALL)
    return d


def _learner_cfg(fx, tmp, bs, store):
    cfg = small_cfg(fx, **{"ds.conc_type": "spat", "mdl.name": "vog", "ds.device_store": store,
                           "ds.ann_store": "on", "train.bs": bs, "train.epochs": 2, "train.log_every": 1,
                           "train.steps_per_dispatch": 2, "train.eval_batches_per_dispatch": 2,
                           "train.lr": 1e-3, "train.lr_schedule": "cosine", "train.warmup_steps": 2,
                           "train.pos_weight": 5.0, "train.skip_nonfinite": 3, "misc.progress": "off",
                           "misc.tmp_path": str(tmp)})
    return port_cfg(cfg)


COUNTS = ("num_pairs", "num_queries", "acc", "vacc", "strict_acc", "cons")


@pytest.fixture(scope="module")
def learner_world(learner_fx, tmp_path_factory):
    """(the world's per-rank results, its tmp dir, the one process's
    losses and metrics)."""
    tmp1, tmp2 = tmp_path_factory.mktemp("one"), tmp_path_factory.mktemp("world")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = _learner_cfg(learner_fx, tmp1, 4, "on")
        one = Learner("one", get_data(cfg), cfg, device="cpu")
        sd = {k: v.clone() for k, v in one.model.state_dict().items()}
        losses = []
        multi = one._train_multi

        def record(*a, **kw):
            st, aux = multi(*a, **kw)
            losses.extend(aux["loss"].reshape(-1).tolist())
            return st, aux

        one._train_multi = record
        metrics = [one.fit(1), one.fit(1)]
    finally:
        torch.set_num_threads(n)
    ranks = run_world(learner_runs, 2, _learner_cfg(learner_fx, tmp2, 2, "shard"), sd, 2)
    return ranks, tmp2, losses, metrics


def test_learner_world_matches_one_process(learner_world):
    ranks, _, losses, metrics = learner_world
    assert len(losses) == 8 and all(np.isfinite(losses))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for got, want in zip(r["metrics"], metrics):
            assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
            np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    a, b = ranks[0]["state"], ranks[1]["state"]
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


def test_learner_world_rank0_writes_once(learner_world):
    _, tmp, _, _ = learner_world
    log = (tmp / "txt_logs" / "dp.txt").read_text().splitlines()
    assert sum(" metrics " in line for line in log) == 2  # one line an epoch: one writer
    events = [json.loads(line) for line in (tmp / "ext_logs" / "dp.events.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [0, 1]
    assert [e["sharded"] for e in events if e["event"] == "tables" and e["table"] == "features"] == [True]
    assert sorted(p.name for p in (tmp / "predictions").iterdir()) == \
        ["dp_valid_0.pkl", "dp_valid_1.pkl", "dpr_valid_0.pkl", "dpr_valid_1.pkl"]
    assert sorted(p.name for p in (tmp / "models" / "dp").iterdir()) == ["best.pt", "last.pt"]
    assert not list(tmp.rglob("*.tmp"))


def test_learner_world_resume_is_bitwise(learner_world):
    ranks, _, _, _ = learner_world
    for r in ranks:
        assert r["epoch"] == 2
        a, b = r["state"], r["resumed"]
        assert [k for k in a if not torch.equal(a[k], b[k])] == []


def test_cli_train_in_a_world(learner_fx, tmp_path):
    """``cli.train`` with ``--misc.multihost=true`` (gloo on the CPU): the
    mesh and the global batch from the group, the same final metrics on
    both ranks, one writer."""
    argv = ["cli", "--misc.platform=cpu", "--misc.multihost=true", f"--ds.data_dir={learner_fx}",
            "--ds.conc_type=spat", "--mdl.name=vog", "--ds.prop_dim=64", "--ds.seg_dim=48", "--ds.glove_dim=32",
            "--mdl.emb_dim=32", "--mdl.lstm_dim=16", "--mdl.vis_dim=32", "--mdl.role_dim=8", "--mdl.n_heads=2",
            "--train.bs=2", "--train.epochs=1", "--misc.progress=off", f"--misc.tmp_path={tmp_path}"]
    m0, m1 = run_world(cli_train, 2, argv)
    assert {k: m0[k] for k in COUNTS} == {k: m1[k] for k in COUNTS} and m0["num_queries"] > 0
    assert m0["val_loss"] == m1["val_loss"]
    log = (tmp_path / "txt_logs" / "cli.txt").read_text()
    assert log.count("final metrics") == 1 and log.count("uid=cli") == 1
    assert (tmp_path / "models" / "cli" / "last.pt").exists()


def test_sigterm_on_one_rank_stops_every_rank(learner_fx, tmp_path):
    """A SIGTERM that reaches rank 1 alone stops both ranks after the same
    dispatch; rank 0 saves "last" there."""
    cfg = _learner_cfg(learner_fx, tmp_path, 2, "shard")
    cfg.train.steps_per_dispatch = 1
    (b0, s0), (b1, s1) = run_world(learner_sigterm, 2, cfg, 2)
    assert (b0, s0) == (b1, s1) == (2, 2)
    last = torch.load(tmp_path / "models" / "term" / "last.pt", weights_only=True)
    assert last["meta"]["batch_in_epoch"] == 2 and int(last["state"]["step"]) == 2
