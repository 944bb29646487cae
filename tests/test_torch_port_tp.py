"""The port's tensor parallelism (the mesh's model axis: train/dist.py,
model/parallel.py) in worlds of gloo processes on the CPU
(``tests/_torch_dist_worker.py``), at the narrow widths of
``test_torch_port_dist.py`` (vis 32, 2 heads, FFN 128):

  * (1) a (1, 2) world's train step against the JAX package's
    ``misc.mesh_model=2`` step on two of its eight virtual CPU devices,
    ``param_shardings`` applied to the same parameters
    (``params_from_jax``): loss and grad_norm within 1e-4 relative;
  * (2) (1, 2) and (2, 2) worlds against the port's one process on the
    global batches, two steps, at dropout 0 and 0.1 (the FFN's column
    shards draw their global columns' bits): each step's loss within 1e-5
    relative (counted once a data index: a world that summed its model
    ranks' losses would be m times off), the whole gradient gathered over
    the model ranks within 1e-5 x max(1, max|g|), and every whole
    parameter bitwise equal across the ranks after the steps;
  * (5) ``shard_state_dict`` / ``gather_state_dict`` round trip bitwise in
    a (1, 2) world, and ``cli.train`` on a (1, 2) mesh: its checkpoint is
    the single process's file (it loads into a Learner of one process and
    into ``Predictor.from_checkpoint``), and a single process's checkpoint
    loads into the (1, 2) world, gathered back bitwise;
  * the refusals of the model axis, each naming its key.

Each world is killed and fails at 50 s (``run_world``).
"""

import copy

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _glove
from tests._torch_dist_worker import mesh_checks, run_world, tp_learner, tp_steps
from tests.conftest import SMALL, small_cfg
from tests.test_torch_port_dist import GLOBAL_B, VOCAB, _batches, _jax_cfg, _one_process
from tests.test_torch_port_model import port_cfg
from vog_tpu.train import state as jstate
from vog_tpu_torch.interop.from_jax import params_from_jax

RATES = (0.0, 0.1)


@pytest.fixture(scope="module")
def setup():
    """The JAX package's initial parameters and its (1, 2) step's aux."""
    from vog_tpu.train import make_mesh, param_shardings, shard_batch

    cfg = _jax_cfg()
    state = jstate.init_state(cfg, _glove(cfg, VOCAB), jax.random.PRNGKey(0), GLOBAL_B)
    batches = _batches(cfg, 2)
    cfg.misc.mesh_data, cfg.misc.mesh_model = 1, 2
    mesh = make_mesh(cfg)
    assert (mesh.shape["data"], mesh.shape["model"]) == (1, 2)
    sharded = state.replace(params=jax.device_put(state.params, param_shardings(mesh, state.params)))
    _, jaux = jax.jit(jstate.make_train_step(cfg))(sharded, shard_batch(batches[0], mesh), jax.random.PRNGKey(1))
    sd = params_from_jax(jax.tree.map(np.asarray, state.params), port_cfg(cfg))
    return {"sd": sd, "batches": batches, "jaux": jax.device_get(jaux)}


@pytest.fixture(scope="module")
def worlds(setup):
    """Per (data, model) mesh: per dropout rate (the world's per-rank
    results, the one process's)."""
    cfgs = [port_cfg(_jax_cfg(rate)) for rate in RATES]
    ones = [_one_process(c, setup["sd"], setup["batches"]) for c in cfgs]
    out = {}
    for world in (2, 4):
        ranks = run_world(tp_steps, world, copy.deepcopy(cfgs), setup["sd"], setup["batches"], VOCAB, 2)
        out[(world // 2, 2)] = {rate: ([r[i] for r in ranks], ones[i]) for i, rate in enumerate(RATES)}
    return out


def test_tp_step_matches_jax_mesh_model_2(setup, worlds):
    ranks, _ = worlds[(1, 2)][0.0]
    jaux = setup["jaux"]
    for r in ranks:
        first = r["steps"][0]
        np.testing.assert_allclose(float(first["loss"]), float(jaux["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(first["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tp_world_matches_one_process(worlds, mesh, rate):
    ranks, (ref, _) = worlds[mesh][rate]
    for i, want in enumerate(ref):
        g = want["grad"]
        for rank, r in enumerate(ranks):
            got = r["steps"][i]
            np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5,
                                       err_msg=f"rank {rank} step {i}")
            np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
            err = float((got["grad"] - g).abs().max())
            assert err <= 1e-5 * max(1.0, float(g.abs().max())), (rank, i, err)
    first = ranks[0]["whole_params"]
    for rank, r in enumerate(ranks[1:], 1):
        assert [k for k in first if not torch.equal(first[k], r["whole_params"][k])] == [], rank
    # the data indices' gathered states agree too
    a, b = ranks[0]["state"], ranks[-1]["state"]
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


def test_tp_dropout_takes_the_global_columns(worlds):
    """At rate 0.1 the losses differ from rate 0's, and the world agrees
    with one process (above): each FFN column shard draws its global
    columns' bits."""
    ranks0, _ = worlds[(1, 2)][0.0]
    ranks1, _ = worlds[(1, 2)][0.1]
    assert float(ranks0[0]["steps"][0]["loss"]) != float(ranks1[0]["steps"][0]["loss"])


@pytest.fixture(scope="module")
def mesh_world(setup):
    """One (1, 2) world: the round trip under tp and tp+sp, and the
    refusals' messages."""
    cfgs = []
    for sp in (False, True):
        c = port_cfg(_jax_cfg())
        c.mdl.sp_attention = sp
        cfgs.append(c)
    faults = [("mdl", "n_heads", 3), ("mdl", "vis_dim", 31), ("misc", "mesh_data", 2)]
    return run_world(mesh_checks, 2, cfgs, setup["sd"], faults)


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "tp+sp"])
def test_shard_gather_round_trip(setup, mesh_world, sp):
    sd = setup["sd"]
    for rank in mesh_world:
        back, shapes, n = rank["round_trips"][int(sp)]
        assert [k for k in sd if not torch.equal(sd[k], back[k])] == []
    # prop/seg projections (weight + bias), qkv (w + b) and ff1 (w + b) of two
    # layers, out and ff2 weights of two layers; under sp the object
    # transformer's ring block keeps its qkv and out whole
    assert n == (13 if sp else 16)
    assert shapes["obj_tx.layers.0.ff1.weight"] == (64, 32) and shapes["mm_tx.layers.0.ff2.weight"] == (32, 64)
    assert shapes["obj_tx.layers.0.attn.qkv.weight"] == ((96, 32) if sp else (48, 32))
    assert shapes["mm_tx.layers.0.attn.out.weight"] == (32, 16) and shapes["head.fuse_cross_kernel"] == (32, 32)


@pytest.fixture(scope="module")
def learner_fx(tmp_path_factory):
    from vog_tpu_torch.data.fixtures import generate_fixture

    d = tmp_path_factory.mktemp("port_tp_fx")
    generate_fixture(d, n_train=8, n_valid=4, n_test=4, num_props=5, seed=2, **SMALL)
    return d


def _learner_cfg(fx, tmp, mesh_model):
    cfg = small_cfg(fx, **{"ds.conc_type": "spat", "mdl.name": "vog", "train.bs": 2, "train.epochs": 1,
                           "train.lr": 1e-3, "misc.progress": "off", "misc.tmp_path": str(tmp)})
    cfg = port_cfg(cfg)
    cfg.misc.mesh_model = mesh_model
    return cfg


def test_tp_checkpoints_are_the_single_process_file(learner_fx, tmp_path):
    """``cli.train`` on a (1, 2) mesh writes the file one process writes:
    it loads into a Learner of one process (parameters and moments) and
    into ``Predictor.from_checkpoint``; a single process's checkpoint
    loads into the (1, 2) world and gathers back bitwise."""
    from vog_tpu_torch.data.loader import get_data
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.train.learner import Learner

    one_cfg = _learner_cfg(learner_fx, tmp_path / "one", 1)
    one = Learner("one", get_data(one_cfg), one_cfg, device="cpu")
    one_path = one.save("last")
    argv = ["tp", "--misc.platform=cpu", "--misc.multihost=true", "--misc.mesh_model=2",
            f"--ds.data_dir={learner_fx}", "--ds.conc_type=spat", "--mdl.name=vog", "--ds.prop_dim=64",
            "--ds.seg_dim=48", "--ds.glove_dim=32", "--mdl.emb_dim=32", "--mdl.lstm_dim=16", "--mdl.vis_dim=32",
            "--mdl.role_dim=8", "--mdl.n_heads=2", "--train.bs=2", "--train.epochs=1", "--misc.progress=off",
            f"--misc.tmp_path={tmp_path / 'world'}"]
    (m0, loaded0), (m1, loaded1) = run_world(tp_learner, 2, argv, _learner_cfg(learner_fx, tmp_path / "w2", 2),
                                             str(one_path))
    assert m0["val_loss"] == m1["val_loss"] and m0["num_queries"] > 0
    saved = torch.load(one_path, weights_only=True)["state"]
    for loaded in (loaded0, loaded1):
        assert sorted(loaded) == sorted(saved)
        assert [k for k in saved if not torch.equal(saved[k], loaded[k])] == []

    world_ckpt = tmp_path / "world" / "models" / "tp" / "last.pt"
    payload = torch.load(world_ckpt, weights_only=True)["state"]
    assert {k: tuple(v.shape) for k, v in payload.items()} == {k: tuple(v.shape) for k, v in saved.items()}
    back = Learner("back", get_data(one_cfg), one_cfg, device="cpu")
    back.load(str(world_ckpt))
    got = back.state.tensors()
    assert [k for k in payload if not torch.equal(payload[k], got[k])] == []
    pred = Predictor.from_checkpoint(one_cfg, world_ckpt, device="cpu", glove=get_data(one_cfg).vocab.vectors)
    params = dict(pred.model.named_parameters())
    assert all(torch.equal(params[k.split(":", 1)[1]], v) for k, v in payload.items() if k.startswith("param:"))


def test_model_axis_refusals_name_their_keys(mesh_world):
    """``make_mesh`` refuses a model axis that does not divide the heads,
    the widths or the world, and a mesh other than the world, each naming
    its key; one process takes ``misc.mesh_model=1`` only."""
    from vog_tpu_torch.config import Cfg
    from vog_tpu_torch.train.dist import make_mesh

    cfg = Cfg()
    cfg.misc.mesh_model = 2
    with pytest.raises(ValueError, match="misc.mesh_model=2 does not divide the world of 1"):
        make_mesh(cfg)
    for rank in mesh_world:
        heads, width, mesh = rank["faults"]
        assert "misc.mesh_model=2 does not divide mdl.n_heads = 3" in heads
        assert "misc.mesh_model=2 does not divide mdl.vis_dim = 31" in width
        assert "misc.mesh_data=2 x misc.mesh_model=2 but the world has 2 processes" in mesh
