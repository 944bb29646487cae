"""The port's data parallelism (``vog_tpu_torch/train/dist.py``) in worlds
of two gloo processes on the CPU (``tests/_torch_dist_worker.py``), at
the narrow widths of ``test_torch_port_train.py``:

  * (1) a 2-rank train step against the JAX package's ``misc.mesh_data=2``
    step on two of its eight virtual CPU devices, from the same parameters
    (``params_from_jax``) and one global batch of 4 whose ranks hold
    different ``srl_arg_mask`` counts: loss and grad_norm within 1e-4
    relative (``test_torch_port_train.py``'s bound; fp32, sums in another
    order);
  * (2) the same world, two steps, against the port's one process on the
    global batches, at dropout 0 and 0.1 (the ranks number their rows from
    their first global sample): each step's loss within 1e-6 relative and
    flat gradient within 1e-5 x max(1, max|g|) (the same operations, the
    loss's sum split at the ranks), and the two ranks' states bitwise
    equal after the steps;
  * (5) the row-sharded store's collective gather over 2 ranks (the plain
    gather on the CPU) against ``vog_tpu``'s ``sharded_gather_from_tables``
    on a 2-device mesh and against the replicated gather, in bf16 and int8,
    with rows at both shards' edges: bitwise;
  * (7) the refusals: ``misc.mesh_model=2`` in one process (the Learner's
    and ``make_mesh``'s, naming the key), a ring ``Predictor`` without
    ``mdl.sp_attention``, ``misc.mesh_data`` that is not the world or
    without ``misc.multihost``, ``ds.device_store=shard`` in one process,
    and a graphed dispatch on a gloo group (naming the backend).

Each world is killed and fails at 50 s (``run_world``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _cfg, _glove, _random_batch
from tests._torch_dist_worker import mesh_worlds, run_world, sharded_gather, train_steps
from tests.test_torch_port_model import port_cfg
from vog_tpu.train import state as jstate
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.model.grounding import get_model
from vog_tpu_torch.train import TrainState, make_train_step

GLOBAL_B = 4
VOCAB = 400


def _jax_cfg(dropout: float = 0.0):
    cfg = _cfg(tiny=True)
    cfg.mdl.dropout = dropout
    t = cfg.train
    t.lr, t.lr_schedule, t.grad_clip, t.skip_nonfinite, t.pos_weight = 1e-3, "const", 1e6, 3, 5.0
    return cfg


def _batches(cfg, n: int):
    """Global batches whose two ranks' halves differ in their arg counts."""
    out = []
    for i in range(n):
        b = _random_batch(cfg, GLOBAL_B, seed=1 + i)
        b["srl_arg_mask"][2:, 2:] = 0.0  # rank 1: two args a row, rank 0: all five
        b["prop_mask"][1, 2, :, 4] = 0.0
        out.append(b)
    return out


@pytest.fixture(scope="module")
def setup():
    """The JAX package's initial parameters and its mesh_data=2 step's aux."""
    from vog_tpu.train import make_mesh, shard_batch

    cfg = _jax_cfg()
    state = jstate.init_state(cfg, _glove(cfg, VOCAB), jax.random.PRNGKey(0), GLOBAL_B)
    batches = _batches(cfg, 2)
    cfg.misc.mesh_data = 2
    mesh = make_mesh(cfg)
    assert mesh.shape["data"] == 2
    _, jaux = jax.jit(jstate.make_train_step(cfg))(state, shard_batch(batches[0], mesh), jax.random.PRNGKey(1))
    sd = params_from_jax(jax.tree.map(np.asarray, state.params), port_cfg(cfg))
    return {"sd": sd, "batches": batches, "jaux": jax.device_get(jaux)}


def _one_process(pcfg, sd, batches):
    model = get_model(pcfg, VOCAB, device="cpu", train=True)
    model.load_state_dict(sd, strict=True)
    state = TrainState.create(pcfg, model)
    step = make_train_step(pcfg)
    out = []
    for b in batches:
        state, aux = step(state, {k: torch.from_numpy(v) for k, v in b.items()}, seed=0)
        out.append({"loss": aux["loss"].clone(), "grad_norm": aux["grad_norm"].clone(),
                    "grad": state.flat.grad.clone()})
    return out, state.snapshot()


@pytest.fixture(scope="module")
def worlds(setup):
    """Per dropout rate: (the 2-rank world's results, the one process's)."""
    rates = (0.0, 0.1)
    cfgs = [port_cfg(_jax_cfg(rate)) for rate in rates]
    ranks = run_world(train_steps, 2, cfgs, setup["sd"], setup["batches"], VOCAB)
    return {rate: ([r[i] for r in ranks], _one_process(cfg, setup["sd"], setup["batches"]))
            for i, (rate, cfg) in enumerate(zip(rates, cfgs))}


def test_dp_step_matches_jax_mesh_data_2(setup, worlds):
    ranks, _ = worlds[0.0]
    jaux = setup["jaux"]
    for r in ranks:
        first = r["steps"][0]
        np.testing.assert_allclose(float(first["loss"]), float(jaux["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(first["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dp_step_matches_one_process(worlds, rate):
    ranks, (ref, ref_state) = worlds[rate]
    for i, want in enumerate(ref):
        g = want["grad"]
        for r in ranks:
            got = r["steps"][i]
            np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6, err_msg=f"step {i}")
            err = float((got["grad"] - g).abs().max())
            assert err <= 1e-5 * max(1.0, float(g.abs().max())), (i, err)
    a, b = ranks[0]["state"], ranks[1]["state"]
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert int(a["step"]) == len(ref) == int(ref_state["step"])


def test_dp_dropout_draws_the_global_rows_bits(worlds):
    """At rate 0.1 the masks differ from rate 0's (dropout is on), and the
    world still agrees with the one process (checked above): each rank's
    rows take the global batch's bits, not their local indices'."""
    (r0, _), (r1, _) = worlds[0.0], worlds[0.1]
    assert float(r0[0]["steps"][0]["loss"]) != float(r1[0]["steps"][0]["loss"])


def _tables(pcfg, n_rows: int, int8: bool):
    from vog_tpu_torch.data.device_store import DeviceFeatureTables

    ds = pcfg.ds
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(n_rows, ds.num_frms, ds.num_prop_per_frm, ds.prop_dim)).astype(np.float32)
    seg = rng.normal(size=(n_rows, ds.num_frms, ds.seg_dim)).astype(np.float32)
    feats[3, 0, 0] = 0.0  # a zero vector: int8 scale 1
    return DeviceFeatureTables.from_arrays(pcfg, feats, seg, half=not int8, int8=int8, device="cpu").tables


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_sharded_gather_matches_jax(int8):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vog_tpu.data.device_store import sharded_gather_from_tables as jsharded
    from vog_tpu.train import make_mesh
    from vog_tpu_torch.data.device_store import gather_from_tables

    cfg = _jax_cfg()
    pcfg = port_cfg(cfg)
    tables = _tables(pcfg, 8, int8)  # 7 videos and a padding row: shards [0, 4) and [4, 8)
    ds = pcfg.ds
    V, F, P_ = ds.num_cmp, ds.num_frms, ds.num_prop_per_frm
    rows = np.array([[0, 3, 4, 6], [3, 4, 1, 5], [6, 0, 2, 4], [4, 3, 3, 0]], np.int32)  # both shards' edges
    batch = {"vid_rows": rows, "prop_mask": np.ones((GLOBAL_B, V, F, P_), np.float32)}
    ranks = run_world(sharded_gather, 2, pcfg, tables, batch)
    got = {k: torch.cat([r[k] for r in ranks]) for k in ("props", "seg_feats")}

    rep = gather_from_tables({k: torch.from_numpy(v) for k, v in batch.items()}, tables)
    cfg.misc.mesh_data = 2
    mesh = make_mesh(cfg)
    sh = NamedSharding(mesh, P("data"))
    jt = {k: jax.device_put(jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy(),
                                        dtype=jnp.bfloat16 if v.dtype == torch.bfloat16 else None), sh)
          for k, v in tables.items()}
    jb = {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}
    jout = jax.jit(lambda b, t: jsharded(b, t, mesh))(jb, jt)
    for k in ("props", "seg_feats"):
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], rep[k]), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jout[k]), err_msg=k)


def test_refusals_name_their_keys(tmp_path):
    from vog_tpu_torch.config import Cfg
    from vog_tpu_torch.data.device_store import device_store_mode
    from vog_tpu_torch.train.dist import Mesh, init_distributed, make_mesh
    from vog_tpu_torch.train.learner import Learner
    from vog_tpu_torch.train.state import _check_graphable

    from vog_tpu_torch.serve import Predictor

    cfg = Cfg()
    cfg.misc.mesh_model = 2
    with pytest.raises(ValueError, match="misc.mesh_model=2 does not divide the world of 1"):
        Learner("x", None, cfg, device="cpu")
    with pytest.raises(ValueError, match="misc.mesh_model"):
        make_mesh(cfg)
    ring = Mesh(rank=0, world=2, group=object(), backend="gloo", model=2, model_group=object(), model_ranks=(0, 1))
    with pytest.raises(ValueError, match="mdl.sp_attention=true"):
        Predictor(Cfg(), None, 50, device="cpu", mesh=ring)
    cfg = Cfg()
    cfg.misc.mesh_data = 2
    with pytest.raises(ValueError, match="misc.mesh_data=2 without misc.multihost"):
        make_mesh(cfg)
    cfg.misc.mesh_data = 1
    assert make_mesh(cfg) == Mesh()
    cfg.misc.multihost = True
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(cfg)
    cfg.ds.device_store = "shard"
    with pytest.raises(ValueError, match="ds.device_store=shard"):
        device_store_mode(cfg, 10, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="torchrun"):
        init_distributed(cfg, "cpu")  # misc.multihost without torchrun's environment
    with pytest.raises(RuntimeError, match="gloo process group"):
        _check_graphable(Mesh(rank=0, world=2, group=object(), backend="gloo"))
    _check_graphable(Mesh(rank=0, world=2, group=object(), backend="nccl"))
    _check_graphable(None)


def test_make_mesh_in_a_world():
    """In a world of 2: ``misc.mesh_data`` -1 and 2 give the data axis and
    each rank's rows, 3 raises naming the key."""
    ranks = run_world(mesh_worlds, 2, (-1, 2, 3))
    for rank, (auto, two, three) in enumerate(ranks):
        assert auto == two == (rank, 2, "gloo", (3 * rank, 3 * rank + 3))
        assert "misc.mesh_data=3" in three and "2 processes" in three


def test_shard_batch_local_moves_the_rows_and_halves_the_features():
    from vog_tpu_torch.train.dist import shard_batch_local, stack_shard_batches_local

    b = _random_batch(_jax_cfg(), 2, seed=4)
    one = shard_batch_local(b, "cpu", half_feats=True)
    assert one["props"].dtype == one["seg_feats"].dtype == torch.bfloat16
    assert one["prop_boxes"].dtype == torch.float32 and torch.equal(one["tokens"], torch.from_numpy(b["tokens"]))
    two = stack_shard_batches_local([b, b], "cpu")
    assert two["props"].shape == (2,) + b["props"].shape and two["props"].dtype == torch.float32
    assert torch.equal(two["props"][1], torch.from_numpy(b["props"]))
