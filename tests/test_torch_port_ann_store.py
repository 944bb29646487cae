"""The port's index-only input path (``vog_tpu_torch/data/ann_store.py``)
against the JAX package's on the CPU:

  * ``pack_ann_tables`` against ``vog_tpu.data.ann_store.DeviceAnnTables``
    (fed a stand-in dataset with the same per-annotation and per-video
    statics, ``chip_smoke.random_ann_arrays``): the five tables bitwise,
    and ``ann_table_bytes`` equal;
  * ``expand_index_batch`` against the JAX package's, field for field and
    dtype for dtype, bitwise;
  * a train step fed the index-only batch and the tables equals, bitwise
    (state and aux), one fed the batch already expanded, with dropout on,
    with and without ``grad_accum``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _cfg
from chip_smoke import make_index_batches, random_ann_arrays
from tests.test_torch_port_model import port_cfg
from vog_tpu.data import ann_store as jann
from vog_tpu_torch.data.ann_store import (
    ANN_TABLE_KEYS,
    AnnTables,
    ann_table_bytes,
    expand_index_batch,
    pack_ann_tables,
)
from vog_tpu_torch.data.device_store import DeviceFeatureTables
from vog_tpu_torch.model.grounding import get_model
from vog_tpu_torch.train import TrainState, make_train_step

N_ANNS, N_VIDS = 9, 7


class _StandIn:
    """The two statics the JAX package's DeviceAnnTables reads of a split."""

    def __init__(self, anns, vids):
        self.anns, self.vids = anns, vids

    def __len__(self):
        return len(self.anns["tokens"])

    def _ann_static(self, i):
        return {k: v[i] for k, v in self.anns.items()}

    def _vid_static(self, vid):
        return self.vids["prop_boxes"][vid], self.vids["prop_mask"][vid], None, None


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(tiny=True)
    anns, vids = random_ann_arrays(cfg, N_ANNS, N_VIDS, seed=0)
    jt = jann.DeviceAnnTables(cfg, {"train": _StandIn(anns, vids)}, {v: v for v in range(N_VIDS)})
    return cfg, anns, vids, {k: np.asarray(v) for k, v in jt.tables.items()}


def test_tables_match_jax(setup):
    cfg, anns, vids, jtables = setup
    host = pack_ann_tables(port_cfg(cfg), anns, vids)
    assert set(host) == set(ANN_TABLE_KEYS) == set(jtables)
    for k in ANN_TABLE_KEYS:
        assert host[k].dtype == jtables[k].dtype and np.array_equal(host[k], jtables[k]), k
    assert ann_table_bytes(port_cfg(cfg), N_ANNS, N_VIDS) == jann.ann_table_bytes(cfg, N_ANNS, N_VIDS)
    assert ann_table_bytes(port_cfg(cfg), N_ANNS, N_VIDS) == sum(v.nbytes for v in host.values())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_expand_matches_jax(setup, seed):
    cfg, anns, vids, jtables = setup
    b = make_index_batches(cfg, 1, 5, N_ANNS, N_VIDS, seed)[0]
    ref = jax.jit(lambda bb: jann.expand_index_batch(bb, jtables, cfg))(b)
    tables = AnnTables.from_arrays(port_cfg(cfg), anns, vids, device="cpu").tables
    got = expand_index_batch({k: torch.from_numpy(v) for k, v in b.items()}, tables, port_cfg(cfg))
    assert set(got) == set(ref)
    for k, r in ref.items():
        g, r = got[k].numpy(), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, (k, g.dtype, r.dtype)
        assert np.array_equal(g, r), k
    assert got["targets"].dtype == torch.uint8 and got["prop_mask"].dtype == torch.uint8


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_index_batch_equals_expanded(setup, accum):
    cfg, anns, vids, _ = setup
    pcfg = port_cfg(cfg)
    pcfg.train = dataclasses.replace(pcfg.train, grad_accum=accum, skip_nonfinite=2)
    ds = pcfg.ds
    rng = np.random.default_rng(4)
    feats = DeviceFeatureTables.from_arrays(
        pcfg, rng.normal(size=(N_VIDS, ds.num_frms, ds.num_prop_per_frm, ds.prop_dim)).astype(np.float32),
        rng.normal(size=(N_VIDS, ds.num_frms, ds.seg_dim)).astype(np.float32), device="cpu").tables
    tables = {**feats, **AnnTables.from_arrays(pcfg, anns, vids, device="cpu").tables}
    b = {k: torch.from_numpy(v) for k, v in make_index_batches(cfg, 1, 4, N_ANNS, N_VIDS, seed=6)[0].items()}
    expanded = expand_index_batch(b, tables, pcfg)
    assert "ann_row" not in expanded and "vid_rows" in expanded

    outs = []
    for batch in (b, expanded):
        model = get_model(pcfg, 5000, device="cpu", seed=1, train=True)  # dropout 0.1
        state = TrainState.create(pcfg, model)
        step = make_train_step(pcfg)
        auxs = [step(state, batch, seed=3, tables=tables)[1] for _ in range(2)]
        outs.append((state.tensors(), auxs))
    (sa, aa), (sb, ab) = outs
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for x, y in zip(aa, ab):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert int(sa["step"]) == 2 and torch.isfinite(aa[1]["loss"])
