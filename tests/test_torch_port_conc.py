"""The port's clip-view assembly and device store against the JAX package.

Both are reshapes, transposes, casts and one mean, so the comparison is
bitwise: assemble_batch / scores_to_canonical for all four conc types,
_pack_rows in f32 / bf16 / int8, and gather_from_tables (including the
int8 dequant) on the same tables and vid_rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import small_cfg
from vog_tpu.data import device_store as jstore
from vog_tpu.sampling import conc as jconc
from vog_tpu_torch.data import device_store as tstore
from vog_tpu_torch.sampling import conc as tconc


def _group_batch(rng, conc):
    B, V, F, P, A, L, D, Dv = 2, (1 if conc == "svsq" else 4), 10, 5, 5, 12, 24, 16
    boxes = rng.uniform(0, 1, (B, V, F, P, 5)).astype(np.float32)
    return {
        "props": rng.normal(size=(B, V, F, P, D)).astype(np.float32),
        "prop_boxes": boxes,
        "prop_mask": (rng.uniform(size=(B, V, F, P)) > 0.1).astype(np.float32),
        "seg_feats": rng.normal(size=(B, V, F, Dv)).astype(np.float32),
        "targets": (rng.uniform(size=(B, V, A, F, P)) > 0.9).astype(np.float32),
        "tokens": rng.integers(0, 50, (B, L)).astype(np.int32),
        "seq_len": np.array([7, 12], np.int32),
        "verb_idx": np.array([1, 3], np.int32),
        "srl_roles": rng.integers(0, 24, (B, A)).astype(np.int32),
        "srl_spans": np.sort(rng.integers(0, 7, (B, A, 2)), -1).astype(np.int32),
        "srl_arg_mask": np.ones((B, A), np.float32),
        "batch_mask": np.ones((B,), np.float32),
    }


@pytest.mark.parametrize("conc", ["svsq", "sep", "temp", "spat"])
def test_assemble_and_canonical_bitwise(conc):
    rng = np.random.default_rng(0)
    batch = _group_batch(rng, conc)
    want = jconc.assemble_batch({k: jnp.asarray(v) for k, v in batch.items()}, conc)
    got = tconc.assemble_batch({k: torch.from_numpy(v) for k, v in batch.items()}, conc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)

    B, V, F, P = batch["prop_mask"].shape
    Bp, T = want["mask"].shape
    logits = rng.normal(size=(Bp, 5, T)).astype(np.float32)
    np.testing.assert_array_equal(
        tconc.scores_to_canonical(torch.from_numpy(logits), conc, B, V, F, P).numpy(),
        np.asarray(jconc.scores_to_canonical(jnp.asarray(logits), conc, B, V, F, P)),
    )
    assert tconc.view_dims(conc, V, F, P) == jconc.view_dims(conc, V, F, P)


@pytest.mark.parametrize("int8,half", [(False, False), (False, True), (True, False)])
def test_pack_rows_bitwise(int8, half):
    rng = np.random.default_rng(1)
    local = {
        "feats": rng.normal(size=(6, 2, 3, 64)).astype(np.float32),  # W=384: 3-D
        "seg": rng.normal(size=(6, 2, 50)).astype(np.float32),  # W=100: 2-D
    }
    local["feats"][2, 1] = 0.0  # a zero vector: scale 1
    jdt = jnp.bfloat16 if half else np.float32
    tdt = torch.bfloat16 if half else torch.float32
    want = jstore._pack_rows(local, jdt, int8)
    got = tstore._pack_rows({k: torch.from_numpy(v) for k, v in local.items()}, tdt, int8)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(got[k].float().numpy(), w, err_msg=k)


@pytest.mark.parametrize("int8,half", [(False, False), (False, True), (True, False)])
def test_gather_from_tables_bitwise(tmp_path, int8, half):
    cfg = small_cfg(tmp_path, **{"ds.conc_type": "spat"})
    ds = cfg.ds
    rng = np.random.default_rng(2)
    N, B, V, F, P = 9, 3, 4, ds.num_frms, ds.num_prop_per_frm
    feats = rng.normal(size=(N, F, P, ds.prop_dim)).astype(np.float32)
    seg = rng.normal(size=(N, F, ds.seg_dim)).astype(np.float32)
    rows = rng.integers(0, N, (B, V)).astype(np.int32)
    pmask = np.ones((B, V, F, P), np.float32)

    host = jstore._pack_rows({"feats": feats, "seg": seg}, jnp.bfloat16 if half else np.float32, int8)
    want = jax.jit(jstore.gather_from_tables)(
        {"vid_rows": jnp.asarray(rows), "prop_mask": jnp.asarray(pmask)},
        {k: jnp.asarray(v) for k, v in host.items()},
    )
    tables = tstore.DeviceFeatureTables.from_arrays(
        cfg, feats, seg, half=half, int8=int8, device="cpu", chunk_rows=4
    )
    got = tstore.gather_from_tables(
        {"vid_rows": torch.from_numpy(rows), "prop_mask": torch.from_numpy(pmask)}, tables.tables
    )
    for k in ("props", "seg_feats"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_random_tables_shapes_and_seed():
    cfg = small_cfg("/nonexistent", **{"ds.conc_type": "spat"})
    a = tstore.DeviceFeatureTables.random(cfg, 5, seed=3, half=True, device="cpu", chunk_rows=2)
    b = tstore.DeviceFeatureTables.random(cfg, 5, seed=3, half=True, device="cpu", chunk_rows=2)
    W = cfg.ds.num_frms * cfg.ds.num_prop_per_frm * cfg.ds.prop_dim
    assert tuple(a.tables["feats"].shape) == jstore._table_shape(5, W)
    assert a.tables["feats"].dtype == torch.bfloat16
    assert torch.equal(a.tables["feats"], b.tables["feats"])
