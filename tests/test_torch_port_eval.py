"""The port's evaluator and eval step against the JAX package on the CPU:

  * ``evaluate_batch`` on identical numpy inputs against
    ``vog_tpu.evaluation.evaluate_batch``, in the full form and the compact
    form at several budgets: every output exactly equal, on inputs with
    ties (the first maximum wins), masked proposals (whose large scores
    must lose), a query with no considered pair, a padded batch row, and
    budgets that overflow (``n_overflow`` > 0);
  * ``finalize_metrics`` equal;
  * ``make_eval_step`` against the JAX package's on ``_random_batch`` with
    the same weights (``params_from_jax``): the count sums and the pair
    indices equal, ``loss_sum`` within 1e-4 relative (fp32 on both sides,
    sums in another order), the pair IoUs within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _cfg, _glove, _random_batch
from tests.test_torch_port_model import port_cfg
from vog_tpu.evaluation import evaluate_batch as j_evaluate, finalize_metrics as j_finalize
from vog_tpu.train import state as jstate
from vog_tpu_torch.evaluation import evaluate_batch, finalize_metrics
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.model.grounding import get_model
from vog_tpu_torch.train import TrainState, make_eval_step

SUMS = ("n_pairs", "n_acc", "n_vacc", "n_queries", "n_strict", "n_cons")


def _inputs(seed, B=4, A=3, V=2, F=4, P=3):
    """Scores on a coarse grid (many ties), masked proposals holding the
    highest scores, query 2 with no considered pair, row 3 padded out."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (B, V, F, P, 2))
    wh = rng.uniform(0.1, 0.5, (B, V, F, P, 2))
    boxes = np.concatenate([xy, xy + wh, wh[..., :1] * wh[..., 1:]], -1).astype(np.float32)
    gxy = rng.uniform(0, 0.5, (B, A, F, 2))
    gt = np.concatenate([gxy, gxy + rng.uniform(0.1, 0.5, (B, A, F, 2))], -1).astype(np.float32)
    # make some GT boxes match a proposal, so that IoU >= 0.5 occurs
    gt[:, :, :, :] = np.where(rng.uniform(size=(B, A, F, 1)) < 0.4, boxes[:, :1, :, 0, :4], gt)
    pmask = (rng.uniform(size=(B, V, F, P)) > 0.2).astype(np.float32)
    scores = rng.integers(0, 3, (B, A, V, F, P)).astype(np.float32)
    scores = np.where(pmask[:, None] > 0, scores, 10.0).astype(np.float32)  # masked must lose
    fmask = (rng.uniform(size=(B, A, F)) > 0.4).astype(np.float32)
    amask = np.ones((B, A), np.float32)
    amask[2] = 0.0  # a query with no considered pair
    bmask = np.ones((B,), np.float32)
    bmask[3] = 0.0
    return dict(scores=scores, prop_boxes=boxes, gt_boxes=gt, gt_frame_mask=fmask, srl_arg_mask=amask,
                pos_vid=rng.integers(0, V, (B,)).astype(np.int32), batch_mask=bmask, prop_mask=pmask)


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].numpy()
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype.kind == r.dtype.kind, (k, g.dtype, r.dtype, g.shape, r.shape)
        assert np.array_equal(g, r), k


@pytest.mark.parametrize("max_pairs", [0, 1, 3, 5, 100])
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_batch_matches_jax(seed, max_pairs):
    d = _inputs(seed)
    ref = j_evaluate(**{k: jnp.asarray(v) for k, v in d.items()}, max_pairs=max_pairs)
    got = evaluate_batch(**{k: torch.from_numpy(v) for k, v in d.items()}, max_pairs=max_pairs)
    _assert_same(got, ref)
    assert float(got["n_queries"]) == 2.0  # query 2 has no pair, row 3 is padded
    if max_pairs in (1, 3):
        assert float(got["n_overflow"]) > 0


def test_ties_take_the_first_maximum():
    d = _inputs(0)
    d["scores"][:] = 1.0
    d["prop_mask"][:] = 1.0
    got = evaluate_batch(**{k: torch.from_numpy(v) for k, v in d.items()})
    assert not got["pred_vid"].any() and not got["pred_prop"].any()
    _assert_same(got, j_evaluate(**{k: jnp.asarray(v) for k, v in d.items()}))


def test_finalize_metrics_matches_jax():
    d = _inputs(1)
    out = evaluate_batch(**{k: torch.from_numpy(v) for k, v in d.items()}, max_pairs=4)
    sums = {k: float(out[k]) for k in SUMS}
    assert finalize_metrics(sums) == j_finalize(sums)
    zero = {k: 0.0 for k in SUMS}
    assert finalize_metrics(zero) == j_finalize(zero)


def test_eval_step_matches_jax():
    cfg = _cfg(tiny=True)
    pcfg = port_cfg(cfg)
    B = 4
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _random_batch(cfg, B, seed=5)
    d = _inputs(2, B=B, A=cfg.ds.max_srl_args, V=cfg.ds.num_cmp, F=cfg.ds.num_frms, P=cfg.ds.num_prop_per_frm)
    for k in ("prop_boxes", "gt_boxes", "gt_frame_mask", "pos_vid", "batch_mask"):
        batch[k] = d[k]
    batch["prop_mask"][1, 2, :, 4] = 0.0
    batch["srl_arg_mask"][2] = 0.0
    ref = jax.jit(jstate.make_eval_step(cfg))(state, {k: jnp.asarray(v) for k, v in batch.items()})
    model = get_model(pcfg, 400, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params), pcfg), strict=True)
    got = make_eval_step(pcfg)(TrainState.create(pcfg, model), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(ref)
    for k in SUMS + ("n_overflow", "n_batch", "pair_valid", "pair_arg", "pair_frame", "pair_vid", "pair_prop"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    assert float(got["n_pairs"]) > 0
    np.testing.assert_allclose(float(got["loss_sum"]), float(ref["loss_sum"]), rtol=1e-4)
    np.testing.assert_allclose(got["pair_iou"].numpy(), np.asarray(ref["pair_iou"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["pair_scores"].numpy(), np.asarray(ref["pair_scores"]), rtol=2e-4, atol=2e-4)
