"""The port's training slice against the JAX package on the CPU:

  * the optimizer (clip -> adam/adamw with warm-up cosine, inside the
    non-finite guard) against optax, step for step over the same gradient
    trees, with a dropped step and a give-up, wd = 0 and wd > 0 with a
    frozen (zero-gradient) embedding;
  * one ``make_train_step`` (dropout 0, also with ``grad_accum=2``) against
    ``vog_tpu.train.state.make_train_step`` on ``_random_batch``: loss,
    grad_norm, guard counter, and every parameter's gradient carried
    across by ``params_from_jax`` (the JAX gradient is read back from
    Adam's first moment, mu = 0.1 g after one step without clipping);
  * dropout at its sites: active in train mode, off at rate 0 and in
    eval mode, the same masks for the same (seed, step); the counter-based
    keep mask (``dropout_keep``): the same bits for the same (seed, step,
    microbatch, site), other bits when any of them changes, and a keep
    rate within binomial bounds (the card test holds the CPU's bits
    against the card's).

Tolerances: the optimizer 1e-6 relative (the same fp32 operations in the
same order); the train step's loss and grad_norm 1e-4 relative and each
gradient 1e-4 * max(1, max |g|), as chip_smoke.py holds the card to the
CPU (fp32 on both sides, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _cfg, _glove, _random_batch
from tests.test_torch_port_model import port_cfg
from vog_tpu.train import state as jstate
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.model.grounding import get_model
from vog_tpu_torch.model.transformer import Dropout, dropout_keep, dropout_key, set_dropout_key
from vog_tpu_torch.sampling import assemble_batch
from vog_tpu_torch.serve import cast_compact
from vog_tpu_torch.train import TrainState, make_optimizer, make_train_step


# --------------------------------------------------------------------------
# optimizer against optax
# --------------------------------------------------------------------------
def _grad_trees(rng, shapes):
    """Six gradient trees: the norm above the clip at steps 1 and 3, a NaN
    at step 2 (dropped), at steps 4 and 5 (two in a row: the second gives
    up with K = 1); the embedding's gradient is always zero (frozen)."""
    out = []
    for step in range(6):
        g = {k: (rng.normal(size=s) * (3.0 if step in (1, 3) else 0.1)).astype(np.float32)
             for k, s in shapes.items()}
        g["embed"] = np.zeros(shapes["embed"], np.float32)
        if step in (2, 4, 5):
            g["w"][0, 1] = np.nan
        out.append(g)
    return out


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_optimizer_matches_optax(wd):
    cfg = _cfg(tiny=True)
    t = cfg.train
    t.lr, t.lr_schedule, t.warmup_steps, t.total_steps = 1e-2, "cosine", 2, 5
    t.grad_clip, t.wd, t.skip_nonfinite = 1.0, wd, 1
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(0)
    shapes = {"embed": (5, 3), "w": (4, 3), "b": (3,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jtx, ttx = jstate.make_optimizer(cfg), make_optimizer(pcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step, g in enumerate(_grad_trees(rng, shapes)):
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8,
                                       err_msg=f"step {step} {k}")
        assert int(ts["notfinite_count"]) == int(js.notfinite_count)
        assert int(ts["total_notfinite"]) == int(js.total_notfinite)
        if step == 4:  # before the give-up, whose NaN norm reaches every leaf
            frozen_moved = not np.array_equal(tp["embed"].numpy(), params["embed"])
            assert frozen_moved == (wd > 0)  # adamw decays the frozen embedding, adam does not
    assert np.isnan(tp["w"].numpy()).all()  # the give-up applied the raw update


# --------------------------------------------------------------------------
# one train step against vog_tpu.train.state.make_train_step
# --------------------------------------------------------------------------
def _adam_mu(opt_state):
    """The ScaleByAdamState.mu tree inside a (guarded) optax chain state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu
    children = opt_state if isinstance(opt_state, tuple) else tuple(opt_state.__dict__.values())
    for c in children:
        if isinstance(c, tuple) or hasattr(c, "_fields"):
            found = _adam_mu(c)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    cfg = _cfg(tiny=True)
    cfg.mdl.dropout = 0.0
    t = cfg.train
    t.lr, t.lr_schedule, t.grad_clip, t.skip_nonfinite, t.pos_weight = 1e-3, "const", 1e6, 3, 5.0
    t.grad_accum = accum
    pcfg = port_cfg(cfg)
    B = 4
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _random_batch(cfg, B, seed=1)
    batch["prop_mask"][1, 2, :, 4] = 0.0
    batch["srl_arg_mask"][3, 3:] = 0.0
    new_state, jaux = jax.jit(jstate.make_train_step(cfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    jgrads = params_from_jax(jax.tree.map(lambda m: np.asarray(m) / 0.1, _adam_mu(new_state.opt_state)), pcfg)

    model = get_model(pcfg, 400, device="cpu", train=True)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params), pcfg), strict=True)
    ts = TrainState.create(pcfg, model)
    ts, aux = make_train_step(pcfg)(ts, {k: torch.from_numpy(v) for k, v in batch.items()}, seed=0)

    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-4)
    assert int(aux["guard_notfinite"]) == int(jaux["guard_notfinite"]) == 0
    assert ts.step == 1
    params = dict(model.named_parameters())
    assert set(params) == set(jgrads)
    for k, p in params.items():
        ref = jgrads[k].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * max(1.0, np.abs(ref).max()), (k, err)
    assert not params["lang.embed.weight"].grad.any()  # frozen, as stop_gradient


def test_trained_embedding_gets_a_gradient():
    cfg = _cfg(tiny=True)
    cfg.mdl.dropout, cfg.mdl.train_embeddings = 0.0, True
    pcfg = port_cfg(cfg)
    model = get_model(pcfg, 400, device="cpu", train=True)
    ts = TrainState.create(pcfg, model)
    batch = {k: torch.from_numpy(v) for k, v in _random_batch(cfg, 2, seed=2).items()}
    before = model.lang.embed.weight.detach().clone()
    make_train_step(pcfg)(ts, batch, seed=0)
    assert model.lang.embed.weight.grad.any()
    assert not torch.equal(model.lang.embed.weight.detach(), before)


# --------------------------------------------------------------------------
# dropout
# --------------------------------------------------------------------------
def _logits(model, clip, seed, step):
    set_dropout_key(model, dropout_key(seed, torch.tensor(step, dtype=torch.int32)))
    with torch.no_grad():
        return model(clip)


def test_dropout_sites_train_mode_and_generator():
    """The sites, train mode, and the keyed mask (the key takes the place
    of the generator the step used to seed)."""
    cfg = _cfg(tiny=True)  # dropout 0.1
    pcfg = port_cfg(cfg)
    model = get_model(pcfg, 400, device="cpu", train=True)
    assert model.training
    n_sites = sum(isinstance(m, Dropout) for m in model.modules())
    L_obj, L_mm = pcfg.mdl.obj_tx_layers, pcfg.mdl.mm_tx_layers
    assert n_sites == 2 * (L_obj + L_mm)  # attention output + FFN hidden per layer
    clip = assemble_batch(cast_compact({k: torch.from_numpy(v) for k, v in
                                        _random_batch(cfg, 2, seed=3).items()}), pcfg.ds.conc_type)
    a, b, c = _logits(model, clip, 7, 3), _logits(model, clip, 7, 3), _logits(model, clip, 7, 4)
    assert sorted(m.site for m in model.modules() if isinstance(m, Dropout)) == list(range(n_sites))
    assert torch.equal(a, b)  # same (seed, step): same masks
    assert not torch.allclose(a, c)  # another step: other masks
    model.eval()
    ev = _logits(model, clip, 7, 3)
    assert not torch.allclose(a, ev)  # dropout was active in train mode
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    model.train()
    torch.testing.assert_close(_logits(model, clip, 7, 3), ev, rtol=0, atol=0)


def test_dropout_needs_a_generator():
    """Train-mode dropout needs its key (set_dropout_key) first; then it
    keeps x / (1 - rate) or zero."""
    d = Dropout(0.5).train()
    with pytest.raises(RuntimeError):
        d(torch.ones(4))
    d.key = dropout_key(0, torch.tensor(0))
    y = d(torch.ones(1000))
    assert set(y.unique().tolist()) == {0.0, 2.0}


KEYS = [(0, 0, 0, 0), (7, 3, 1, 2), (2**40 + 5, 123456, 0, 7), (1, 2**31 - 1, 3, 1)]


@pytest.mark.parametrize("seed,step,micro,site", KEYS)
def test_dropout_keep_same_bits(seed, step, micro, site):
    def mask():
        return dropout_keep(dropout_key(seed, torch.tensor(step, dtype=torch.int32), micro), site,
                            (3, 50, 64), 0.1)

    a = mask()
    assert a.dtype == torch.bool and a.shape == (3, 50, 64)
    assert torch.equal(a, mask())


@pytest.mark.parametrize("which", ["seed", "step", "micro", "site"])
def test_dropout_keep_differs(which):
    """Changing any one of (seed, step, microbatch, site) redraws the mask:
    two independent masks at rate 0.5 differ in half of the elements."""
    base = dict(seed=7, step=3, micro=1, site=2)
    other = dict(base, **{which: base[which] + 1})

    def mask(seed, step, micro, site):
        return dropout_keep(dropout_key(seed, torch.tensor(step, dtype=torch.int32), micro), site,
                            (64, 256), 0.5)

    diff = (mask(**base) != mask(**other)).double().mean().item()
    n = 64 * 256
    assert abs(diff - 0.5) <= 5 * np.sqrt(0.25 / n), diff


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_dropout_keep_rate_binomial(rate):
    """The kept count of 2**20 elements lies within 5 standard deviations
    of its binomial mean, and so do the kept pairs of neighbours along a
    row and down a column (no correlation between neighbours)."""
    keep = dropout_keep(dropout_key(11, torch.tensor(5, dtype=torch.int32)), 3, (1024, 1024), rate)
    p = 1 - rate

    def within(k, n, q):
        return abs(k - n * q) <= 5 * np.sqrt(n * q * (1 - q))

    n = keep.numel()
    assert within(keep.sum().item(), n, p)
    kf = keep.double()
    assert within((kf[:, 1:] * kf[:, :-1]).sum().item(), 1024 * 1023, p * p)
    assert within((kf[1:] * kf[:-1]).sum().item(), 1024 * 1023, p * p)


def test_get_model_builds_in_eval_or_train_mode():
    pcfg = port_cfg(_cfg(tiny=True))
    assert not get_model(pcfg, 50, device="cpu").training
    assert all(m.training for m in get_model(pcfg, 50, device="cpu", train=True).modules())
