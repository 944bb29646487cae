"""The production recipe's numerics in the port (``mdl.dtype="bfloat16"``,
``misc.matmul_precision="default"``) against the JAX package on the CPU,
with the flax params carried across by ``params_from_jax``:

  * modules in bf16 (the encoders, the transformer layers with their
    LayerNorms and FFNs, the decomposed layer, both heads) against the
    JAX modules in bf16: max |err| <= 1.6e-2 * max(1, max |ref|), four bf16
    roundings of the largest value (2^-8 each): both sides round every
    Dense output and LayerNorm result to bf16, in other places where the
    fp32 sums differ in their last bits (the decomposed attention alone is
    bitwise equal, measured);
  * the kernels at their bf16-mode call sites: operands rounded to bf16
    and cast to fp32, as the port's call sites hand them over, against the
    JAX package's Pallas kernels in interpret mode under
    ``jax.default_matmul_precision("default")``, forward and gradients.
    Both sides take fp32 operands, so the fp32 bounds of
    tests/test_torch_port_kernels.py and tests/test_torch_port_grads.py
    hold (the JAX package's own bounds for its kernels against XLA);
  * the whole model: logits within 3e-2 * max |ref| (the JAX package's
    bf16-against-fp32 bound, tests/test_bf16_mode.py).  Looser than the
    modules: on the CPU the JAX model takes its XLA branches (its kernels
    are gated on a TPU backend), which round the head's (B, A, T, D)
    intermediates and the attention probabilities to bf16, while the port
    keeps the kernels' semantics (fp32 operands, fp32 intermediates).  The
    models take the fused head, the production recipe's and the one that
    bound was set on.  With the dot head at init the logits are small and
    the JAX package's own bf16 logits lie farther than that bound from its
    fp32 ones, so there the port's bf16 logits are held no farther from
    the JAX bf16 ones than those lie from the JAX fp32 ones;
  * one train step against the JAX bf16 step: loss within 2e-2 relative,
    the Adam update's cosine > 0.97 (tests/test_bf16_mode.py's bounds);
  * contracts: parameters, gradients, the flat gradient, the optimizer
    state and the logits are fp32 in bf16 mode, and the kernels get fp32
    operands;
  * flags: ``apply_matmul_precision`` at "default" turns both TF32
    switches on and leaves CPU products fp32, ``kernel_precision`` and the
    graph caches' ``numerics_key`` follow it.  A fixture restores both
    switches; JAX's precision is set only inside
    ``with jax.default_matmul_precision(...)``, so no other test file on
    the same worker sees it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _glove, _random_batch
from tests.test_torch_port_grads import _grads, _jax_grads
from tests.test_torch_port_model import F_FRAMES, _cfgs, _layer_pair, _load, _np_params, port_cfg
from vog_tpu.kernels.attention import flash_attention as jflash
from vog_tpu.kernels.grounding_head import fused_grounding_head as jhead
from vog_tpu.kernels.mm_attention import mm_shared_qk_attention as jmm
from vog_tpu.model import encoders as jenc
from vog_tpu.model import grounding as jgr
from vog_tpu.sampling import assemble_batch as jassemble
from vog_tpu.train import state as jstate
from vog_tpu_torch.config import apply_matmul_precision, kernel_precision
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.kernels import attention, grounding_head, mm_attention
from vog_tpu_torch.model import encoders as tenc
from vog_tpu_torch.model import grounding as tgr
from vog_tpu_torch.model.grounding import get_model
from vog_tpu_torch.sampling import assemble_batch as tassemble
from vog_tpu_torch.train import TrainState, make_train_step
from vog_tpu_torch.train.graphs import numerics_key

MODULE_TOL = 1.6e-2


@pytest.fixture(autouse=True)
def tf32_switches():
    """Restore both TF32 switches after each test."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _bf16(*mdl):
    """(JAX cfg, port cfg) of the tiny model in the production numerics."""
    cfg, _ = _cfgs(**dict(mdl))
    cfg.mdl.dtype, cfg.misc.matmul_precision = "bfloat16", "default"
    return cfg, port_cfg(cfg)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _as_bf16(x):
    """fp32 numpy values rounded to bf16 and back: what a bf16 call site
    hands its kernel."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


# --------------------------------------------------------------------------
# modules in bf16
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["prop", "seg", "lang", "fused_head", "dot_head"])
def test_encoder_and_head_modules_bf16_match(name):
    cfg, pcfg = _bf16(("head_type", "dot" if name == "dot_head" else "fused"))
    rng = np.random.default_rng(1)
    B, T, A, D = 2, 20, cfg.ds.max_srl_args, cfg.mdl.vis_dim
    if name == "lang":
        glove = _glove(cfg, 60)
        L = 10
        args = (rng.integers(0, 60, (B, L)).astype(np.int32), np.array([10, 6], np.int32),
                np.sort(rng.integers(0, 6, (B, A, 2)), -1).astype(np.int32),
                rng.integers(0, cfg.ds.num_roles, (B, A)).astype(np.int32), np.array([3, 0], np.int32))
        jmod, tmod, strip = jenc.LangEncoder(cfg, glove), tenc.LangEncoder(pcfg, 60), "lang."
        wrap = {"lang": None}
    elif name == "prop":
        args = (rng.normal(size=(B, T, cfg.ds.prop_dim)).astype(np.float32),
                rng.uniform(size=(B, T, 5)).astype(np.float32))
        jmod, tmod, strip, wrap = jenc.PropEncoder(cfg), tenc.PropEncoder(pcfg), "", None
    elif name == "seg":
        args = (rng.normal(size=(B, 4, cfg.ds.seg_dim)).astype(np.float32),)
        jmod, tmod, strip, wrap = jenc.SegEncoder(cfg), tenc.SegEncoder(pcfg), "", None
    else:
        vis = _as_bf16(rng.normal(size=(B, T, D)))
        arg = _as_bf16(rng.normal(size=(B, A, D)))
        args = (vis, arg)
        if name == "fused_head":
            jmod, tmod = jgr.GroundingHead(cfg), tgr.GroundingHead(pcfg)
        else:
            jmod, tmod = jgr.DotGroundingHead(cfg), tgr.DotGroundingHead(pcfg)
        strip, wrap = "head.", {"head": None}
    jin = tuple(jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32 and name.endswith("head")
                else jnp.asarray(a) for a in args)
    params = jmod.init(jax.random.PRNGKey(2), *jin)["params"]
    ref = jmod.apply({"params": params}, *jin)
    tree = params if wrap is None else {next(iter(wrap)): params}
    _load(tmod, tree, pcfg, strip=strip)
    tin = tuple(torch.from_numpy(a).bfloat16() if a.dtype == np.float32 and name.endswith("head")
                else torch.from_numpy(a) for a in args)
    with torch.no_grad():
        got = tmod(*tin)
    if name == "lang":
        assert got["arg_rep"].dtype == torch.bfloat16 and got["hidden"].dtype == torch.float32
        _close(got["arg_rep"].float().numpy(), ref["arg_rep"], MODULE_TOL)
        _close(got["hidden"].numpy(), ref["hidden"], 2e-4)  # the BiLSTM stays fp32
        return
    want = torch.float32 if name.endswith("head") else torch.bfloat16  # logits are fp32
    assert got.dtype == want and ref.dtype == (jnp.float32 if want == torch.float32 else jnp.bfloat16)
    _close(got.float().numpy(), ref, MODULE_TOL)


@pytest.mark.parametrize("name", [
    "tx_layer", "rel_tx_layer", "decomposed_attn", "decomposed_tx_layer", "object_transformer",
    "rel_transformer_decomposed",
])
def test_transformer_layers_bf16_match(name):
    cfg, pcfg = _bf16(("obj_tx_layers", 2), ("mm_tx_layers", 2))
    jmod, tmod, kind = _layer_pair(name, cfg, pcfg)
    rng = np.random.default_rng(2)
    B, T, D, A = 2, 40, cfg.mdl.vis_dim, 3
    mask = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    fids = (np.arange(T) // (T // F_FRAMES)).astype(np.int32)
    ins = (rng.normal(size=(B, T, D)), rng.normal(size=(B, A, D)))[: 2 if kind == "mg" else 1]
    jargs = tuple(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16) for x in ins) + (
        jnp.asarray(mask), jnp.asarray(fids))
    params = jmod.init(jax.random.PRNGKey(3), *jargs)["params"]
    ref = jmod.apply({"params": params}, *jargs)
    _load(tmod, params, pcfg)
    targs = tuple(torch.from_numpy(x.astype(np.float32)).bfloat16() for x in ins) + (
        torch.from_numpy(mask), torch.from_numpy(fids))
    with torch.no_grad():
        got = tmod(*targs)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    _close(got.float().numpy(), ref, MODULE_TOL)


# --------------------------------------------------------------------------
# kernels at their bf16-mode call sites, at "default" precision
# --------------------------------------------------------------------------
def _attn_args(seed, B, H, T, dh, F):
    rng = np.random.default_rng(seed)
    q, k, v = (_as_bf16(rng.normal(size=(B, H, T, dh))) for _ in range(3))
    mask = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    fb = rng.normal(scale=0.5, size=(H, F, F)).astype(np.float32)
    fid = (np.arange(T) // max(T // F, 1)).clip(0, F - 1).astype(np.int32)
    return rng, q, k, v, mask, fb, fid


@pytest.mark.parametrize("kernel,mode", [
    ("flash", "recompute"), ("flash", "emit"), ("mm", "emit"), ("mm", "recompute"), ("head", None),
])
def test_kernel_call_sites_at_default_match_pallas(kernel, mode):
    apply_matmul_precision(_bf16()[1])
    assert kernel_precision() == "default"
    if kernel == "flash":
        rng, q, k, v, mask, fb, fid = _attn_args(0, 2, 2, 50, 16, 10)
        args, diff, out_names = (q, k, v, mask, fb, fid), (0, 1, 2, 4), ("o", "dq", "dk", "dv", "dfb")
        port = lambda *a: attention.flash_attention(*a, bwd_mode=mode)  # noqa: E731
        ref_fn = lambda *a: jflash(*a, interpret=True, bwd_mode=mode)  # noqa: E731
        cot = rng.normal(size=q.shape).astype(np.float32)
        fwd_tol, grad_tol = dict(atol=2e-5, rtol=1e-4), dict(atol=5e-5, rtol=1e-3)
    elif kernel == "mm":
        rng, q, k, v, mask, fb, fid = _attn_args(2, 1, 2, 40, 16, 10)
        cn = rng.uniform(-3.0, 0.0, (1, 2, 3, 40)).astype(np.float32)
        args, diff, out_names = (q * 0.25, k, v, cn, mask, fb, fid), (0, 1, 2, 3, 5), (
            "o", "dq", "dk", "dv", "dcn", "dfb")
        port = lambda *a: mm_attention.mm_shared_qk_attention(*a, bwd_mode=mode)  # noqa: E731
        ref_fn = lambda *a: jmm(*a, interpret=True, bwd_mode=mode)  # noqa: E731
        cot = rng.normal(size=(1, 2, 3, 40, 16)).astype(np.float32)
        fwd_tol, grad_tol = dict(atol=3e-5, rtol=1e-4), dict(atol=1e-4, rtol=1e-3)
    else:
        rng = np.random.default_rng(4)
        B, T, A, D = 2, 70, 3, 128
        Dh = D // 2
        r = lambda *s, sc=1.0: (rng.normal(size=s, scale=0.5) * sc).astype(np.float32)  # noqa: E731
        # vis, arg and the stems wv, wl come from bf16 activations; the weights are fp32 params
        args = (_as_bf16(r(B, T, D)), _as_bf16(r(B, A, D)), _as_bf16(r(B, T, D)), _as_bf16(r(B, A, D)),
                r(D, D, sc=D**-0.5), r(D, Dh, sc=D**-0.5), r(Dh), r(Dh, sc=Dh**-0.5), np.float32(0.3))
        diff, out_names = tuple(range(9)), ("logits",) + tuple(f"grad {i}" for i in range(9))
        port, ref_fn = grounding_head.fused_grounding_head, lambda *a: jhead(*a, interpret=True)
        cot = rng.normal(size=(B, A, T)).astype(np.float32)
        fwd_tol, grad_tol = dict(atol=2e-4), dict(atol=5e-4, rtol=1e-3)
    with jax.default_matmul_precision("default"):
        ref_out = np.asarray(ref_fn(*(None if a is None else jnp.asarray(a) for a in args)))
        ref = _jax_grads(ref_fn, args, diff, cot)
    with torch.no_grad():
        got_out = port(*(torch.from_numpy(np.array(a)) for a in args))
    assert got_out.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), ref_out, err_msg=out_names[0], **fwd_tol)
    got = _grads(port, args, diff, cot)
    for name, a, b in zip(out_names[1:], got, ref):
        np.testing.assert_allclose(a, np.reshape(b, a.shape), err_msg=name, **grad_tol)


# --------------------------------------------------------------------------
# whole model and train step against the JAX package in bf16
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name,head,decomposed", [
    ("vog", "fused", True), ("vog", "fused", False), ("vid_grnd", "fused", True), ("img_grnd", "fused", True),
])
def test_model_logits_bf16_match_flax(name, head, decomposed):
    cfg, pcfg = _bf16(("name", name), ("head_type", head), ("decomposed_mm", decomposed),
                      ("mm_tx_layers", 2))
    B = 2
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _random_batch(cfg, B, seed=3)
    batch["prop_mask"][1, 2, :, 4] = 0.0
    with jax.default_matmul_precision("default"):
        ref = np.asarray(state.apply_fn(
            {"params": state.params}, jassemble({k: jnp.asarray(v) for k, v in batch.items()},
                                                cfg.ds.conc_type), deterministic=True))
    model = get_model(pcfg, 400, device="cpu")
    model.load_state_dict(params_from_jax(_np_params(state.params), pcfg), strict=True)
    with torch.no_grad():
        got = model(tassemble({k: torch.from_numpy(v) for k, v in batch.items()}, pcfg.ds.conc_type))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= 3e-2 * float(np.abs(ref).max()), err


def test_model_logits_bf16_dot_head_within_jax_own_bf16_spread():
    cfg, pcfg = _bf16(("name", "vog"), ("head_type", "dot"), ("mm_tx_layers", 2))
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), 2)
    clip = jassemble({k: jnp.asarray(v) for k, v in _random_batch(cfg, 2, seed=3).items()}, cfg.ds.conc_type)
    ref = {}
    for dt in ("float32", "bfloat16"):
        cfg.mdl.dtype = dt  # flax reads the dtype at apply time; the params are fp32 in both
        with jax.default_matmul_precision("default"):
            ref[dt] = np.asarray(state.apply_fn({"params": state.params}, clip, deterministic=True))
    model = get_model(pcfg, 400, device="cpu")
    model.load_state_dict(params_from_jax(_np_params(state.params), pcfg), strict=True)
    batch = _random_batch(cfg, 2, seed=3)
    with torch.no_grad():
        got = model(tassemble({k: torch.from_numpy(v) for k, v in batch.items()}, pcfg.ds.conc_type)).numpy()
    spread = float(np.abs(ref["bfloat16"] - ref["float32"]).max())
    assert spread > 0 and float(np.abs(got - ref["bfloat16"]).max()) <= spread


def test_train_step_bf16_tracks_jax():
    cfg, pcfg = _bf16(("dropout", 0.0))
    t = cfg.train
    t.lr, t.lr_schedule, t.grad_clip, t.skip_nonfinite, t.pos_weight = 1e-3, "const", 1e6, 3, 5.0
    pcfg = port_cfg(cfg)
    B = 4
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _random_batch(cfg, B, seed=1)
    with jax.default_matmul_precision("default"):
        new_state, jaux = jax.jit(jstate.make_train_step(cfg))(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    before = params_from_jax(_np_params(state.params), pcfg)
    jupd = {k: v - before[k] for k, v in params_from_jax(_np_params(new_state.params), pcfg).items()}

    model = get_model(pcfg, 400, device="cpu", train=True)
    model.load_state_dict(before, strict=True)
    ts = TrainState.create(pcfg, model)
    ts, aux = make_train_step(pcfg)(ts, {k: torch.from_numpy(v) for k, v in batch.items()}, seed=0)
    loss, jloss = float(aux["loss"]), float(jaux["loss"])
    assert np.isfinite(loss) and abs(loss - jloss) <= 2e-2 * abs(jloss), (loss, jloss)
    after = dict(model.named_parameters())
    a = np.concatenate([(after[k].detach() - before[k]).numpy().ravel() for k in before])
    b = np.concatenate([jupd[k].numpy().ravel() for k in before])
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
    assert cos > 0.97, cos


# --------------------------------------------------------------------------
# contracts and flags
# --------------------------------------------------------------------------
def test_bf16_mode_keeps_params_grads_state_and_logits_fp32(monkeypatch):
    cfg, pcfg = _bf16(("dropout", 0.1), ("mm_tx_layers", 2))
    model = get_model(pcfg, 400, device="cpu", train=True)
    assert model.dt == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    seen = []

    def spy(mod, fn):
        real = getattr(mod, fn)

        def run(*a, **kw):
            seen.append((fn, {x.dtype for x in a if isinstance(x, torch.Tensor)}))
            return real(*a, **kw)
        monkeypatch.setattr(mod, fn, run)

    for mod, fn in ((attention, "flash_attention_fwd"), (mm_attention, "mm_attention_fwd"),
                    (grounding_head, "grounding_head_fwd"), (attention, "flash_attention_bwd"),
                    (mm_attention, "mm_attention_bwd"), (grounding_head, "grounding_head_bwd")):
        spy(mod, fn)
    ts = TrainState.create(pcfg, model)
    batch = {k: torch.from_numpy(v) for k, v in _random_batch(cfg, 2, seed=5).items()}
    ts, aux = make_train_step(pcfg)(ts, batch, seed=0)
    assert np.isfinite(float(aux["loss"])) and aux["loss"].dtype == torch.float32
    assert {fn for fn, _ in seen} == {"flash_attention_fwd", "mm_attention_fwd", "grounding_head_fwd",
                                      "flash_attention_bwd", "mm_attention_bwd", "grounding_head_bwd"}
    # the kernels take fp32 operands (frame ids int32)
    assert all(dts <= {torch.float32, torch.int32} for _, dts in seen), seen
    assert ts.flat.grad.dtype == torch.float32
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert ts.opt_state["mu"].dtype == ts.opt_state["nu"].dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with torch.no_grad():
        logits = model.eval()(tassemble(batch, pcfg.ds.conc_type))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_default_precision_sets_both_switches_and_keeps_cpu_products_fp32():
    _, pcfg = _bf16()
    model = get_model(pcfg, 50, device="cpu")  # applies misc.matmul_precision
    assert torch.backends.cuda.matmul.allow_tf32 is True and torch.backends.cudnn.allow_tf32 is True
    assert kernel_precision() == "default"
    key_default = numerics_key(model)
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(64, 256)), rng.normal(size=(256, 48))
    got = torch.from_numpy(a).float() @ torch.from_numpy(b).float()
    # fp32 accumulation: ~1e-6 relative; a TF32 or bf16 product would be ~1e-3
    assert float((got.double() - torch.from_numpy(a @ b)).abs().max()) <= 1e-4
    pcfg.misc.matmul_precision = "highest"
    apply_matmul_precision(pcfg)
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False
    assert kernel_precision() == "highest"
    assert numerics_key(model) != key_default  # a graph captured at one precision is not replayed at the other
    assert numerics_key(get_model(port_cfg(_cfgs()[0]), 50, device="cpu")) != numerics_key(model)
