"""The port's model modules against the flax modules of the JAX package,
with the flax params carried across by ``params_from_jax``: the BiLSTM,
the encoders, every transformer layer (the decomposed one included) and
the logits of img_grnd / vid_grnd / vog with the fused and dot heads and
``decomposed_mm`` on and off.

Tolerance: max |err| <= 2e-4 * max(1, max |ref|), the bound of
tests/test_torch_twin.py; both sides run fp32 on the CPU and differ only
in summation order (and the attention mask fill, -1e30 against
finfo.min, which gives the same softmax when a row has a valid key).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _cfg, _glove, _random_batch
from vog_tpu.model import encoders as jenc
from vog_tpu.model import lstm as jlstm
from vog_tpu.model import transformer as jtx
from vog_tpu.sampling import assemble_batch as jassemble
from vog_tpu.train.state import init_state
from vog_tpu_torch import config as pconfig
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.model import encoders as tenc
from vog_tpu_torch.model import lstm as tlstm
from vog_tpu_torch.model import transformer as ttx
from vog_tpu_torch.model.grounding import get_model
from vog_tpu_torch.sampling import assemble_batch as tassemble


def port_cfg(cfg):
    """The port's Cfg with the values of a JAX package Cfg."""
    out = pconfig.Cfg()
    for group in ("ds", "mdl", "train", "misc"):
        for f in dataclasses.fields(getattr(cfg, group)):
            setattr(getattr(out, group), f.name, getattr(getattr(cfg, group), f.name))
    return out


def close(got, ref, rel=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * max(1.0, np.abs(ref).max()), err


def _np_params(p):
    return jax.tree.map(np.asarray, p)


def _load(module, params, cfg, strip=""):
    sd = params_from_jax(_np_params(params), cfg)
    sd = {k[len(strip):]: v for k, v in sd.items() if k.startswith(strip)}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _cfgs(**mdl):
    cfg = _cfg(tiny=True)
    cfg.mdl.dropout = 0.0
    for k, v in mdl.items():
        setattr(cfg.mdl, k, v)
    return cfg, port_cfg(cfg)


# --------------------------------------------------------------------------
# BiLSTM and encoders
# --------------------------------------------------------------------------
def test_bilstm_matches_jax_scan():
    rng = np.random.default_rng(0)
    B, L, Din, H = 4, 9, 6, 5
    x = rng.normal(size=(B, L, Din)).astype(np.float32)
    lengths = np.array([9, 4, 1, 0], np.int32)  # full, partial, one token, empty
    mod = jlstm.TorchBiLSTM(hidden=H)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths))["params"]
    y_ref, (h_ref, _) = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(lengths))
    port = tlstm.TorchBiLSTM(Din, H)
    _load(port, {"lang": {"bilstm": params}}, None, strip="lang.bilstm.")
    with torch.no_grad():
        y, h = port(torch.from_numpy(x), torch.from_numpy(lengths))
    close(y.numpy(), y_ref, rel=1e-5)
    close(h.numpy(), h_ref, rel=1e-5)
    assert not y[3].any() and not h[3].any()


def test_encoders_match():
    cfg, pcfg = _cfgs()
    rng = np.random.default_rng(1)
    glove = _glove(cfg, 60)
    B, L, A = 3, 10, cfg.ds.max_srl_args
    tokens = rng.integers(0, 60, (B, L)).astype(np.int32)
    seq_len = np.array([10, 6, 2], np.int32)
    spans = np.sort(rng.integers(0, 6, (B, A, 2)), -1).astype(np.int32)
    roles = rng.integers(0, cfg.ds.num_roles, (B, A)).astype(np.int32)
    verb = np.array([3, 0, 1], np.int32)
    args = (tokens, seq_len, spans, roles, verb)
    lang = jenc.LangEncoder(cfg, glove)
    lp = lang.init(jax.random.PRNGKey(1), *map(jnp.asarray, args))["params"]
    ref = lang.apply({"params": lp}, *map(jnp.asarray, args))
    port = _load(tenc.LangEncoder(pcfg, 60), {"lang": lp}, pcfg, strip="lang.")
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    for k in ("arg_rep", "verb_rep", "hidden"):
        close(got[k].numpy(), ref[k])

    props = rng.normal(size=(B, 20, cfg.ds.prop_dim)).astype(np.float32)
    boxes = rng.uniform(size=(B, 20, 5)).astype(np.float32)
    seg = rng.normal(size=(B, 4, cfg.ds.seg_dim)).astype(np.float32)
    pe = jenc.PropEncoder(cfg)
    pp = pe.init(jax.random.PRNGKey(2), props, boxes)["params"]
    se = jenc.SegEncoder(cfg)
    sp = se.init(jax.random.PRNGKey(3), seg)["params"]
    tp = _load(tenc.PropEncoder(pcfg), pp, pcfg)
    ts = _load(tenc.SegEncoder(pcfg), sp, pcfg)
    with torch.no_grad():
        close(tp(torch.from_numpy(props), torch.from_numpy(boxes)).numpy(), pe.apply({"params": pp}, props, boxes))
        close(ts(torch.from_numpy(seg)).numpy(), se.apply({"params": sp}, seg))


# --------------------------------------------------------------------------
# transformer layers
# --------------------------------------------------------------------------
F_FRAMES = 10


def _layer_pair(name, cfg, pcfg):
    F = F_FRAMES
    return {
        "mha": (jtx.MultiHeadAttention(cfg), ttx.MultiHeadAttention(pcfg), "x"),
        "rel_mha": (jtx.RelMultiHeadAttention(cfg, F), ttx.RelMultiHeadAttention(pcfg, F), "x"),
        "decomposed_attn": (jtx.DecomposedRelAttention(cfg, F), ttx.DecomposedRelAttention(pcfg, F), "mg"),
        "tx_layer": (jtx.TxLayer(cfg), ttx.TxLayer(pcfg), "x"),
        "rel_tx_layer": (jtx.TxLayer(cfg, relative=True, n_frames=F),
                         ttx.TxLayer(pcfg, relative=True, n_frames=F), "x"),
        "decomposed_tx_layer": (jtx.DecomposedRelTxLayer(cfg, F), ttx.DecomposedRelTxLayer(pcfg, F), "mg"),
        "object_transformer": (jtx.ObjectTransformer(cfg), ttx.ObjectTransformer(pcfg), "x"),
        "rel_transformer": (jtx.RelTransformer(cfg, F), ttx.RelTransformer(pcfg, F), "x"),
        "rel_transformer_decomposed": (jtx.RelTransformerDecomposed(cfg, F),
                                       ttx.RelTransformerDecomposed(pcfg, F), "mg"),
    }[name]


@pytest.mark.parametrize("name", [
    "mha", "rel_mha", "decomposed_attn", "tx_layer", "rel_tx_layer", "decomposed_tx_layer",
    "object_transformer", "rel_transformer", "rel_transformer_decomposed",
])
def test_transformer_layer_matches(name):
    cfg, pcfg = _cfgs(obj_tx_layers=2, mm_tx_layers=2)
    jmod, tmod, kind = _layer_pair(name, cfg, pcfg)
    rng = np.random.default_rng(2)
    B, T, D, A = 2, 40, cfg.mdl.vis_dim, 3
    mask = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    fids = (np.arange(T) // (T // F_FRAMES)).astype(np.int32)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    g = rng.normal(size=(B, A, D)).astype(np.float32)
    jin = (x, g) if kind == "mg" else (x,)
    jargs = tuple(map(jnp.asarray, jin)) + (jnp.asarray(mask), jnp.asarray(fids))
    params = jmod.init(jax.random.PRNGKey(3), *jargs)["params"]
    ref = jmod.apply({"params": params}, *jargs)
    _load(tmod, params, pcfg)
    targs = tuple(map(torch.from_numpy, jin)) + (
        torch.from_numpy(mask), torch.from_numpy(fids).to(torch.int32)
    )
    with torch.no_grad():
        got = tmod(*targs)
    close(got.numpy(), ref)


def test_sinusoidal_pe_matches():
    pos = np.arange(13).astype(np.int32)
    close(ttx.sinusoidal_pe(torch.from_numpy(pos), 33).numpy(),
          jtx.sinusoidal_pe(jnp.asarray(pos), 33), rel=1e-6)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------
MODEL_CASES = [
    ("img_grnd", "fused", True), ("img_grnd", "dot", True),
    ("vid_grnd", "fused", True), ("vid_grnd", "dot", True),
    ("vog", "fused", True), ("vog", "fused", False),
    ("vog", "dot", True), ("vog", "dot", False),
]


@pytest.mark.parametrize("name,head,decomposed", MODEL_CASES)
def test_model_logits_match_flax(name, head, decomposed):
    cfg, _ = _cfgs(name=name, head_type=head, decomposed_mm=decomposed, mm_tx_layers=2)
    pcfg = port_cfg(cfg)
    B = 2
    state = init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _random_batch(cfg, B, seed=3)
    batch["prop_mask"][1, 2, :, 4] = 0.0  # padded proposal slots
    ref = np.asarray(state.apply_fn(
        {"params": state.params},
        jassemble({k: jnp.asarray(v) for k, v in batch.items()}, cfg.ds.conc_type),
        deterministic=True,
    ))
    model = get_model(pcfg, 400, device="cpu")
    model.load_state_dict(params_from_jax(_np_params(state.params), pcfg), strict=True)
    with torch.no_grad():
        got = model(tassemble({k: torch.from_numpy(v) for k, v in batch.items()}, pcfg.ds.conc_type))
    close(got.numpy(), ref)


def test_params_from_jax_rejects_wrong_head():
    cfg, pcfg = _cfgs(name="img_grnd")
    state = init_state(cfg, _glove(cfg, 50), jax.random.PRNGKey(0), 1)
    pcfg.mdl.head_type = "dot"
    with pytest.raises(ValueError):
        params_from_jax(_np_params(state.params), pcfg)


def test_get_model_raises_without_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, pcfg = _cfgs()
    with pytest.raises(RuntimeError):
        get_model(pcfg, 50)
