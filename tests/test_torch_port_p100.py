"""The port in the P100 regime (100 proposals a frame) against the JAX
package on the CPU, and the repairs that came with it:

  * VOGNet SPAT P100 at narrow widths (vis 32, 2 heads; ``_cfg(tiny=True)``)
    with ``ds.num_frms`` cut from 10 to 3, so that T = 3 frames x 4 videos x
    100 proposals = 1200 >= 1024 and the JAX package takes its P100 branch
    (``remat_head``): the forward logits (2e-4 x max(1, max|ref|), as
    tests/test_torch_port_model.py) and one train step's loss, grad_norm
    (1e-4 relative) and every gradient (1e-4 x max(1, max|g|)), as
    tests/test_torch_port_train.py;
  * the int8 device-table gather at P100 rows against
    ``vog_tpu.data.device_store.gather_from_tables`` (bitwise);
  * the backward-mode resolvers against the JAX package's, for every
    argument and ``VOG_FLASH_BWD`` / ``VOG_MM_BWD`` value, a bad one
    included;
  * ``apply_matmul_precision``: ``get_model`` alone turns both TF32
    switches off at "highest" and "float32" and on at "default", "high",
    "tensorfloat32" and "bfloat16" (JAX's six names), and a name JAX
    refuses raises; the model at "high" against the JAX package's at
    "high";
  * the fused head at A = 6 and 8 (two kernel launches of 3 or 4 args on
    the card) against the JAX package's head kernel in interpret mode,
    forward and all 9 gradients (atol 5e-4, rtol 1e-3: the JAX package's
    own head-gradient tolerance, tests/test_head_kernel.py);
  * ``get_model`` on the card refuses the shapes its kernels do not take
    (a head dim that is not a whole number of at least 1, which the JAX
    package's heads do not take either), and names the config key;
    ``check_kernel_shapes`` passes what the JAX package runs: head dims of
    256, 512 and 1024 and one not a multiple of 8, the fused head at D 300,
    1024 and 2080, 70 frames and 9 args.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _cfg, _glove, _random_batch
from tests.test_torch_port_grads import _grads, _jax_grads
from tests.test_torch_port_model import close, port_cfg
from tests.test_torch_port_train import _adam_mu
from vog_tpu.config import post_proc_config as jpost_proc_config
from vog_tpu.data import device_store as jstore
from vog_tpu.kernels.attention import _resolve_bwd_mode as jflash_mode
from vog_tpu.kernels.grounding_head import fused_grounding_head as jhead
from vog_tpu.kernels.mm_attention import _resolve_mm_bwd_mode as jmm_mode
from vog_tpu.sampling import assemble_batch as jassemble
from vog_tpu.train import state as jstate
from vog_tpu_torch.config import Cfg, apply_matmul_precision, post_proc_config
from vog_tpu_torch.data import device_store as tstore
from vog_tpu_torch.interop.from_jax import params_from_jax
from vog_tpu_torch.kernels import attention, grounding_head, mm_attention
from vog_tpu_torch.model.grounding import check_kernel_shapes, get_model
from vog_tpu_torch.sampling import assemble_batch
from vog_tpu_torch.train import TrainState, make_train_step


def _p100_cfg():
    """The P100 setting at narrow widths, 3 frames: T = 1200."""
    cfg = _cfg(tiny=True)
    cfg.ds.exp_setting = "p100"
    cfg.ds.num_frms = 3
    cfg.mdl.dropout = 0.0
    cfg = jpost_proc_config(cfg)
    V, F, P = cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm
    assert (V, F, P) == (4, 3, 100) and V * F * P >= 1024  # the JAX package's remat_head branch
    return cfg


def _p100_batch(cfg, B, seed):
    batch = _random_batch(cfg, B, seed=seed)
    batch["prop_mask"][1, 2, :, 90:] = 0.0  # padded proposal slots
    batch["srl_arg_mask"][0, 3:] = 0.0
    return batch


def test_p100_logits_match_flax():
    cfg = _p100_cfg()
    pcfg = port_cfg(cfg)
    B = 2
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _p100_batch(cfg, B, seed=3)
    ref = np.asarray(state.apply_fn(
        {"params": state.params},
        jassemble({k: jnp.asarray(v) for k, v in batch.items()}, cfg.ds.conc_type),
        deterministic=True,
    ))
    model = get_model(pcfg, 400, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params), pcfg), strict=True)
    with torch.no_grad():
        got = model(assemble_batch({k: torch.from_numpy(v) for k, v in batch.items()}, pcfg.ds.conc_type))
    assert tuple(got.shape) == (B, cfg.ds.max_srl_args, 1200)
    close(got.numpy(), ref)


def test_p100_train_step_matches_jax():
    cfg = _p100_cfg()
    t = cfg.train
    t.lr, t.lr_schedule, t.grad_clip, t.skip_nonfinite, t.pos_weight = 1e-3, "const", 1e6, 3, 20.0
    pcfg = port_cfg(cfg)
    B = 2
    state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
    batch = _p100_batch(cfg, B, seed=1)
    new_state, jaux = jax.jit(jstate.make_train_step(cfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    jgrads = params_from_jax(jax.tree.map(lambda m: np.asarray(m) / 0.1, _adam_mu(new_state.opt_state)), pcfg)

    model = get_model(pcfg, 400, device="cpu", train=True)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params), pcfg), strict=True)
    ts, aux = make_train_step(pcfg)(TrainState.create(pcfg, model),
                                    {k: torch.from_numpy(v) for k, v in batch.items()}, seed=0)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-4)
    assert int(aux["guard_notfinite"]) == int(jaux["guard_notfinite"]) == 0
    params = dict(model.named_parameters())
    assert set(params) == set(jgrads)
    for k, p in params.items():
        ref = jgrads[k].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * max(1.0, np.abs(ref).max()), (k, err)


def test_int8_gather_at_p100_rows_matches_jax():
    cfg = _p100_cfg()
    cfg.ds.prop_dim, cfg.ds.seg_dim = 128, 96  # row widths cut; the layout stays 3-D for feats
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(5)
    N, B, V, F, P = 7, 2, cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm
    feats = rng.normal(scale=0.3, size=(N, F, P, cfg.ds.prop_dim)).astype(np.float32)
    feats[3, 1, 7] = 0.0  # a zero vector: scale 1
    seg = rng.normal(scale=0.3, size=(N, F, cfg.ds.seg_dim)).astype(np.float32)
    rows = rng.integers(0, N, (B, V)).astype(np.int32)
    pmask = np.ones((B, V, F, P), np.float32)
    host = jstore._pack_rows({"feats": feats, "seg": seg}, np.float32, True)
    want = jax.jit(jstore.gather_from_tables)(
        {"vid_rows": jnp.asarray(rows), "prop_mask": jnp.asarray(pmask)},
        {k: jnp.asarray(v) for k, v in host.items()},
    )
    tables = tstore.DeviceFeatureTables.from_arrays(pcfg, feats, seg, int8=True, device="cpu", chunk_rows=3)
    assert tables.tables["feats"].dtype == torch.int8 and tables.tables["feats"].dim() == 3
    got = tstore.gather_from_tables(
        {"vid_rows": torch.from_numpy(rows), "prop_mask": torch.from_numpy(pmask)}, tables.tables)
    assert tuple(got["props"].shape) == (B, V, F, P, cfg.ds.prop_dim)
    for k in ("props", "seg_feats"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["flash", "mm"])
@pytest.mark.parametrize("env", [None, "auto", "emit", "recompute", "bogus"])
@pytest.mark.parametrize("mode", [None, "auto", "emit", "recompute", "bogus"])
def test_bwd_mode_resolution_matches_jax(monkeypatch, kind, env, mode):
    var, port, ref = {"flash": ("VOG_FLASH_BWD", attention.resolve_bwd_mode, jflash_mode),
                      "mm": ("VOG_MM_BWD", mm_attention.resolve_bwd_mode, jmm_mode)}[kind]
    if env is None:
        monkeypatch.delenv(var, raising=False)
    else:
        monkeypatch.setenv(var, env)
    try:
        want = ref(mode)
    except ValueError:
        with pytest.raises(ValueError):
            port(mode)
        return
    assert port(mode) == want


def test_get_model_applies_matmul_precision(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    pcfg = port_cfg(_cfg(tiny=True))
    assert pcfg.misc.matmul_precision == "highest"
    get_model(pcfg, 50, device="cpu", train=True)  # no Predictor built
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    pcfg.misc.matmul_precision = "default"  # the production recipe's: TF32 on, both switches
    get_model(pcfg, 50, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True
    for name, on in (("high", True), ("float32", False), ("tensorfloat32", True), ("highest", False),
                     ("bfloat16", True)):  # JAX's other names, each on its path, from either state
        pcfg.misc.matmul_precision = name
        get_model(pcfg, 50, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is on, name
        assert torch.backends.cudnn.allow_tf32 is on, name
    pcfg.misc.matmul_precision = "fastest"  # a name jax_default_matmul_precision refuses too
    with pytest.raises(ValueError, match="misc.matmul_precision"):
        apply_matmul_precision(pcfg)
    with pytest.raises(ValueError, match="misc.matmul_precision"):
        get_model(pcfg, 50, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is True  # a refused name leaves the switches as they were


def test_model_at_high_matches_jax_at_high(monkeypatch):
    """The port's model built at ``misc.matmul_precision="high"`` against
    the JAX package's under ``jax_default_matmul_precision="high"`` (its
    kernels in interpret mode, as they run on the CPU), the fused head and
    the decomposed mm layer on: the logits within the fp32 bound of
    tests/test_torch_port_model.py.  Neither side runs TF32 on the CPU."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = _cfg(tiny=True)
    cfg.mdl.dropout = 0.0
    cfg.mdl.name, cfg.mdl.head_type, cfg.mdl.decomposed_mm = "vog", "fused", True
    cfg.misc.matmul_precision = "high"
    pcfg = port_cfg(cfg)
    B = 2
    with jax.default_matmul_precision("high"):
        state = jstate.init_state(cfg, _glove(cfg, 400), jax.random.PRNGKey(0), B)
        batch = _random_batch(cfg, B, seed=3)
        ref = np.asarray(state.apply_fn(
            {"params": state.params}, jassemble({k: jnp.asarray(v) for k, v in batch.items()}, cfg.ds.conc_type),
            deterministic=True))
    model = get_model(pcfg, 400, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is True  # "high" took the "default" path
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params), pcfg), strict=True)
    with torch.no_grad():
        got = model(assemble_batch({k: torch.from_numpy(v) for k, v in batch.items()}, pcfg.ds.conc_type))
    close(got.numpy(), ref)


@pytest.mark.parametrize("A", [6, 8])
def test_head_more_args_than_a_launch_matches_jax(A):
    groups = grounding_head.arg_groups(A)
    assert len(groups) == 2 and all(b - a <= grounding_head.KERNEL_ARGS for a, b in groups)
    rng = np.random.default_rng(6)
    B, T, D = 2, 40, 128
    Dh = D // 2
    r = lambda *s, sc=1.0: (rng.normal(size=s, scale=0.5) * sc).astype(np.float32)  # noqa: E731
    args = (r(B, T, D), r(B, A, D), r(B, T, D), r(B, A, D), r(D, D, sc=D**-0.5),
            r(D, Dh, sc=D**-0.5), r(Dh), r(Dh, sc=Dh**-0.5), np.float32(0.3))
    cot = rng.normal(size=(B, A, T)).astype(np.float32)
    with torch.no_grad():
        got = grounding_head.fused_grounding_head(*(torch.as_tensor(a) for a in args))
    ref = jhead(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    diff = tuple(range(9))
    got = _grads(grounding_head.fused_grounding_head, args, diff, cot)
    ref = _jax_grads(lambda *a: jhead(*a, interpret=True), args, diff, cot)
    names = ("dvis", "darg", "dwv", "dwl", "dwx", "dw1", "db1", "dw2", "db2")
    for name, a, b in zip(names, got, ref):
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape), atol=5e-4, rtol=1e-3, err_msg=name)


def _prod_cfg(**over):
    """The production widths (vis 512, 4 heads), VOGNet SPAT, fused head."""
    cfg = Cfg()
    cfg.mdl.name, cfg.ds.conc_type, cfg.mdl.decomposed_mm = "vog", "spat", True
    for key, v in over.items():
        group, name = key.split(".")
        setattr(getattr(cfg, group), name, v)
    return post_proc_config(cfg)


@pytest.mark.parametrize("over,key", [
    ({"mdl.vis_dim": 1000, "mdl.n_heads": 3}, "mdl.vis_dim"),  # no whole head dim
    ({"mdl.vis_dim": 2, "mdl.n_heads": 4}, "mdl.vis_dim / mdl.n_heads"),  # a head dim below 1
])
def test_get_model_on_the_card_names_the_key_of_a_shape_out_of_range(over, key):
    cfg = _prod_cfg(**over)
    with pytest.raises(ValueError, match=re.escape(key)):
        get_model(cfg, 50)  # the card, by default: checked before the device
    with pytest.raises(ValueError, match=re.escape(key)):
        get_model(cfg, 50, device="cuda")
    for A in (5, 6, 8):  # the kernels take up to 8 args, the head in groups
        check_kernel_shapes(_prod_cfg(**{"ds.max_srl_args": A, "ds.exp_setting": "p100"}))


@pytest.mark.parametrize("over", [
    {"mdl.n_heads": 2},  # head dim 256: the attention kernels' widest instance
    {"ds.num_frms": 70},  # 70 frames: the frame-bias table from device memory, its gradient in 64-frame tiles
    {"ds.max_srl_args": 9},  # 9 args: the mm kernels in groups of 5 + 4
    {"mdl.vis_dim": 1024, "mdl.n_heads": 8},  # the fused head at D 1024 (Dh 512): its wide path
    {"mdl.vis_dim": 1024, "mdl.n_heads": 2},  # head dim 512: the attention kernels' wide path
    {"mdl.vis_dim": 300},  # D 300 (head padded to 320), head dim 75
    {"mdl.vis_dim": 2080},  # D 2080, head dim 520
    {"mdl.vis_dim": 1024, "mdl.n_heads": 1},  # head dim 1024
])
def test_check_kernel_shapes_takes_what_the_jax_package_runs(over):
    """Shapes the card refused before its kernels took every head dim
    (past 256 their wide path), any frame count, any arg count and the
    fused head at any width: ``check_kernel_shapes`` passes them, as the
    JAX package runs them."""
    check_kernel_shapes(_prod_cfg(**over))
    check_kernel_shapes(_prod_cfg(**over, **{"ds.conc_type": "temp", "ds.exp_setting": "p100"}))
