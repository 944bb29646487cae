"""The port's sequence-parallel ring (kernels/ring_attention.py, the
``mdl.sp_attention`` dispatch of model/transformer.py) in worlds of gloo
processes on the CPU (``tests/_torch_dist_worker.py``):

  * (3) ``ring_attention`` over model axes of 2 and 4 ranks against the
    JAX package's ``ring_attention`` (on its virtual CPU devices) and
    ``xla_attention``, with and without the frame bias, under a ragged key
    mask with a batch row whose keys are all padding: the output within
    2e-5 and every gradient (q, k, v, the bias summed over the ranks)
    within 3e-5, the JAX ring's own bounds
    (``tests/test_ring_attention.py``); the backward is the port's
    hand-written second ring;
  * (4) VOGNet with ``mdl.sp_attention`` in a (1, 2) world (the ring in
    the object transformer and, with ``decomposed_mm`` off, in the
    multimodal layer with its bias; tensor parallelism elsewhere) against
    the JAX package's single-device loss and gradients: loss within 1e-5
    relative, gradients atol 5e-5, rtol 1e-3;
  * (6) a ``Predictor`` on a model axis of 2 with the ring: rank 0's
    ``ServingLoop`` flushes, rank 1 follows them, and every response's
    scores are the single-process predictor's within 2e-4 x max|score|.

Each world is killed and fails at 50 s (``run_world``).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _glove, _random_batch
from tests._torch_dist_worker import ring_cases, run_world, serve_follow, tp_steps
from tests.test_torch_port_dist import GLOBAL_B, VOCAB, _jax_cfg
from tests.test_torch_port_model import port_cfg
from vog_tpu.kernels.ring_attention import ring_attention as jring
from vog_tpu.model.transformer import xla_attention
from vog_tpu_torch.interop.from_jax import params_from_jax


def _inputs(B=3, H=2, F=8, Pn=8, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    T = F * Pn
    q, k, v, cot = (rng.normal(size=(B, H, T, dh)).astype(np.float32) for _ in range(4))
    mask = (rng.uniform(size=(B, T)) > 0.3).astype(np.float32)
    mask[:2, :Pn] = 1.0  # frame 0 valid (the model invariant) ...
    mask[2] = 0.0  # ... but one row all padding: the finite mask value's case
    fids = np.repeat(np.arange(F), Pn).astype(np.int32)
    bias = (0.1 * rng.normal(size=(H, F, F))).astype(np.float32)
    return q, k, v, mask, bias, fids, cot


def _jax_mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[: 2 * n]).reshape(2, n), ("data", "model"))


@pytest.fixture(scope="module", params=[2, 4], ids=["ring2", "ring4"])
def ring(request):
    """Per bias on/off: (the port's blocks joined, the JAX ring's output
    and gradients, the dense path's)."""
    n = request.param
    q, k, v, mask, bias, fids, cot = _inputs(seed=n)
    cases = [tuple(torch.from_numpy(a) if a is not None else None
                   for a in (q, k, v, mask, b, fids, cot)) for b in (None, bias)]
    ranks = run_world(ring_cases, n, cases)
    mesh = _jax_mesh(n)
    out = {}
    for i, use_bias in enumerate((False, True)):
        got = [torch.cat([r[i][j] for r in ranks], dim=2).numpy() for j in range(4)]
        got.append(sum(r[i][4] for r in ranks).numpy() if use_bias else None)
        fb, fi = (jnp.asarray(bias), jnp.asarray(fids)) if use_bias else (None, None)

        def ring_fn(q_, k_, v_, b_):
            return jring(q_, k_, v_, jnp.asarray(mask), b_, fi, mesh=mesh)

        def dense_fn(q_, k_, v_, b_):
            return xla_attention(q_, k_, v_, jnp.asarray(mask), b_, fi)

        refs = []
        for fn in (ring_fn, dense_fn):
            o, vjp = jax.vjp(jax.jit(fn), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), fb)
            refs.append([np.asarray(o)] + [None if g is None else np.asarray(g) for g in vjp(jnp.asarray(cot))])
        out[use_bias] = (got, refs)
    return out


@pytest.mark.parametrize("use_bias", [False, True], ids=["no_bias", "bias"])
def test_ring_matches_jax_ring_and_dense(ring, use_bias):
    got, refs = ring[use_bias]
    for ref in refs:
        np.testing.assert_allclose(got[0], ref[0], atol=2e-5)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got[1:], ref[1:]):
            if b is None:
                assert a is None and not use_bias
                continue
            np.testing.assert_allclose(a, b, atol=3e-5, err_msg=name)
    assert np.isfinite(got[0]).all()


def _sp_cfg(decomposed: bool):
    cfg = _jax_cfg(0.0)
    cfg.train.pos_weight = 1.0
    cfg.mdl.decomposed_mm = decomposed
    return cfg


@pytest.fixture(scope="module")
def sp_world():
    """Per decomposed_mm: (the (1, 2) world's first step with the ring, the
    JAX single-device loss and the port-layout gradients)."""
    from vog_tpu.model import compute_loss
    from vog_tpu.sampling import assemble_batch
    from vog_tpu.train.state import build_model, init_state

    batch = _random_batch(_jax_cfg(), GLOBAL_B, seed=11)
    out, cfgs, sds = {}, [], []
    for dec in (False, True):
        cfg = _sp_cfg(dec)
        glove = _glove(cfg, VOCAB)
        state = init_state(cfg, glove, jax.random.PRNGKey(0), GLOBAL_B)
        model = build_model(cfg, glove)
        clip = assemble_batch(jax.tree.map(jnp.asarray, batch), cfg.ds.conc_type)

        def loss_fn(params):
            loss, _ = compute_loss(model.apply({"params": params}, clip, deterministic=True), clip)
            return loss

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
        pcfg = port_cfg(cfg)
        sds.append(params_from_jax(jax.tree.map(np.asarray, state.params), pcfg))
        pcfg.mdl.sp_attention = True
        cfgs.append(pcfg)
        out[dec] = (float(loss), params_from_jax(jax.tree.map(np.asarray, grads), pcfg))
    ranks = run_world(tp_steps, 2, copy.deepcopy(cfgs), sds, [batch], VOCAB, 2)[0]
    return {dec: (r, out[dec]) for dec, r in zip((False, True), ranks)}


@pytest.mark.parametrize("decomposed", [False, True], ids=["materialised", "decomposed"])
def test_vognet_sp_matches_jax_single_device(sp_world, decomposed):
    r, (jloss, jgrads) = sp_world[decomposed]
    step = r["steps"][0]
    np.testing.assert_allclose(float(step["loss"]), jloss, rtol=1e-5)
    names = list(jgrads)
    ref = torch.cat([jgrads[k].reshape(-1) for k in _port_order(names, decomposed)])
    np.testing.assert_allclose(step["grad"].numpy(), ref.numpy(), atol=5e-5, rtol=1e-3)


def _port_order(names, decomposed):
    """The port model's parameter order (the step's flat gradient's)."""
    from vog_tpu_torch.model.grounding import get_model

    model = get_model(port_cfg(_sp_cfg(decomposed)), VOCAB, device="cpu")
    order = [k for k, _ in model.named_parameters()]
    assert sorted(order) == sorted(names)
    return order


def test_sp_predictor_follower_serves_the_single_predictor():
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.serving import batch_to_requests

    cfg = port_cfg(_sp_cfg(False))
    sd = {k: v.clone() for k, v in get_model(cfg, VOCAB, device="cpu", seed=5).state_dict().items()}
    batch = _random_batch(_jax_cfg(), 3, seed=12)
    requests = batch_to_requests(batch)
    one = Predictor(cfg, sd, VOCAB, device="cpu")
    want = one({**{k: batch[k] for k in requests[0]}, "batch_mask": np.ones(3, np.uint8)})
    cfg.mdl.sp_attention = True
    responses, followed = run_world(serve_follow, 2, cfg, sd, VOCAB, requests, 2)
    assert followed >= 2  # three requests at a max batch of 2: two flushes or more
    valid = want["scores"] > -1e29  # padded proposals score -1e30 on both sides
    scale = float(np.abs(want["scores"][valid]).max())
    for i, got in enumerate(responses):
        np.testing.assert_allclose(got["scores"], want["scores"][i], atol=2e-4 * scale, rtol=0)
