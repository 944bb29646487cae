"""Weights carried across from the JAX package.

``params_from_jax(params, cfg)`` takes the flax ``params`` tree of a
vog_tpu model (nested dicts of numpy arrays) and returns the port model's
``state_dict`` for the same configuration: all three models, both head
types, ``decomposed_mm`` on and off.

  * flax ``Dense`` kernels are (in, out): they become the transposed
    ``nn.Linear.weight``; LayerNorm ``scale`` becomes ``weight``;
    ``Embed.embedding`` becomes ``Embedding.weight``;
  * the BiLSTM's (in, 4H) / (H, 4H) weights are transposed into the
    ``weight_ih_l0`` / ``weight_hh_l0`` of its two ``nn.LSTM``s (``fwd``,
    ``bwd``); the gate order i, f, g, o is the same;
  * raw parameters (the fused head's kernels in their (in, out) layout,
    ``rpe_table``, ``score_bias``) are copied as they are;
  * ``layer{i}`` scopes become ``layers.{i}``.

On the mesh's model axis, ``train/dist.py §shard_state_dict(sd, mesh,
cfg)`` then gives each rank its part of the returned state dict, so a
tensor-parallel world starts from the params that the JAX package's
``(d, m)`` step takes.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _module_path(parts) -> str:
    out = []
    for p in parts:
        m = re.fullmatch(r"layer(\d+)", p)
        out += ["layers", m.group(1)] if m else [p]
    return ".".join(out)


_LSTM = {"w_ih": ("weight_ih", True), "w_hh": ("weight_hh", True),
         "b_ih": ("bias_ih", False), "b_hh": ("bias_hh", False)}


def _convert(key: Tuple[str, ...], v: np.ndarray) -> Tuple[str, np.ndarray]:
    leaf = key[-1]
    if key[:2] == ("lang", "embed"):
        return "lang.embed.weight", v
    if key[:2] == ("lang", "bilstm"):
        kind, direction = leaf.rsplit("_", 1)
        name, transpose = _LSTM[kind]
        module = "fwd" if direction == "f" else "bwd"
        return f"lang.bilstm.{module}.{name}_l0", v.T if transpose else v
    path = _module_path(key[:-1])
    if leaf == "kernel":
        return f"{path}.weight", v.T
    if leaf in ("bias", "scale", "embedding"):
        return f"{path}.{'bias' if leaf == 'bias' else 'weight'}", v
    return _module_path(key), v  # raw parameters keep their layout


def params_from_jax(params: Dict, cfg) -> Dict[str, torch.Tensor]:
    """flax params tree (of a model, or of one of its modules) -> the
    port's state_dict for the same model or module."""
    flat = _flatten(params)
    fused = ("head", "fuse_vis_kernel") in flat
    if "head" in params and fused != (cfg.mdl.head_type != "dot"):
        raise ValueError(f"param tree does not hold the {cfg.mdl.head_type} head of the config")
    sd = {}
    for key, v in flat.items():
        name, val = _convert(key, v)
        sd[name] = torch.from_numpy(np.array(val, dtype=np.float32, order="C"))
    return sd
