"""Weights carried across from the JAX package's BERT-SRL tagger
(``vog_tpu/dcode/srl_tagger.py §BertSrlTagger``: a ``transformers``
BERT and a linear tag head).

``bert_srl_from_reference(bert_state, head_state, config)`` takes that
tagger's parameters as numpy arrays (``state_dict()`` of its ``bert`` and
``head``) and its ``config.json`` dict, and returns the state dict of
the port's ``dcode/srl_tagger.py §SrlNet`` (``bert.<transformers name>``,
``head.weight``, ``head.bias``), checking every key and shape.  The
port's BERT keeps ``transformers``' parameter names, so each array is
carried as it is.  ``config_from_json`` reads a ``config.json``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from vog_tpu_torch.dcode.bert import BUFFERS, BertConfig, BertModel


def config_from_json(path: str | Path) -> BertConfig:
    with open(path) as f:
        return BertConfig.from_dict(json.load(f))


def bert_srl_from_reference(bert_state: Dict[str, np.ndarray], head_state: Optional[Dict[str, np.ndarray]],
                            config: Dict) -> Dict[str, torch.Tensor]:
    """-> the port's tagger state dict; ``head_state`` None leaves the
    head out (the tagger keeps its own)."""
    cfg = BertConfig.from_dict(config)
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in BertModel(cfg).state_dict().items()}
    got = {k: v for k, v in bert_state.items() if k not in BUFFERS}
    missing, unexpected = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or unexpected:
        raise KeyError(f"BERT state: missing {missing}, unexpected {unexpected}")
    out = {}
    for k, shape in want.items():
        a = np.asarray(got[k])
        if a.shape != shape:
            raise ValueError(f"BERT state {k}: shape {a.shape} != {shape}")
        out["bert." + k] = torch.from_numpy(np.array(a, np.float32))
    if head_state is not None:
        n_tags = np.asarray(head_state["weight"]).shape[0] if "weight" in head_state else None
        shapes = {"weight": (n_tags, cfg.hidden_size), "bias": (n_tags,)}
        if set(head_state) != set(shapes):
            raise KeyError(f"head state: keys {sorted(head_state)} != {sorted(shapes)}")
        for k, shape in shapes.items():
            a = np.asarray(head_state[k])
            if a.shape != shape:
                raise ValueError(f"head state {k}: shape {a.shape} != {shape}")
            out["head." + k] = torch.from_numpy(np.array(a, np.float32))
    return out
