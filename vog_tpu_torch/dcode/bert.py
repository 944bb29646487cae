"""The BERT encoder of the SRL tagger, with ``transformers``' parameter
names, and a reader and writer of the ``safetensors`` file format.

``BertModel(cfg)(input_ids, attention_mask, token_type_ids)`` returns the
last hidden state (B, T, hidden) of ``transformers.BertModel`` for the
same weights: word + position + token-type embeddings, LayerNorm
(``layer_norm_eps``), then post-LN layers (self-attention, dense,
residual, LayerNorm; an exact-erf GELU FFN, residual, LayerNorm).  The
padding mask is the attention's key mask.

Self-attention goes through ``kernels/attention.py §flash_attention``
(q, k, v as (B, H, T, dh), the padding as ``key_mask``, no frame bias):
on the card the hand-written ``flash_fwd`` / ``flash_bwd`` of
``csrc/attention.cu``, on the CPU its plain version.  The kernel has no
dropout on the probabilities, so in one case the layer runs BERT's own
product, softmax, dropout and product instead: in training
(``self.training``) with ``attention_probs_dropout_prob > 0``.  That
follows from the config and the mode alone; inference, and training at
attention dropout 0, always take the kernel.

Dropout draws from the ``generator`` passed to ``forward`` (None: the
global generator), so the bits differ from ``transformers``', which
draws from the global generator in its own order.

``pooler.dense`` is carried so that a checkpoint loads and saves whole;
the tagger reads only the last hidden state.
"""

from __future__ import annotations

import json
import math
import sys
from dataclasses import asdict, dataclass, field, fields
from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn

from vog_tpu_torch.kernels import attention

# config.json values the encoder implements, by key
SUPPORTED = {"hidden_act": "gelu", "position_embedding_type": "absolute"}
# buffers of some transformers versions' checkpoints, not parameters
BUFFERS = ("embeddings.position_ids", "embeddings.token_type_ids")


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    position_embedding_type: str = "absolute"
    extra: Dict = field(default_factory=dict)  # the other keys of config.json, written back as read

    @classmethod
    def from_dict(cls, d: Dict) -> "BertConfig":
        """A ``config.json`` dict; refuses, naming the key, what the
        encoder does not implement."""
        for key, want in SUPPORTED.items():
            if d.get(key, want) != want:
                raise ValueError(f"config.json {key}={d[key]!r}: the port's BERT implements {key}={want!r}")
        names = {f.name for f in fields(cls)} - {"extra"}
        cfg = cls(**{k: v for k, v in d.items() if k in names},
                  extra={k: v for k, v in d.items() if k not in names})
        if cfg.hidden_size % cfg.num_attention_heads:
            raise ValueError(f"config.json hidden_size={cfg.hidden_size} is not a multiple of "
                             f"num_attention_heads={cfg.num_attention_heads}")
        return cfg

    def to_dict(self) -> Dict:
        """The ``config.json`` that ``transformers.AutoModel`` reads."""
        d = {k: v for k, v in asdict(self).items() if k != "extra"}
        return {"architectures": ["BertModel"], "model_type": "bert", **self.extra, **d}


def _dropout(x: torch.Tensor, p: float, training: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    if not training or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, padding_idx=cfg.pad_token_id)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.p = cfg.hidden_dropout_prob

    def forward(self, input_ids, token_type_ids, generator=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.token_type_embeddings(token_type_ids)
        x = x + self.position_embeddings(pos)[None]
        return _dropout(self.LayerNorm(x), self.p, self.training, generator)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.p = cfg.attention_probs_dropout_prob

    def forward(self, x, key_mask, generator=None):
        B, T, D = x.shape
        dh = D // self.heads
        q, k, v = (lin(x).view(B, T, self.heads, dh).transpose(1, 2).contiguous()
                   for lin in (self.query, self.key, self.value))
        if self.training and self.p > 0:  # BERT's own product: the kernel has no dropout
            s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
            s = s.masked_fill(key_mask[:, None, None, :] == 0, torch.finfo(s.dtype).min)
            o = torch.matmul(_dropout(torch.softmax(s, -1), self.p, True, generator), v)
        else:
            o = attention.flash_attention(q, k, v, key_mask)
        return o.transpose(1, 2).reshape(B, T, D)


class BertOutput(nn.Module):
    """dense, dropout, the residual, LayerNorm: after the attention
    (``attention.output``) and after the FFN (``output``)."""

    def __init__(self, cfg: BertConfig, d_in: int):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.p = cfg.hidden_dropout_prob

    def forward(self, h, residual, generator=None):
        return self.LayerNorm(_dropout(self.dense(h), self.p, self.training, generator) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertOutput(cfg, cfg.hidden_size)

    def forward(self, x, key_mask, generator=None):
        return self.output(self.self(x, key_mask, generator), x, generator)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return nn.functional.gelu(self.dense(x))  # exact (erf), BERT's "gelu"


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg, cfg.intermediate_size)

    def forward(self, x, key_mask, generator=None):
        a = self.attention(x, key_mask, generator)
        return self.output(self.intermediate(a), a, generator)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg)

    def init_weights(self, generator: torch.Generator) -> "BertModel":
        """BERT's initialisation from ``generator``: normal(0,
        ``initializer_range``) weights (the padding row zero), zero biases,
        LayerNorms at one and zero."""
        std = self.config.initializer_range
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, std, generator=generator)
                if isinstance(m, nn.Linear):
                    m.bias.zero_()
                elif isinstance(m, nn.Embedding) and m.padding_idx is not None:
                    m.weight[m.padding_idx].zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
        return self

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """input_ids, attention_mask (1 real, 0 padding), token_type_ids:
        (B, T) -> the last hidden state (B, T, hidden)."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        key_mask = attention_mask.to(torch.float32).contiguous()
        x = self.embeddings(input_ids, token_type_ids, generator)
        for layer in self.encoder.layer:
            x = layer(x, key_mask, generator)
        return x


# -- safetensors ----------------------------------------------------------
# An 8-byte little-endian header length, a JSON header {name: {"dtype",
# "shape", "data_offsets": [begin, end]}, "__metadata__": {...}} padded
# with spaces to 8 bytes, then the tensors' little-endian bytes back to
# back (offsets from the end of the header).

ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}


def _little_endian() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("safetensors: this reader and writer run on little-endian hosts only")


def load_safetensors(path: str | Path) -> Dict[str, torch.Tensor]:
    """-> {name: CPU tensor} of a ``.safetensors`` file."""
    _little_endian()
    data = Path(path).read_bytes()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, not one of {sorted(ST_DTYPES)}")
        b, e = meta["data_offsets"]
        dt = ST_DTYPES[meta["dtype"]]
        flat = torch.frombuffer(bytearray(data[base + b:base + e]), dtype=dt) if e > b else torch.empty(0, dtype=dt)
        out[name] = flat.reshape(meta["shape"])
    return out


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str | Path) -> None:
    """Write ``tensors`` (any device; F32, F16, BF16 or I64) as a
    ``.safetensors`` file with the metadata ``{"format": "pt"}`` that
    ``transformers`` checks."""
    _little_endian()
    names = {v: k for k, v in ST_DTYPES.items()}
    header: Dict[str, Dict] = {}
    blobs, off = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in names:
            raise ValueError(f"safetensors: {name} has dtype {t.dtype}, not one of {sorted(ST_DTYPES.values(), key=str)}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    header["__metadata__"] = {"format": "pt"}
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little"))
        f.write(h)
        for raw in blobs:
            f.write(raw)
