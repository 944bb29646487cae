"""Word and SRL-role vocabularies (copy of vog_tpu/data/vocab.py).

GloVe vectors are read from the ``glove.*.txt`` text format (ids 0 =
<pad>, 1 = <unk>, both zero vectors, then the file's words in order); SRL
role labels map into a small fixed vocabulary; annotations are json-lines,
one query a line (schema in ``data/fixtures.py``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

PAD, UNK = "<pad>", "<unk>"

# SRL role label set kept by the reference pipeline (V + numbered args +
# common modifiers) — reference dcode filtering keeps ARG0/1/2/LOC etc.
ROLE_LIST: List[str] = [
    "<pad>",
    "V",
    "ARG0",
    "ARG1",
    "ARG2",
    "ARG3",
    "ARG4",
    "ARGM-LOC",
    "ARGM-TMP",
    "ARGM-MNR",
    "ARGM-DIR",
    "ARGM-ADV",
    "ARGM-PRP",
    "ARGM-PRD",
    "ARGM-COM",
    "ARGM-GOL",
    "ARGM-EXT",
    "ARGM-CAU",
    "ARGM-NEG",
    "ARGM-MOD",
    "ARGM-DIS",
    "ARGM-REC",
    "ARGM-PNC",
    "<other>",
]
ROLE2ID: Dict[str, int] = {r: i for i, r in enumerate(ROLE_LIST)}


def role_to_id(role: str) -> int:
    return ROLE2ID.get(role, ROLE2ID["<other>"])


class Vocab:
    """GloVe word vocabulary: token -> id, plus the embedding matrix.

    ids: 0 = <pad> (zero vector), 1 = <unk> (zero vector), 2.. = words in
    file order.
    """

    def __init__(self, words: Sequence[str], vectors: np.ndarray):
        assert vectors.ndim == 2
        dim = vectors.shape[1]
        self.itos: List[str] = [PAD, UNK] + list(words)
        self.stoi: Dict[str, int] = {w: i for i, w in enumerate(self.itos)}
        self.vectors = np.concatenate(
            [np.zeros((2, dim), np.float32), vectors.astype(np.float32)], axis=0
        )

    def __len__(self) -> int:
        return len(self.itos)

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    def encode(self, tokens: Sequence[str]) -> List[int]:
        unk = self.stoi[UNK]
        return [self.stoi.get(t.lower(), unk) for t in tokens]

    @classmethod
    def from_glove_txt(cls, path: str | Path) -> "Vocab":
        words, vecs = [], []
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                vecs.append(np.asarray(parts[1:], dtype=np.float32))
        return cls(words, np.stack(vecs))

    def save_npz(self, path: str | Path) -> None:
        np.savez(
            path,
            words=np.asarray(self.itos[2:], dtype=object),
            vectors=self.vectors[2:],
        )

    @classmethod
    def from_npz(cls, path: str | Path) -> "Vocab":
        d = np.load(path, allow_pickle=True)
        return cls(list(d["words"]), d["vectors"])


def load_annotations(path: str | Path) -> List[dict]:
    """Load SRL annotation file (json-lines; one query per line).

    Reference parity: the reference stores per-split SRL annotation
    csv/json produced by dcode (``code/dat_loader_simple.py`` reads them
    with pandas).  Our canonical on-disk schema (documented in
    ``vog_tpu_torch/data/fixtures.py``) is json-lines with the same content: video
    segment id, tokens, verb index/lemma, SRL args with role, token span,
    lemma, and GT boxes per annotated frame.
    """
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def build_word_list(annotations: List[dict]) -> List[str]:
    seen, out = set(), []
    for ann in annotations:
        for t in ann["tokens"]:
            tl = t.lower()
            if tl not in seen:
                seen.add(tl)
                out.append(tl)
    return out
