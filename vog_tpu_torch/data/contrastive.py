"""Contrastive sampling: partner lists and the group sampler (copy of
vog_tpu/data/contrastive.py, the same draws from the same generator).

``build_cs_dict`` maps each annotation to the annotations that share its
verb lemma (an argument lemma as fallback), other videos only.  Train
groups draw ncmp-1 partners and the positive's slot from the sample's
generator; valid and test groups are a fixed function of the index.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def build_cs_dict(
    annotations: Sequence[dict], max_partners: int = 0, seed: int = 0
) -> Dict[str, List[int]]:
    """ann_idx -> candidate partner ann_idxs (same verb lemma, or sharing an
    arg lemma as fallback), excluding self and same-video entries.

    Reference: ``contrastive_sampling.py §create_similar_lists`` [C-MED
    symbol].  Keys are stringified ints (json round-trip safe).

    ``max_partners`` (>0): cap each candidate list to a seeded random
    subset.  At reference cardinality (~40k queries over a small verb
    vocabulary) the uncapped lists are O(queries-per-verb) each — ~100M
    ints of JSON for the 28k-query synthetic train split (round-4 scale
    rehearsal cliff) — while the group sampler only ever draws 3
    partners; a few hundred candidates preserve sampling diversity.
    """
    by_verb: Dict[str, List[int]] = {}
    by_arg: Dict[str, List[int]] = {}
    for i, ann in enumerate(annotations):
        by_verb.setdefault(ann["verb_lemma"], []).append(i)
        for arg in ann["args"]:
            by_arg.setdefault(arg["lemma"], []).append(i)

    out: Dict[str, List[int]] = {}
    for i, ann in enumerate(annotations):
        vid = ann["vid_seg"]
        cands = [
            j
            for j in by_verb.get(ann["verb_lemma"], [])
            if j != i and annotations[j]["vid_seg"] != vid
        ]
        if not cands:
            seen = set()
            for arg in ann["args"]:
                for j in by_arg.get(arg["lemma"], []):
                    if j != i and annotations[j]["vid_seg"] != vid and j not in seen:
                        seen.add(j)
                        cands.append(j)
        if max_partners and len(cands) > max_partners:
            rng = np.random.default_rng(seed + i)
            idx = rng.choice(len(cands), size=max_partners, replace=False)
            cands = [cands[j] for j in sorted(idx.tolist())]
        out[str(i)] = cands
    return out


class ContrastiveSampler:
    """Samples the (ncmp-1) partner videos + positive position per query.

    train: random partners + random positive slot (reference shuffles where
    the positive video lands in the concatenated group so position is not a
    cue).  val/test: partners and slot are a deterministic function of the
    annotation index (reference uses frozen dicts / fixed seeds).
    """

    def __init__(
        self,
        cs_dict: Dict[str, List[int]],
        n_anns: int,
        ncmp: int,
        is_train: bool,
        shuffle_cmp: bool = True,
        seed: int = 0,
    ):
        self.cs_dict = cs_dict
        self.n_anns = n_anns
        self.ncmp = ncmp
        self.is_train = is_train
        self.shuffle_cmp = shuffle_cmp
        self.seed = seed

    def sample_group(self, idx: int, rng: np.random.Generator | None = None) -> tuple:
        """-> (partner ann idxs list of len ncmp-1, pos_slot int)."""
        if self.ncmp == 1:
            return [], 0
        if self.is_train:
            assert rng is not None
        else:
            rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        cands = self.cs_dict.get(str(idx), [])
        need = self.ncmp - 1
        if len(cands) == 0:
            # degenerate: fall back to any other annotation
            pool = [j for j in range(self.n_anns) if j != idx]
        else:
            pool = cands
        replace = len(pool) < need
        partners = list(rng.choice(pool, size=need, replace=replace))
        pos_slot = int(rng.integers(self.ncmp)) if self.shuffle_cmp else 0
        return [int(p) for p in partners], pos_slot
