"""Align SRL argument phrases with ActivityNet-Entities noun-phrase boxes
(copy of vog_tpu/dcode/align_args.py).

Dcode stage 2: given SRL-tagged sentences
and AE-style grounded noun-phrase annotations (phrase -> box in an
annotated frame), attach GT boxes to each SRL arg whose span overlaps an
annotated phrase (lemma match on the head noun), then filter to the kept
role set and drop argument-less queries.

AE-style input per sentence:
  {"vid_seg": str, "phrases": [{"tokens": ["a","man"], "frame": 3,
                                 "box": [x1,y1,x2,y2]}, ...]}
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

KEEP_ROLES = {
    "ARG0", "ARG1", "ARG2", "ARG3", "ARG4",
    "ARGM-LOC", "ARGM-TMP", "ARGM-MNR", "ARGM-DIR", "ARGM-GOL",
}


def _lemma(word: str) -> str:
    w = word.lower()
    return w[:-1] if w.endswith("s") and len(w) > 3 else w


def align_query(srl: Dict, ae_phrases: Sequence[Dict]) -> Optional[Dict]:
    """Attach boxes to SRL args; None if no arg ends up grounded."""
    args_out: List[Dict] = []
    for arg in srl["args"]:
        if arg["role"] not in KEEP_ROLES:
            continue
        s, e = arg["span"]
        span_lemmas = {_lemma(t) for t in srl["tokens"][s : e + 1]}
        boxes = [
            {"frame": int(ph["frame"]), "box": list(map(float, ph["box"]))}
            for ph in ae_phrases
            if _lemma(ph["tokens"][-1]) in span_lemmas
        ]
        if boxes:
            args_out.append({**arg, "boxes": boxes})
    if not args_out:
        return None
    return {**srl, "args": args_out}


def build_asrl(
    srl_queries: Sequence[Dict],  # each with vid_seg + SRL schema
    ae_annots: Dict[str, List[Dict]],  # vid_seg -> phrase dicts
) -> List[Dict]:
    out = []
    for q in srl_queries:
        aligned = align_query(q, ae_annots.get(q["vid_seg"], []))
        if aligned is not None:
            aligned["ann_idx"] = len(out)
            out.append(aligned)
    return out
