"""One-command offline ASRL construction: the dcode stages chained
(counterpart of vog_tpu/dcode/pipeline.py, writing the same files).

SRL-tag the ActivityNet-Captions sentences -> align arg phrases with
ActivityNet-Entities boxes -> write per-split annotation files -> build
the contrastive-sampling dicts (-> optionally build the GT5 store from
the P100 detections):

  python -m vog_tpu_torch.dcode.pipeline <raw_dir> <out_dir> \\
      [--tagger=rule|bert:<model_dir>] [--gt5-from=<p100_dir>] [--gt5-k=5] \\
      [--misc.platform=cpu]

Raw inputs (in <raw_dir>):
  captions.jsonl   one per line: {"vid_seg": str, "sentence": str,
                   "split": "train"|"valid"|"test"}   (split optional ->
                   "train"; the reference derives splits from the AE
                   val split; pass them explicitly here)
  ae_annots.json   {vid_seg: [{"tokens": [...], "frame": int,
                   "box": [x1, y1, x2, y2]}, ...]}

Outputs (in <out_dir>): anns_{split}.jsonl + cs_dict_{split}.json for
every split present, and (with --gt5-from) the GT5 store as a pack
(``dcode/gt5_builder.py``).  Feature files (the store, glove.txt,
vid_dims.json) come from the detector / TSN / GloVe download, not from
this pipeline.

The ``bert:`` tagger is built once and runs on the card
(``--misc.platform=cpu``: on the CPU, as the port's other CLIs take it),
tagging all captions' frames in padded batches; the other stages are
host work.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from vog_tpu_torch.dcode.align_args import build_asrl
from vog_tpu_torch.dcode.cs_builder import main as build_cs
from vog_tpu_torch.dcode.srl_tagger import tag_sentence_rule_based
from vog_tpu_torch.device import DeviceLike

SPLITS = ("train", "valid", "test")


def _make_tagger(spec: str, device: DeviceLike = None) -> Callable[[Sequence[str]], List[Optional[Dict]]]:
    """-> callable(sentences) -> [Optional[schema dict]] per sentence."""
    if spec == "rule":
        return lambda sentences: [tag_sentence_rule_based(s.split()) for s in sentences]
    if spec.startswith("bert:"):
        from vog_tpu_torch.dcode.srl_tagger import BertSrlTagger

        tagger = BertSrlTagger.from_pretrained(spec[len("bert:"):], device)
        return tagger.tag_sentences
    raise ValueError(f"unknown --tagger={spec!r} (rule | bert:<model_dir>)")


def run_pipeline(
    raw_dir: str | Path,
    out_dir: str | Path,
    tagger: str = "rule",
    gt5_from: Optional[str] = None,
    gt5_k: int = 5,
    device: DeviceLike = None,
) -> Dict[str, int]:
    """Returns {split: n_queries_written}.  ``device`` is the BERT
    tagger's (None: the card)."""
    raw_dir, out_dir = Path(raw_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = _make_tagger(tagger, device)

    with open(raw_dir / "ae_annots.json") as f:
        ae: Dict[str, List[Dict]] = json.load(f)

    caps: List[Dict] = []
    with open(raw_dir / "captions.jsonl") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cap = json.loads(line)
            if cap.get("split", "train") not in SPLITS:
                raise ValueError(f"bad split {cap['split']!r} for {cap['vid_seg']}")
            caps.append(cap)

    by_split: Dict[str, List[Dict]] = {}
    n_untagged = 0
    for cap, srl in zip(caps, tag([cap["sentence"] for cap in caps])):
        if srl is None:  # no predicate frame -> query dropped
            n_untagged += 1
            continue
        srl["vid_seg"] = cap["vid_seg"]
        by_split.setdefault(cap.get("split", "train"), []).append(srl)

    counts: Dict[str, int] = {}
    for split, queries in sorted(by_split.items()):
        asrl = build_asrl(queries, ae)  # align + role filter + ann_idx
        out = out_dir / f"anns_{split}.jsonl"
        with open(out, "w") as f:
            for q in asrl:
                f.write(json.dumps(q) + "\n")
        counts[split] = len(asrl)
        print(
            f"{split}: {len(queries)} tagged -> {len(asrl)} grounded "
            f"queries -> {out}"
        )
    if n_untagged:
        print(f"dropped {n_untagged} captions with no SRL frame")

    build_cs(str(out_dir), tuple(sorted(by_split)))
    if gt5_from:
        from vog_tpu_torch.dcode.gt5_builder import build_gt5

        build_gt5(gt5_from, out_dir, k=gt5_k)
    return counts


def main(argv: Optional[List[str]] = None) -> None:
    from vog_tpu_torch.cli.train import PLATFORMS  # misc.platform, as the port's other CLIs read it

    argv = list(sys.argv[1:] if argv is None else argv)
    kw: Dict = {}
    pos: List[str] = []
    for a in argv:
        if a.startswith("--tagger="):
            kw["tagger"] = a.split("=", 1)[1]
        elif a.startswith("--gt5-from="):
            kw["gt5_from"] = a.split("=", 1)[1]
        elif a.startswith("--gt5-k="):
            kw["gt5_k"] = int(a.split("=", 1)[1])
        elif a.startswith("--misc.platform="):
            p = a.split("=", 1)[1]
            if p not in PLATFORMS:
                raise SystemExit(f"--misc.platform={p!r}: one of {', '.join(repr(k) for k in PLATFORMS)}")
            kw["device"] = PLATFORMS[p]
        else:
            pos.append(a)
    if len(pos) != 2:
        raise SystemExit(__doc__)
    run_pipeline(pos[0], pos[1], **kw)


if __name__ == "__main__":
    main()
