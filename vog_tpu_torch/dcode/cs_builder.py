"""CLI: build contrastive-sampling dicts from annotation files (copy of
vog_tpu/dcode/cs_builder.py, on the port's ``data/contrastive.py``).

  python -m vog_tpu_torch.dcode.cs_builder <data_dir> [splits...]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from vog_tpu_torch.data.contrastive import build_cs_dict
from vog_tpu_torch.data.vocab import load_annotations


def main(data_dir: str, splits=("train", "valid", "test")) -> None:
    data_dir = Path(data_dir)
    for split in splits:
        f = data_dir / f"anns_{split}.jsonl"
        if not f.exists():
            print(f"skip {split}: {f} missing")
            continue
        anns = load_annotations(f)
        cs = build_cs_dict(anns)
        out = data_dir / f"cs_dict_{split}.json"
        with open(out, "w") as fh:
            json.dump(cs, fh)
        n_empty = sum(1 for v in cs.values() if not v)
        print(f"{split}: {len(cs)} queries, {n_empty} without partners -> {out}")


if __name__ == "__main__":
    main(sys.argv[1], tuple(sys.argv[2:]) or ("train", "valid", "test"))
