"""Synthetic mini-ASRL fixture writer (counterpart of
vog_tpu/data/fixtures.py, with no h5 step).

The real ActivityNet-SRL data is not in the repo, so tests and smoke runs
train on a synthetic, real-shaped and learnable dataset in the on-disk
form the readers consume::

  out_dir/
    anns_train.jsonl / anns_valid.jsonl / anns_test.jsonl
    featpack.bin, featpack.json   # per vid_seg: feats (F,P,prop_dim),
                                  #   boxes (F,P,4 abs xyxy), scores (F,P),
                                  #   seg (F,seg_dim); data/featpack.py
    vid_dims.json                 # {vid_seg: [W, H]}
    glove.txt                     # GloVe-format word vectors
    cs_dict_train.json / cs_dict_valid.json / cs_dict_test.json

Both generators draw from ``np.random.default_rng(seed)`` in the JAX
package's order, so every file equals the JAX fixture's, and the pack
equals the JAX fixture's h5 after ``build_featpack``, byte for byte
(``generate_scaled``'s fp16 tables are rounded through fp16 and stored as
float32, as the JAX reader upcasts them).  The pack is written a video at
a time (``PackWriter``), so a fixture of any size streams to disk.

Annotation json-lines schema (one query a line)::

  {"ann_idx": 0, "vid_seg": "v000_s00", "tokens": [...], "verb_idx": 2,
   "verb_lemma": "throw",
   "args": [{"role": "ARG0", "span": [0, 1], "lemma": "man",
             "boxes": [{"frame": 3, "box": [x1, y1, x2, y2]}]}, ...]}

Learnability: each object word has a latent prop_dim direction; proposals
covering that object carry it (plus noise) as their RoI feature, and each
verb a direction in the segment feature.  GloVe vectors are random unit
vectors.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from vog_tpu_torch.data.boxes import iou_matrix
from vog_tpu_torch.data.contrastive import build_cs_dict
from vog_tpu_torch.data.featpack import PackWriter

OBJECTS = [
    "man", "woman", "dog", "cat", "ball", "car", "bike", "guitar",
    "table", "chair", "cup", "phone", "book", "hat", "horse", "boat",
]
VERBS = ["throw", "catch", "ride", "play", "hold", "push", "pull", "watch"]
FILLER = ["the", "a", "near", "with", "on"]

TEMPLATE_ROLES = ["ARG0", "ARG1", "ARGM-LOC"]


def _rand_box(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    x1 = rng.uniform(0, w * 0.6)
    y1 = rng.uniform(0, h * 0.6)
    bw = rng.uniform(w * 0.15, w * 0.4)
    bh = rng.uniform(h * 0.15, h * 0.4)
    return np.array([x1, y1, min(x1 + bw, w - 1), min(y1 + bh, h - 1)], np.float32)


def _jitter_box(rng: np.random.Generator, box: np.ndarray, w: int, h: int, frac: float) -> np.ndarray:
    bw, bh = box[2] - box[0], box[3] - box[1]
    d = rng.uniform(-frac, frac, size=4) * np.array([bw, bh, bw, bh])
    out = box + d
    out[0] = np.clip(out[0], 0, w - 2)
    out[1] = np.clip(out[1], 0, h - 2)
    out[2] = np.clip(out[2], out[0] + 1, w - 1)
    out[3] = np.clip(out[3], out[1] + 1, h - 1)
    return out.astype(np.float32)


def _pack_writer(out_dir: Path, names: Dict[str, List[str]], num_frms: int, num_props: int,
                 prop_dim: int, seg_dim: int) -> PackWriter:
    shape = {"feats": (num_frms, num_props, prop_dim), "boxes": (num_frms, num_props, 4),
             "scores": (num_frms, num_props), "seg": (num_frms, seg_dim)}
    return PackWriter(out_dir, {v: shape for vs in names.values() for v in vs})


def generate_fixture(
    out_dir: str | Path,
    n_train: int = 80,
    n_valid: int = 24,
    n_test: int = 24,
    num_frms: int = 10,
    num_props: int = 5,
    prop_dim: int = 2048,
    seg_dim: int = 3072,
    glove_dim: int = 300,
    seed: int = 0,
) -> Path:
    """Write a full mini-ASRL dataset; returns out_dir."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    words = sorted(set(OBJECTS + VERBS + FILLER))
    glove = {w: rng.normal(size=glove_dim).astype(np.float32) for w in words}
    for w in glove:
        glove[w] /= np.linalg.norm(glove[w])
    with open(out_dir / "glove.txt", "w") as f:
        for w, v in glove.items():
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")

    obj_dirs = {o: rng.normal(size=prop_dim).astype(np.float32) for o in OBJECTS}
    for o in obj_dirs:
        obj_dirs[o] /= np.linalg.norm(obj_dirs[o])
    verb_dirs = {v: rng.normal(size=seg_dim).astype(np.float32) for v in VERBS}

    splits = {"train": n_train, "valid": n_valid, "test": n_test}
    vid_dims: Dict[str, List[int]] = {}
    pack = _pack_writer(out_dir, {s: [f"{s[:2]}{i:04d}_s00" for i in range(n)] for s, n in splits.items()},
                        num_frms, num_props, prop_dim, seg_dim)
    ann_idx_global = 0
    split_anns: Dict[str, List[dict]] = {}

    for split, n in splits.items():
        anns: List[dict] = []
        for i in range(n):
            vid_seg = f"{split[:2]}{i:04d}_s00"
            w, h = int(rng.integers(400, 800)), int(rng.integers(300, 600))
            vid_dims[vid_seg] = [w, h]
            verb = VERBS[int(rng.integers(len(VERBS)))]
            n_args = int(rng.integers(1, len(TEMPLATE_ROLES) + 1))
            objs = list(rng.choice(OBJECTS, size=n_args, replace=False))

            # sentence: "the <o0> <verb> [the <o1>] [near the <o2>]"
            tokens = ["the", objs[0], verb]
            spans = [[1, 1]]
            if n_args >= 2:
                tokens += ["the", objs[1]]
                spans.append([4, 4])
            if n_args >= 3:
                tokens += ["near", "the", objs[2]]
                spans.append([len(tokens) - 1, len(tokens) - 1])
            verb_idx = 2

            # per-object persistent box track + per-arg annotated frames
            obj_boxes = {o: _rand_box(rng, w, h) for o in objs}
            args = []
            ann_frames: Dict[int, List[Tuple[str, np.ndarray]]] = {
                f: [] for f in range(num_frms)
            }
            for a, (o, role) in enumerate(zip(objs, TEMPLATE_ROLES[:n_args])):
                n_f = int(rng.integers(1, 3))
                frames = sorted(rng.choice(num_frms, size=n_f, replace=False).tolist())
                boxes = []
                for fr in frames:
                    gt = _jitter_box(rng, obj_boxes[o], w, h, 0.05)
                    boxes.append({"frame": int(fr), "box": gt.tolist()})
                    ann_frames[fr].append((o, gt))
                args.append(
                    {"role": role, "span": spans[a], "lemma": o, "boxes": boxes}
                )

            # proposals: every frame has num_props boxes; in annotated
            # frames the first slots overlap the GT (GT5 regime semantics:
            # GT-overlapping proposal included — the dcode GT5
            # builder); features encode the covered object's direction.
            feats = rng.normal(scale=0.3, size=(num_frms, num_props, prop_dim)).astype(
                np.float32
            )
            boxes_arr = np.zeros((num_frms, num_props, 4), np.float32)
            scores = rng.uniform(0.1, 1.0, size=(num_frms, num_props)).astype(
                np.float32
            )
            for fr in range(num_frms):
                gts = ann_frames[fr]
                for p in range(num_props):
                    if p < len(gts):
                        o, gt = gts[p]
                        boxes_arr[fr, p] = _jitter_box(rng, gt, w, h, 0.08)
                        feats[fr, p] += 2.0 * obj_dirs[o]
                    else:
                        # distractor: random other object or background
                        if rng.uniform() < 0.5:
                            o2 = OBJECTS[int(rng.integers(len(OBJECTS)))]
                            boxes_arr[fr, p] = _rand_box(rng, w, h)
                            feats[fr, p] += 2.0 * obj_dirs[o2]
                        else:
                            boxes_arr[fr, p] = _rand_box(rng, w, h)
                # guarantee distractors don't accidentally overlap GT
                for p in range(len(gts), num_props):
                    for o, gt in gts:
                        if iou_matrix(boxes_arr[fr, p][None], gt[None])[0, 0] >= 0.5:
                            boxes_arr[fr, p] = np.array(
                                [0, 0, w * 0.05, h * 0.05], np.float32
                            )

            seg = rng.normal(scale=0.3, size=(num_frms, seg_dim)).astype(np.float32)
            seg += verb_dirs[verb][None, :]
            pack.put(vid_seg, feats=feats, boxes=boxes_arr, scores=scores, seg=seg)

            anns.append(
                {
                    "ann_idx": ann_idx_global,
                    "vid_seg": vid_seg,
                    "tokens": tokens,
                    "verb_idx": verb_idx,
                    "verb_lemma": verb,
                    "args": args,
                }
            )
            ann_idx_global += 1
        split_anns[split] = anns
        with open(out_dir / f"anns_{split}.jsonl", "w") as f:
            for a in anns:
                f.write(json.dumps(a) + "\n")

    pack.close()
    with open(out_dir / "vid_dims.json", "w") as f:
        json.dump(vid_dims, f)

    for split, anns in split_anns.items():
        cs = build_cs_dict(anns)
        with open(out_dir / f"cs_dict_{split}.json", "w") as f:
            json.dump(cs, f)
    return out_dir


def generate_scaled(
    out_dir: str | Path,
    n_train_segs: int = 10500,
    n_valid_segs: int = 3750,
    n_test_segs: int = 750,
    queries_per_seg: float = 2.7,
    num_frms: int = 10,
    num_props: int = 5,
    prop_dim: int = 2048,
    seg_dim: int = 3072,
    glove_dim: int = 300,
    feat_dtype: str = "float16",
    max_partners: int = 200,
    seed: int = 0,
    verbose: bool = True,
) -> Path:
    """Reference-cardinality synthetic ASRL: ~15k segments / ~40k queries
    at the defaults, with several queries a segment (which
    ``generate_fixture`` lacks) and a vectorised per-video loop.  Same
    learnability recipe as ``generate_fixture``.
    ``feat_dtype='float16'`` rounds the RoI and segment features through
    fp16 before they are stored as float32, as the JAX package's h5 holds
    them in fp16 and its readers upcast them.  ``max_partners`` caps the
    cs_dict candidate lists (see ``build_cs_dict``).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    h5dt = np.dtype(feat_dtype)

    words = sorted(set(OBJECTS + VERBS + FILLER))
    glove = {w: rng.normal(size=glove_dim).astype(np.float32) for w in words}
    for w in glove:
        glove[w] /= np.linalg.norm(glove[w])
    with open(out_dir / "glove.txt", "w") as f:
        for w, v in glove.items():
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")

    obj_mat = rng.normal(size=(len(OBJECTS), prop_dim)).astype(np.float32)
    obj_mat /= np.linalg.norm(obj_mat, axis=1, keepdims=True)
    verb_mat = rng.normal(size=(len(VERBS), seg_dim)).astype(np.float32)
    oid = {o: i for i, o in enumerate(OBJECTS)}

    splits = {"train": n_train_segs, "valid": n_valid_segs, "test": n_test_segs}
    vid_dims: Dict[str, List[int]] = {}
    pack = _pack_writer(out_dir, {s: [f"{s[:2]}{i:05d}_s00" for i in range(n)] for s, n in splits.items()},
                        num_frms, num_props, prop_dim, seg_dim)
    ann_idx_global = 0
    F, P = num_frms, num_props

    for split, n in splits.items():
        anns: List[dict] = []
        for i in range(n):
            vid_seg = f"{split[:2]}{i:05d}_s00"
            w, h = int(rng.integers(400, 800)), int(rng.integers(300, 600))
            vid_dims[vid_seg] = [w, h]
            verb_i = int(rng.integers(len(VERBS)))
            verb = VERBS[verb_i]

            # poisson-ish query count around queries_per_seg, >= 1
            nq = max(1, int(rng.poisson(queries_per_seg)))
            # collect every query's (object, frame) GT demands, then
            # assign proposal slots per frame round-robin (capped at P)
            slot_used = np.zeros(F, np.int64)
            gt_entries: List[Tuple[int, int, int]] = []  # (frame, slot, obj)
            queries = []
            for _ in range(nq):
                n_args = int(rng.integers(1, len(TEMPLATE_ROLES) + 1))
                objs = list(rng.choice(OBJECTS, size=n_args, replace=False))
                tokens = ["the", objs[0], verb]
                spans = [[1, 1]]
                if n_args >= 2:
                    tokens += ["the", objs[1]]
                    spans.append([4, 4])
                if n_args >= 3:
                    tokens += ["near", "the", objs[2]]
                    spans.append([len(tokens) - 1, len(tokens) - 1])
                args_meta = []
                for a, (o, role) in enumerate(zip(objs, TEMPLATE_ROLES[:n_args])):
                    n_f = int(rng.integers(1, 3))
                    frames = sorted(
                        rng.choice(F, size=n_f, replace=False).tolist()
                    )
                    placed = []
                    for fr in frames:
                        if slot_used[fr] < P:
                            placed.append((fr, int(slot_used[fr])))
                            gt_entries.append((fr, int(slot_used[fr]), oid[o]))
                            slot_used[fr] += 1
                        else:  # frame's GT slots exhausted (real data has
                            placed.append((fr, -1))  # unmatched GT too)
                    args_meta.append((o, role, spans[a], placed))
                queries.append((tokens, args_meta))

            # ---- vectorized video tensors -------------------------------
            feats = rng.standard_normal((F, P, prop_dim), np.float32) * 0.3
            # distractor object directions on ~50% of slots (vectorized)
            dmask = rng.uniform(size=(F, P)) < 0.5
            dobj = rng.integers(0, len(OBJECTS), size=(F, P))
            feats += 2.0 * dmask[..., None] * obj_mat[dobj]
            # random boxes for every slot (vectorized _rand_box)
            x1 = rng.uniform(0, w * 0.6, (F, P)).astype(np.float32)
            y1 = rng.uniform(0, h * 0.6, (F, P)).astype(np.float32)
            bw = rng.uniform(w * 0.15, w * 0.4, (F, P)).astype(np.float32)
            bh = rng.uniform(h * 0.15, h * 0.4, (F, P)).astype(np.float32)
            boxes_arr = np.stack(
                [x1, y1, np.minimum(x1 + bw, w - 1), np.minimum(y1 + bh, h - 1)],
                axis=-1,
            )
            scores = rng.uniform(0.1, 1.0, size=(F, P)).astype(np.float32)

            # GT-covering slots: persistent per-object track + jitter; the
            # slot's feature carries the object direction (learnable), its
            # box overlaps the GT, and distractor contamination is removed
            obj_track = {
                obj: _rand_box(rng, w, h)
                for obj in {o for _, _, o in gt_entries}
            }
            gt_boxes_for_ann: Dict[Tuple[int, int], np.ndarray] = {}
            for fr, sl, o in gt_entries:
                gt = _jitter_box(rng, obj_track[o], w, h, 0.05)
                gt_boxes_for_ann[(fr, sl)] = gt
                boxes_arr[fr, sl] = _jitter_box(rng, gt, w, h, 0.08)
                feats[fr, sl] = (
                    rng.standard_normal(prop_dim).astype(np.float32) * 0.3
                    + 2.0 * obj_mat[o]
                )
            # distractors accidentally overlapping any GT -> corner box
            # (vectorized iou per frame over its gt set)
            by_frame: Dict[int, List[np.ndarray]] = {}
            for (fr, sl), gt in gt_boxes_for_ann.items():
                by_frame.setdefault(fr, []).append(gt)
            for fr, gts in by_frame.items():
                n_gt = int(slot_used[fr])
                if n_gt >= P:
                    continue
                dists = boxes_arr[fr, n_gt:]
                ious = iou_matrix(dists, np.stack(gts))
                bad = (ious >= 0.5).any(axis=1)
                boxes_arr[fr, n_gt:][bad] = np.array(
                    [0, 0, w * 0.05, h * 0.05], np.float32
                )

            seg = rng.standard_normal((F, seg_dim), np.float32) * 0.3
            seg += verb_mat[verb_i][None, :]
            pack.put(vid_seg, feats=feats.astype(h5dt), boxes=boxes_arr.astype(np.float32),
                     scores=scores, seg=seg.astype(h5dt))

            # ---- annotation records (one per query) ---------------------
            for tokens, args_meta in queries:
                args = []
                for o, role, span, placed in args_meta:
                    boxes_json = []
                    for fr, sl in placed:
                        if sl >= 0:
                            gt = gt_boxes_for_ann[(fr, sl)]
                        else:  # unmatched GT: a real box, no proposal hit
                            gt = _jitter_box(rng, obj_track.get(
                                o, _rand_box(rng, w, h)), w, h, 0.05)
                        boxes_json.append(
                            {"frame": int(fr), "box": gt.tolist()}
                        )
                    args.append(
                        {"role": role, "span": span, "lemma": o,
                         "boxes": boxes_json}
                    )
                anns.append(
                    {
                        "ann_idx": ann_idx_global,
                        "vid_seg": vid_seg,
                        "tokens": tokens,
                        "verb_idx": 2,
                        "verb_lemma": verb,
                        "args": args,
                    }
                )
                ann_idx_global += 1
            if verbose and (i + 1) % 1000 == 0:
                print(f"  {split}: {i + 1}/{n} segments", flush=True)

        with open(out_dir / f"anns_{split}.jsonl", "w") as f:
            for a in anns:
                f.write(json.dumps(a) + "\n")
        cs = build_cs_dict(anns, max_partners=max_partners, seed=seed)
        with open(out_dir / f"cs_dict_{split}.json", "w") as f:
            json.dump(cs, f)
        if verbose:
            print(f"{split}: {n} segments, {len(anns)} queries", flush=True)

    pack.close()
    with open(out_dir / "vid_dims.json", "w") as f:
        json.dump(vid_dims, f)
    return out_dir


def main(argv=None) -> Path:
    """``python -m vog_tpu_torch.data.fixtures <out_dir> [--scaled]
    [--<generator keyword>=<int> ...]``: write a fixture (``--scaled``:
    ``generate_scaled``, else ``generate_fixture``), e.g. the CPU tests'
    small widths with ``--prop_dim=64 --seg_dim=48 --glove_dim=32``."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    scaled = "--scaled" in args
    kw = dict(a[2:].split("=", 1) for a in args if a.startswith("--") and "=" in a)
    pos = [a for a in args if not a.startswith("--")]
    if len(pos) != 1:
        raise SystemExit("usage: python -m vog_tpu_torch.data.fixtures <out_dir> [--scaled] [--key=int ...]")
    gen = generate_scaled if scaled else generate_fixture
    out = gen(pos[0], **{k: float(v) if "." in v else int(v) for k, v in kw.items()})
    print(f"wrote {'scaled ' if scaled else ''}fixture to {out}")
    return out


if __name__ == "__main__":
    main()
