"""ASRL dataset: the feature readers, the per-query group assembly and
padding (counterpart of vog_tpu/data/dataset.py, sample for sample).

Each query's contrastive group (ncmp videos: the annotation's own and
ncmp-1 partners, the positive in a sampled slot) is emitted in the uniform
``(V, F, P, ...)`` layout; the SPAT/TEMP concatenation happens on the
device (``sampling/conc.py``).  Output dict (per query; V = ds.num_cmp, F
frames, P proposals a frame, A args, L tokens)::

  props          (V,F,P,prop_dim) f32   RoI fc6 features
  prop_boxes     (V,F,P,5)       f32   normalised x1,y1,x2,y2,area
  prop_mask      (V,F,P)         u8    1 = valid proposal
  seg_feats      (V,F,seg_dim)   f32   TSN segment features
  tokens         (L,)            i32   GloVe ids (0 pad)
  seq_len        ()              i32
  verb_idx       ()              i32   token index of the verb
  srl_roles      (A,)            i32   role-vocab ids (0 pad)
  srl_spans      (A,2)           i32   inclusive token span per arg
  srl_arg_mask   (A,)            u8    1 = arg present
  targets        (V,A,F,P)       u8    IoU>=0.5 labels (positive video only)
  gt_boxes       (A,F,4)         f32   normalised GT box per annotated frame
  gt_frame_mask  (A,F)           u8    1 = arg annotated in this frame
  pos_vid        ()              i32   slot of the positive video
  ann_idx        ()              i32

With ``device_rows`` set (the device feature tables' rows) ``vid_rows
(V,) i32`` replaces ``props`` / ``seg_feats``; with ``index_only`` too a
sample is four int32 fields (``data/ann_store.py``).  0/1 masks and
targets travel as uint8 and are cast on the device (``serve.cast_compact``).

``FeatureStore`` reads the h5 form (``roi_feats.h5`` + ``seg_feats/*.npy``)
and imports h5py only when one is opened; ``featpack.open_store`` prefers
the packed store (``data/featpack.py``), which needs no h5py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from vog_tpu_torch.data.boxes import iou_matrix, normalize_boxes
from vog_tpu_torch.data.contrastive import ContrastiveSampler
from vog_tpu_torch.data.vocab import Vocab, load_annotations, role_to_id

IOU_THRESH = 0.5  # reference: proposals with IoU>=0.5 vs GT are positives


class FeatureStore:
    """RoI h5 + segment npy reader, read lazily a video at a time (the
    packed store, ``data/featpack.py``, is the one for training).  h5py is
    imported here, so a host without it can still use the packed store.
    """

    def __init__(self, data_dir: str | Path):
        import h5py

        self._h5py = h5py
        self.data_dir = Path(data_dir)
        self.h5_path = self.data_dir / "roi_feats.h5"
        self.seg_dir = self.data_dir / "seg_feats"
        with open(self.data_dir / "vid_dims.json") as f:
            self.vid_dims: Dict[str, List[int]] = json.load(f)
        self._h5 = None

    def get(self, vid_seg: str) -> tuple:
        """-> (feats (F,P,D), boxes_abs (F,P,4), scores (F,P), seg (F,Dv))."""
        if self._h5 is None:
            self._h5 = self._h5py.File(self.h5_path, "r")
        g = self._h5[vid_seg]
        return (
            np.asarray(g["feats"], np.float32),
            np.asarray(g["boxes"], np.float32),
            np.asarray(g["scores"], np.float32),
            np.load(self.seg_dir / f"{vid_seg}.npy").astype(np.float32),
        )

    def get_meta(self, vid_seg: str) -> tuple:
        """Small fields only: (boxes_abs, scores) — for device-resident
        feature tables (data/device_store.py)."""
        _, boxes, scores, _ = self.get(vid_seg)
        return boxes, scores

    def get_feats(self, vid_seg: str) -> tuple:
        """Big fields only: (feats (F,P,D), seg (F,Dv))."""
        feats, _, _, seg = self.get(vid_seg)
        return feats, seg

    def videos(self) -> List[str]:
        with self._h5py.File(self.h5_path, "r") as h5:
            return list(h5.keys())

    def dims(self, vid_seg: str) -> tuple:
        w, h = self.vid_dims[vid_seg]
        return float(w), float(h)


class AnetSRLDataset:
    """The L1 dataset (reference ``dat_loader_simple.py`` Dataset class)."""

    def __init__(self, cfg, split: str, vocab: Vocab, store):
        self.cfg = cfg
        self.split = split
        self.vocab = vocab
        self.store = store
        # vid_seg -> row in the device-resident feature tables; when set
        # (Learner + data/device_store.py), __getitem__ emits ``vid_rows``
        # instead of the big props/seg_feats arrays and the gather happens
        # on the device inside the step
        self.device_rows: Optional[Dict[str, int]] = None
        # index-only input path (data/ann_store.py): when also set,
        # __getitem__ emits ONLY the four int32 index fields — the whole
        # annotation block is device-resident and expands inside the step
        self.index_only: bool = False
        self.ann_row_offset: int = 0
        data_dir = Path(cfg.ds.data_dir)
        self.anns = load_annotations(data_dir / f"anns_{split}.jsonl")
        with open(data_dir / f"cs_dict_{split}.json") as f:
            cs_dict = json.load(f)
        self.sampler = ContrastiveSampler(
            cs_dict,
            n_anns=len(self.anns),
            ncmp=cfg.ds.num_cmp,
            is_train=(split == "train"),
            shuffle_cmp=cfg.ds.shuffle_cmp,
            seed=cfg.train.seed,
        )
        # memoized static blocks (profiled host hot path: boxes/scores
        # fetch + normalize/IoU/targets were ~100% of the per-batch host
        # cost once features are device-resident — and all of it is
        # deterministic per video / per annotation, so compute once)
        self._vid_static_cache: Dict[str, tuple] = {}
        self._ann_static_cache: Dict[int, Dict] = {}

    def __len__(self) -> int:
        return len(self.anns)

    # -- per-video static block (boxes; no features) -----------------------
    def _vid_static(self, vid_seg: str):
        """-> (pbox (F,P,5), pmask (F,P), boxes_abs_trim, (w,h)); memoized."""
        hit = self._vid_static_cache.get(vid_seg)
        if hit is not None:
            return hit
        cfg = self.cfg.ds
        F, P = cfg.num_frms, cfg.num_prop_per_frm
        boxes_abs, _scores = self.store.get_meta(vid_seg)
        w, h = self.store.dims(vid_seg)
        f0, p0 = boxes_abs.shape[0], boxes_abs.shape[1]
        pbox = np.zeros((F, P, 5), np.float32)
        pmask = np.zeros((F, P), np.uint8)
        fi, pi = min(f0, F), min(p0, P)
        pbox[:fi, :pi] = normalize_boxes(boxes_abs[:fi, :pi], w, h)
        pmask[:fi, :pi] = 1
        out = (pbox, pmask, boxes_abs[:fi, :pi], (float(w), float(h)))
        self._vid_static_cache[vid_seg] = out
        return out

    # -- per-video feature block -------------------------------------------
    def _video_feats(self, vid_seg: str, fetched=None):
        cfg = self.cfg.ds
        F, P = cfg.num_frms, cfg.num_prop_per_frm
        feats, seg = (
            fetched if fetched is not None else self.store.get_feats(vid_seg)
        )
        f0, p0 = feats.shape[0], feats.shape[1]
        fi, pi = min(f0, F), min(p0, P)
        props = np.zeros((F, P, cfg.prop_dim), np.float32)
        segf = np.zeros((F, cfg.seg_dim), np.float32)
        props[:fi, :pi] = feats[:fi, :pi]
        segf[: min(seg.shape[0], F)] = seg[:F]
        return props, segf

    # -- per-annotation static block (language + GT + own-video targets) ---
    def _ann_static(self, idx: int) -> Dict:
        """Everything in a sample that does not depend on the sampled
        group: tokens/spans/roles, GT boxes + frame mask, and the
        IoU>=0.5 targets of the annotation's OWN video (the positive);
        memoized — the partner videos never contribute targets."""
        hit = self._ann_static_cache.get(idx)
        if hit is not None:
            return hit
        cfg = self.cfg.ds
        F, P, A, L = (
            cfg.num_frms,
            cfg.num_prop_per_frm,
            cfg.max_srl_args,
            cfg.max_seq_len,
        )
        ann = self.anns[idx]
        _, _, pos_abs_boxes, (w, h) = self._vid_static(ann["vid_seg"])

        tokens = np.zeros((L,), np.int32)
        ids = self.vocab.encode(ann["tokens"])[:L]
        tokens[: len(ids)] = ids
        seq_len = np.int32(len(ids))
        verb_idx = np.int32(min(ann["verb_idx"], len(ids) - 1))

        # masks/targets are 0/1 — shipped uint8 (4x smaller H2D; cast to
        # f32 on the device at the top of the step)
        srl_roles = np.zeros((A,), np.int32)
        srl_spans = np.zeros((A, 2), np.int32)
        srl_arg_mask = np.zeros((A,), np.uint8)
        gt_boxes = np.zeros((A, F, 4), np.float32)
        gt_frame_mask = np.zeros((A, F), np.uint8)
        pos_targets = np.zeros((A, F, P), np.uint8)

        for a, arg in enumerate(ann["args"][:A]):
            srl_roles[a] = role_to_id(arg["role"])
            s, e = arg["span"]
            srl_spans[a] = [min(s, L - 1), min(e, L - 1)]
            srl_arg_mask[a] = 1
            for bx in arg["boxes"]:
                fr = int(bx["frame"])
                if fr >= F:
                    continue
                gt_abs = np.asarray(bx["box"], np.float32)
                gt_boxes[a, fr] = normalize_boxes(gt_abs, w, h)[:4]
                gt_frame_mask[a, fr] = 1
                if fr < pos_abs_boxes.shape[0]:
                    ious = iou_matrix(pos_abs_boxes[fr], gt_abs[None])[:, 0]
                    pi = ious.shape[0]
                    pos_targets[a, fr, :pi] = (ious >= IOU_THRESH).astype(
                        np.uint8
                    )

        out = {
            "tokens": tokens,
            "seq_len": seq_len,
            "verb_idx": verb_idx,
            "srl_roles": srl_roles,
            "srl_spans": srl_spans,
            "srl_arg_mask": srl_arg_mask,
            "gt_boxes": gt_boxes,
            "gt_frame_mask": gt_frame_mask,
            "pos_targets": pos_targets,
        }
        self._ann_static_cache[idx] = out
        return out

    # -- main entry ----------------------------------------------------------
    def __getitem__(self, idx: int, rng: np.random.Generator | None = None) -> Dict:
        cfg = self.cfg.ds
        V, F, P, A = (
            cfg.num_cmp,
            cfg.num_frms,
            cfg.num_prop_per_frm,
            cfg.max_srl_args,
        )
        ann = self.anns[idx]
        partners, pos_slot = self.sampler.sample_group(idx, rng)
        group_anns = [self.anns[j] for j in partners]
        group_anns.insert(pos_slot, ann)

        on_device = self.device_rows is not None
        if self.index_only and on_device:
            # index-only sample: everything else is device-resident
            # (data/ann_store.py §expand_index_batch)
            return {
                "vid_rows": np.asarray(
                    [self.device_rows[g["vid_seg"]] for g in group_anns],
                    np.int32,
                ),
                "ann_row": np.int32(self.ann_row_offset + idx),
                "pos_vid": np.int32(pos_slot),
                "ann_idx": np.int32(idx),
            }
        pbox = np.zeros((V, F, P, 5), np.float32)
        pmask = np.zeros((V, F, P), np.uint8)
        for v, g in enumerate(group_anns):
            pb, pm, _, _ = self._vid_static(g["vid_seg"])
            pbox[v], pmask[v] = pb, pm

        if on_device:
            out_feats = {
                "vid_rows": np.asarray(
                    [self.device_rows[g["vid_seg"]] for g in group_anns],
                    np.int32,
                )
            }
        else:
            props = np.zeros((V, F, P, cfg.prop_dim), np.float32)
            segf = np.zeros((V, F, cfg.seg_dim), np.float32)
            # one threaded C++ gather for the whole group when the packed
            # store is in use (data/featpack.py); boxes/scores
            # come from the static cache, so only features move
            if hasattr(self.store, "gather_many"):
                fetched_all = self.store.gather_many(
                    [g["vid_seg"] for g in group_anns], fields=("feats", "seg")
                )
            else:
                fetched_all = [None] * len(group_anns)
            for v, (g, fetched) in enumerate(zip(group_anns, fetched_all)):
                props[v], segf[v] = self._video_feats(g["vid_seg"], fetched)
            out_feats = {"props": props, "seg_feats": segf}

        stat = self._ann_static(idx)
        targets = np.zeros((V, A, F, P), np.uint8)
        targets[pos_slot] = stat["pos_targets"]
        return {
            **out_feats,
            "prop_boxes": pbox,
            "prop_mask": pmask,
            "tokens": stat["tokens"],
            "seq_len": stat["seq_len"],
            "verb_idx": stat["verb_idx"],
            "srl_roles": stat["srl_roles"],
            "srl_spans": stat["srl_spans"],
            "srl_arg_mask": stat["srl_arg_mask"],
            "targets": targets,
            "gt_boxes": stat["gt_boxes"],
            "gt_frame_mask": stat["gt_frame_mask"],
            "pos_vid": np.int32(pos_slot),
            "ann_idx": np.int32(idx),
        }


def get_vocab(cfg) -> Vocab:
    data_dir = Path(cfg.ds.data_dir)
    return Vocab.from_glove_txt(data_dir / "glove.txt")
