"""Device-resident annotation tables: the index-only input path.

Counterpart of vog_tpu/data/ann_store.py.  Everything of a batch that is
static per annotation (tokens, spans, roles, GT boxes and frame masks, the
positive video's IoU targets) or per video (proposal boxes and masks)
lives on the device in five packed 2-D tables, and a batch shrinks to four
int32 fields a sample (plus the uint8 ``batch_mask``)::

    ann_row  ()      row into the annotation tables
    vid_rows (V,)    rows into the feature and video tables (the group)
    pos_vid  ()      slot of the positive video in the group
    ann_idx  ()      split-local index (host metadata for predictions)

``expand_index_batch`` rebuilds the canonical batch on the device, field
for field in the JAX package's dtypes (uint8 masks and targets, which
``cast_compact`` then casts); the feature gather (``vid_rows``) follows
in ``gather_from_tables``.  ``AnnTables.from_arrays`` packs the tables
from per-annotation and per-video arrays; ``AnnTables.from_datasets``
from the splits of a dataset (the JAX package's ``DeviceAnnTables``): one
table for all three splits, a split's rows starting at its
``split_offset``, so every split runs the same captured eval step.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vog_tpu_torch.device import DeviceLike, resolve_device

# the table keys expand_index_batch reads; "ann_i32" among the tables and
# "ann_row" in the batch switch the step's expansion on
ANN_TABLE_KEYS = ("ann_i32", "ann_u8", "ann_f32", "vid_box", "vid_pmask")


def _dims(cfg):
    ds = cfg.ds
    return ds.max_seq_len, ds.max_srl_args, ds.num_frms, ds.num_prop_per_frm, ds.num_cmp


def ann_table_bytes(cfg, n_anns: int, n_videos: int) -> int:
    L, A, F, P, _ = _dims(cfg)
    per_ann = (L + 2 + 3 * A) * 4 + (A + A * F + A * F * P) + A * F * 4 * 4
    per_vid = F * P * 5 * 4 + F * P
    return n_anns * per_ann + n_videos * per_vid


def pack_ann_tables(cfg, anns: Dict[str, np.ndarray], vids: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-annotation arrays (``tokens (N,L)``, ``seq_len (N,)``,
    ``verb_idx (N,)``, ``srl_roles (N,A)``, ``srl_spans (N,A,2)``,
    ``srl_arg_mask (N,A)``, ``gt_frame_mask (N,A,F)``, ``pos_targets
    (N,A,F,P)``, ``gt_boxes (N,A,F,4)``) and per-video arrays
    (``prop_boxes (Nv,F,P,5)``, ``prop_mask (Nv,F,P)``) -> the five
    host tables, in the JAX package's layout."""
    L, A, F, P, _ = _dims(cfg)
    n = len(anns["tokens"])
    i32 = np.zeros((n, L + 2 + 3 * A), np.int32)
    i32[:, :L] = anns["tokens"]
    i32[:, L] = anns["seq_len"]
    i32[:, L + 1] = anns["verb_idx"]
    i32[:, L + 2:L + 2 + A] = anns["srl_roles"]
    i32[:, L + 2 + A:] = np.asarray(anns["srl_spans"]).reshape(n, -1)
    u8 = np.zeros((n, A + A * F + A * F * P), np.uint8)
    u8[:, :A] = anns["srl_arg_mask"]
    u8[:, A:A + A * F] = np.asarray(anns["gt_frame_mask"]).reshape(n, -1)
    u8[:, A + A * F:] = np.asarray(anns["pos_targets"]).reshape(n, -1)
    nv = len(vids["prop_boxes"])
    return {
        "ann_i32": i32,
        "ann_u8": u8,
        "ann_f32": np.asarray(anns["gt_boxes"], np.float32).reshape(n, A * F * 4),
        "vid_box": np.asarray(vids["prop_boxes"], np.float32).reshape(nv, F * P * 5),
        "vid_pmask": np.asarray(vids["prop_mask"], np.uint8).reshape(nv, F * P),
    }


class AnnTables:
    """The five annotation tables on one device (``tables``), row i of the
    video tables being the feature tables' row i."""

    def __init__(self, tables: Dict[str, torch.Tensor], split_offset: Optional[Dict[str, int]] = None):
        self.tables = tables
        self.split_offset = split_offset or {}
        self.n_anns = int(tables["ann_i32"].shape[0])

    @classmethod
    def from_datasets(cls, cfg, datasets: Dict, vid_rows: Dict[str, int],
                      device: DeviceLike = None) -> "AnnTables":
        """Tables of every annotation of ``datasets`` (split ->
        ``AnetSRLDataset``; train, valid, test in that order, each from its
        ``split_offset``) and of every video of ``vid_rows``
        (``DeviceFeatureTables.rows``: row i of the video tables is row i
        of the feature tables), from the datasets' memoised statics."""
        offsets, n = {}, 0
        for split in ("train", "valid", "test"):
            if split in datasets:
                offsets[split] = n
                n += len(datasets[split])
        keys = ("tokens", "seq_len", "verb_idx", "srl_roles", "srl_spans", "srl_arg_mask",
                "gt_frame_mask", "pos_targets", "gt_boxes")
        stats = [datasets[s]._ann_static(i) for s in offsets for i in range(len(datasets[s]))]
        anns = {k: np.stack([st[k] for st in stats]) for k in keys}
        any_ds = next(iter(datasets.values()))
        nv = max(vid_rows.values()) + 1 if vid_rows else 0
        _, _, F, P, _ = _dims(cfg)
        vids = {"prop_boxes": np.zeros((nv, F, P, 5), np.float32),
                "prop_mask": np.zeros((nv, F, P), np.uint8)}
        for vid, row in vid_rows.items():
            pb, pm, _, _ = any_ds._vid_static(vid)
            vids["prop_boxes"][row], vids["prop_mask"][row] = pb, pm
        t = cls.from_arrays(cfg, anns, vids, device=device)
        t.split_offset = offsets
        return t

    @classmethod
    def from_arrays(cls, cfg, anns: Dict[str, np.ndarray], vids: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> "AnnTables":
        dev = resolve_device(device)
        host = pack_ann_tables(cfg, anns, vids)
        return cls({k: torch.from_numpy(v).to(dev) for k, v in host.items()})


def expand_index_batch(batch: Dict[str, torch.Tensor], tables: Dict[str, torch.Tensor], cfg) -> Dict:
    """Index-only batch -> the canonical batch, on the batch's device.
    Bitwise the JAX package's ``expand_index_batch``, field for field and
    dtype for dtype."""
    L, A, F, P, V = _dims(cfg)
    r = batch["ann_row"].long()
    B = r.shape[0]
    out = {k: v for k, v in batch.items() if k != "ann_row"}

    i32 = tables["ann_i32"].index_select(0, r)
    out["tokens"] = i32[:, :L]
    out["seq_len"] = i32[:, L]
    out["verb_idx"] = i32[:, L + 1]
    out["srl_roles"] = i32[:, L + 2:L + 2 + A]
    out["srl_spans"] = i32[:, L + 2 + A:].reshape(B, A, 2)

    u8 = tables["ann_u8"].index_select(0, r)
    out["srl_arg_mask"] = u8[:, :A]
    out["gt_frame_mask"] = u8[:, A:A + A * F].reshape(B, A, F)
    pos_targets = u8[:, A + A * F:].reshape(B, A, F, P)
    out["gt_boxes"] = tables["ann_f32"].index_select(0, r).reshape(B, A, F, 4)

    rows = batch["vid_rows"].long().reshape(-1)  # (B*V,)
    out["prop_boxes"] = tables["vid_box"].index_select(0, rows).reshape(B, V, F, P, 5)
    out["prop_mask"] = tables["vid_pmask"].index_select(0, rows).reshape(B, V, F, P)
    # targets live only in the positive video's slot
    onehot = (torch.arange(V, dtype=torch.int32, device=r.device)[None, :]
              == batch["pos_vid"][:, None]).to(torch.uint8)
    out["targets"] = pos_targets[:, None] * onehot[:, :, None, None, None]
    return out
