"""Packed feature store: a flat mmap'd file and a threaded C++ gather
(counterpart of vog_tpu/data/featpack.py).

Layout, the JAX package's byte for byte::

  featpack.bin    every array back to back, little-endian float32, the
                  videos in name order, each video's fields in the order
                  feats, boxes, scores, seg
  featpack.json   {"entries": {vid_seg: {"feats": [offset, shape],
                                "boxes": [...], "scores": [...],
                                "seg": [...]}}}

``PackWriter`` writes the pack straight from arrays (the port's fixtures
have no h5 step); ``build_featpack`` converts the JAX package's h5 form
(``roi_feats.h5`` + ``seg_feats/*.npy``) and imports h5py only when it
runs.  ``PackedFeatureStore`` reads a pack (get / get_meta / get_feats /
gather_many / videos / dims), as ``data/dataset.py §FeatureStore`` reads
the h5 form.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from vog_tpu_torch.data.dataset import FeatureStore

FIELDS = ("feats", "boxes", "scores", "seg")
GATHER_THREADS = 8  # threads of one C++ gather call


class PackWriter:
    """Writes ``featpack.bin`` / ``featpack.json`` for a known set of
    videos, in any order of ``put`` calls: each video's offset follows
    from the name order of ``shapes`` (video -> {field: shape}), as the
    h5 conversion lays them out, so the writer streams a video at a time
    and holds none of the table."""

    def __init__(self, data_dir: str | Path, shapes: Mapping[str, Mapping[str, Sequence[int]]]):
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.entries: Dict[str, Dict[str, List]] = {}
        off = 0
        for vid in sorted(shapes):
            rec = {}
            for f in FIELDS:
                shape = [int(d) for d in shapes[vid][f]]
                rec[f] = [off, shape]
                off += int(np.prod(shape, dtype=np.int64)) * 4
            self.entries[vid] = rec
        self._done: set = set()
        self._f = open(self.data_dir / "featpack.bin", "wb")
        self._f.truncate(off)

    def put(self, vid: str, **arrays: np.ndarray) -> None:
        """Write one video's four fields (cast to float32, as the h5
        conversion upcasts fp16 tables)."""
        if set(arrays) != set(FIELDS):
            raise ValueError(f"{vid}: fields {sorted(arrays)} != {sorted(FIELDS)}")
        if vid in self._done:
            raise ValueError(f"{vid} written twice")
        for f in FIELDS:
            off, shape = self.entries[vid][f]
            arr = np.ascontiguousarray(arrays[f], dtype=np.float32)
            if list(arr.shape) != shape:
                raise ValueError(f"{vid}.{f}: shape {arr.shape} != {tuple(shape)}")
            self._f.seek(off)
            self._f.write(arr.tobytes())
        self._done.add(vid)

    def close(self) -> Path:
        missing = set(self.entries) - self._done
        if missing:
            raise ValueError(f"{len(missing)} videos never written, e.g. {sorted(missing)[:3]}")
        self._f.close()
        with open(self.data_dir / "featpack.json", "w") as f:
            json.dump({"entries": self.entries}, f)
        return self.data_dir / "featpack.bin"


def build_featpack(data_dir: str | Path) -> Path:
    """One-shot conversion of the h5 form: roi_feats.h5 + seg_feats/*.npy
    -> the pack files (h5py imported here only)."""
    import h5py

    data_dir = Path(data_dir)
    with h5py.File(data_dir / "roi_feats.h5", "r") as h5:
        names = list(h5.keys())
        seg = lambda v: data_dir / "seg_feats" / f"{v}.npy"  # noqa: E731
        shapes = {v: {"feats": h5[v]["feats"].shape, "boxes": h5[v]["boxes"].shape,
                      "scores": h5[v]["scores"].shape, "seg": np.load(seg(v), mmap_mode="r").shape}
                  for v in names}
        w = PackWriter(data_dir, shapes)
        for v in names:
            w.put(v, feats=np.asarray(h5[v]["feats"]), boxes=np.asarray(h5[v]["boxes"]),
                  scores=np.asarray(h5[v]["scores"]), seg=np.load(seg(v)))
    return w.close()


class PackedFeatureStore:
    """mmap + threaded C++ gather over a pack; the reader API of
    ``data/dataset.py §FeatureStore``."""

    FIELDS = FIELDS

    def __init__(self, data_dir: str | Path):
        from vog_tpu_torch.native import load_featpack

        self.data_dir = Path(data_dir)
        self._lib = load_featpack()
        self._handle = self._lib.fp_open(str(self.data_dir / "featpack.bin").encode())
        if not self._handle:
            raise FileNotFoundError(self.data_dir / "featpack.bin")
        with open(self.data_dir / "featpack.json") as f:
            self.entries = json.load(f)["entries"]
        with open(self.data_dir / "vid_dims.json") as f:
            self.vid_dims = json.load(f)

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            if getattr(self, "_handle", None):
                self._lib.fp_close(self._handle)
                self._handle = None
        except Exception:
            pass

    def dims(self, vid_seg: str) -> Tuple[float, float]:
        w, h = self.vid_dims[vid_seg]
        return float(w), float(h)

    def videos(self) -> List[str]:
        return list(self.entries.keys())

    def gather_many(self, vid_segs: Sequence[str], fields=None) -> List[tuple]:
        """The given fields (default: all) of many videos in ONE threaded
        C++ call -> a list of per-video field tuples (float32 views of one
        buffer)."""
        fields = fields or self.FIELDS
        src, size, dst, recs = [], [], [], []
        total = 0
        for seg in vid_segs:
            e = self.entries[seg]
            shapes = []
            for f in fields:
                off, shape = e[f]
                nb = int(np.prod(shape, dtype=np.int64)) * 4
                src.append(off)
                size.append(nb)
                dst.append(total)
                shapes.append((total, shape))
                total += nb
            recs.append(shapes)
        buf = np.empty(total, np.uint8)
        cols = [np.ascontiguousarray(x, dtype=np.uint64) for x in (src, size, dst)]
        ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))  # noqa: E731
        rc = self._lib.fp_gather(self._handle, ptr(cols[0]), ptr(cols[1]), ptr(cols[2]),
                                 buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(src),
                                 GATHER_THREADS)
        if rc != 0:
            raise RuntimeError("featpack gather out of bounds")
        return [tuple(np.frombuffer(buf, np.float32, count=int(np.prod(shape, dtype=np.int64)),
                                    offset=off).reshape(shape) for off, shape in shapes)
                for shapes in recs]

    def get(self, vid_seg: str) -> tuple:
        """-> (feats (F,P,D), boxes_abs (F,P,4), scores (F,P), seg (F,Dv))."""
        return self.gather_many([vid_seg])[0]

    def get_meta(self, vid_seg: str) -> tuple:
        """Small fields only: (boxes_abs (F,P,4), scores (F,P)), for when
        the big tables live on the device."""
        return self.gather_many([vid_seg], fields=("boxes", "scores"))[0]

    def get_feats(self, vid_seg: str) -> tuple:
        """Big fields only: (feats (F,P,D), seg (F,Dv))."""
        return self.gather_many([vid_seg], fields=("feats", "seg"))[0]


def open_store(data_dir: str | Path):
    """The feature store of a data directory: the pack when it holds one,
    else the h5 form (``data/dataset.py §FeatureStore``, which needs
    h5py)."""
    if (Path(data_dir) / "featpack.bin").exists():
        return PackedFeatureStore(data_dir)
    return FeatureStore(data_dir)
