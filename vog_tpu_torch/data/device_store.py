"""Device-resident feature tables: the feature store lives on the card.

Counterpart of vog_tpu/data/device_store.py (single device).  The tables
are ``feats (N, F*P*prop_dim/128, 128)`` and ``seg (N, F*seg_dim/128,
128)``, row-contiguous, in f32, bf16 or int8 with one scale per trailing
vector; batches carry ``vid_rows (B, V) int32`` and ``gather_from_tables``
resolves them on the card through the gather kernel
(kernels/gather.py), so a request carries a few KB instead of ~34 MB of
features.  The tables are filled chunk by chunk, so peak memory is the
table plus one chunk: ``from_store`` streams a feature store's videos
(row i = the store's video i, ``rows`` maps a video to its row) a chunk
of rows at a time through one threaded read.

``device_store_mode`` decides ``ds.device_store``: "on" and "off" as
they say, "shard" row-sharded over a data-parallel world; "auto" is on
(replicated) when the tables fit ``FREE_SHARE`` of the card's free memory
(``torch.cuda.mem_get_info``), else sharded when a world's 1/N of them
does, else off, and off on the CPU.  The JAX package's fixed 8 GB budget
and its TPU-only gate were set for a TPU v5e's 16 GB and are not copied.

The row-sharded store (counterpart of the JAX package's ``shard=True``
tables and ``sharded_gather_from_tables``): data index r of N holds
rows [r*n, (r+1)*n) of the table padded to N*n rows, built from its own
slice of the store (the model ranks of a data index hold the same
shard), and the collectives run over the data group; the step's gather all-gathers the global batch's
``vid_rows``, gathers them from the local shard with the gather kernel
(rows clamped to the shard), dequantises int8 locally, zeroes the rows
that another rank owns and reduce-scatters over the batch, so each rank
ends with its own rows, each the sum of one owner's copy and zeros
(exact).  The table never moves; a step moves the global batch's
gathered rows once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vog_tpu_torch.device import DeviceLike, resolve_device
from vog_tpu_torch.kernels.gather import gather_rows


# "auto" keeps the tables to this share of the card's free memory: the
# rest holds the model, the optimizer, a captured step's pool and eval
FREE_SHARE = 0.5


def table_bytes(cfg, n_videos: int) -> int:
    """The feature tables' size for ``n_videos`` rows under
    ``misc.int8_feats`` (scales included) / ``misc.half_feats``."""
    ds = cfg.ds
    per_vid = ds.num_frms * (ds.num_prop_per_frm * ds.prop_dim + ds.seg_dim)
    if cfg.misc.int8_feats:
        return n_videos * (per_vid + ds.num_frms * (ds.num_prop_per_frm + 1) * 4)
    return n_videos * per_vid * (2 if cfg.misc.half_feats else 4)


def device_store_mode(cfg, n_videos: int, device: torch.device, extra_bytes: int = 0, mesh=None) -> str:
    """``ds.device_store`` on ``device`` -> "on" (replicated), "shard" or
    "off": "on" / "off" / "shard" as set ("shard" needs ``mesh``, a
    data-parallel world: train/dist.py); "auto": on when the tables (plus
    ``extra_bytes``, the annotation tables, which stay replicated) fit
    ``FREE_SHARE`` of the card's free memory, else shard when 1/N of the
    tables does in a world of N > 1, else off; off on the CPU."""
    want = cfg.ds.device_store
    grouped = mesh is not None and mesh.data_group is not None
    if want not in ("auto", "on", "off", "shard"):
        raise ValueError(f"ds.device_store={want!r}: the port takes auto, on, off or shard")
    if want == "shard" and not grouped:
        raise ValueError("ds.device_store=shard row-shards the tables over a data-parallel world: it needs "
                         "misc.multihost=true under torchrun (one process has nothing to shard over)")
    if want != "auto":
        return want
    if device.type != "cuda":
        return "off"
    free, _ = torch.cuda.mem_get_info(device)
    tb = table_bytes(cfg, n_videos)
    if tb + extra_bytes <= FREE_SHARE * free:
        return "on"
    world = mesh.data if grouped else 1
    if world > 1 and -(-tb // world) + extra_bytes <= FREE_SHARE * free:
        return "shard"
    return "off"


def use_device_store(cfg, n_videos: int, device: torch.device, extra_bytes: int = 0) -> bool:
    """``device_store_mode`` of one process: whether the replicated tables
    are built."""
    return device_store_mode(cfg, n_videos, device, extra_bytes) == "on"


def shard_rows(n_videos: int, rank: int, world: int) -> tuple:
    """(first, stop, rows a shard): rank's rows of ``n_videos`` padded to a
    multiple of ``world``; rows at or past ``n_videos`` are padding."""
    per = -(-n_videos // world)
    return rank * per, min((rank + 1) * per, n_videos), per


def _table_shape(n: int, width: int) -> tuple:
    """3-D ``(N, width//128, 128)`` when the row width is a multiple of 128,
    else flat ``(N, width)`` (the JAX package's layout; the gather kernel
    takes either)."""
    if width % 128 == 0:
        return (n, width // 128, 128)
    return (n, width)


def _pack_rows(local: Dict[str, torch.Tensor], dtype: torch.dtype, int8: bool) -> Dict[str, torch.Tensor]:
    """(rows, ...) fp32 arrays -> the packed tables.  int8 quantizes per
    trailing vector: s = maxabs/127 (1 where the vector is zero),
    q = clip(round(x / s), -127, 127); ``{k}_scale`` (rows, n_vectors)
    sits beside each int8 table."""
    out = {}
    for k, v in local.items():
        v = torch.as_tensor(v)
        shape = _table_shape(v.shape[0], int(np.prod(v.shape[1:])))
        if int8:
            s = v.abs().amax(dim=-1) / 127.0
            s = torch.where(s == 0, torch.ones_like(s), s).float()
            q = torch.clamp(torch.round(v / s[..., None]), -127, 127).to(torch.int8)
            out[k] = q.reshape(shape)
            out[k + "_scale"] = s.reshape(s.shape[0], -1)
        else:
            out[k] = v.reshape(shape).to(dtype)
    return out


class DeviceFeatureTables:
    """Packed per-video feature tables on one device: ``tables`` is
    {"feats", "seg"} (+ "feats_scale"/"seg_scale" for int8), row i being
    video i; or, built with ``shard``, this rank's row shard of them."""

    def __init__(
        self,
        cfg,
        n_rows: int,
        half: bool = False,
        int8: bool = False,
        device: DeviceLike = None,
    ):
        ds = cfg.ds
        self.device = resolve_device(device)
        self.int8 = bool(int8)
        self.dtype = torch.int8 if int8 else (torch.bfloat16 if half else torch.float32)
        self.shapes = {
            "feats": (ds.num_frms, ds.num_prop_per_frm, ds.prop_dim),
            "seg": (ds.num_frms, ds.seg_dim),
        }
        self.n_rows = int(n_rows)
        self.rows: Optional[Dict[str, int]] = None  # video -> row, for tables built from a store
        self.tables: Dict[str, torch.Tensor] = {}
        for k, s in self.shapes.items():
            shape = _table_shape(self.n_rows, int(np.prod(s)))
            self.tables[k] = torch.zeros(shape, dtype=self.dtype, device=self.device)
            if self.int8:
                self.tables[k + "_scale"] = torch.ones(
                    (self.n_rows, int(np.prod(s[:-1]))), dtype=torch.float32, device=self.device
                )

    def write(self, i0: int, feats, seg) -> None:
        """Pack fp32 rows ``feats (m,F,P,D)``, ``seg (m,F,Dv)`` into rows
        [i0, i0+m), on the table's device."""
        local = {
            "feats": torch.as_tensor(feats).to(self.device, torch.float32),
            "seg": torch.as_tensor(seg).to(self.device, torch.float32),
        }
        m = local["feats"].shape[0]
        for k, v in _pack_rows(local, self.dtype, self.int8).items():
            self.tables[k][i0 : i0 + m] = v

    @classmethod
    def from_store(cls, cfg, store, half: bool = False, int8: bool = False,
                   device: DeviceLike = None, chunk_rows: int = 256,
                   shard: Optional[Tuple[int, int]] = None) -> "DeviceFeatureTables":
        """Tables of every video of ``store`` (``store.videos()`` order;
        ``rows`` maps a video to its row), streamed ``chunk_rows`` videos at
        a time: one read of the chunk's feats and seg (one threaded call
        for the packed store), each clipped or zero-padded to (F, P) and F
        frames as the JAX package's ``_stream_build_tables``, then packed
        on the device.  ``shard`` = (rank, world): only this rank's rows
        (``shard_rows``), read from the store and packed; ``rows`` still
        maps every video to its global row."""
        vids: List[str] = store.videos()
        lo, hi, n = (0, len(vids), len(vids)) if shard is None else shard_rows(len(vids), *shard)
        t = cls(cfg, n, half=half, int8=int8, device=device)
        t.rows = {v: i for i, v in enumerate(vids)}
        (F, P, D), (_, Dv) = t.shapes["feats"], t.shapes["seg"]
        many = getattr(store, "gather_many", None)
        for i0 in range(lo, hi, chunk_rows):
            chunk = vids[i0:min(i0 + chunk_rows, hi)]
            got = many(chunk, fields=("feats", "seg")) if many else [store.get_feats(v) for v in chunk]
            feats = np.zeros((len(chunk), F, P, D), np.float32)
            seg = np.zeros((len(chunk), F, Dv), np.float32)
            for j, (fv, sv) in enumerate(got):
                fi, pi = min(fv.shape[0], F), min(fv.shape[1], P)
                feats[j, :fi, :pi] = fv[:fi, :pi]
                seg[j, :min(sv.shape[0], F)] = sv[:F]
            t.write(i0 - lo, feats, seg)
        return t

    @classmethod
    def from_arrays(cls, cfg, feats, seg, half=False, int8=False,
                    device: DeviceLike = None, chunk_rows: int = 256):
        """Tables from host or device arrays ``feats (N,F,P,D)``, ``seg (N,F,Dv)``."""
        t = cls(cfg, len(feats), half=half, int8=int8, device=device)
        for i0 in range(0, len(feats), chunk_rows):
            t.write(i0, feats[i0 : i0 + chunk_rows], seg[i0 : i0 + chunk_rows])
        return t

    @classmethod
    def random(cls, cfg, n_rows: int, seed: int, half=False, int8=False,
               device: DeviceLike = None, chunk_rows: int = 256, scale: float = 0.3):
        """Tables of normal(0, scale) rows made on the device from a seeded
        ``torch.Generator`` (stand-in data at a deployment's table size)."""
        t = cls(cfg, n_rows, half=half, int8=int8, device=device)
        g = torch.Generator(device=t.device)
        g.manual_seed(seed)
        fs, ss = t.shapes["feats"], t.shapes["seg"]
        for i0 in range(0, n_rows, chunk_rows):
            m = min(chunk_rows, n_rows - i0)
            f = torch.randn((m, *fs), generator=g, device=t.device) * scale
            s = torch.randn((m, *ss), generator=g, device=t.device) * scale
            t.write(i0, f, s)
        return t


def _row_width(table: torch.Tensor) -> int:
    return int(np.prod(table.shape[1:]))


def gather_from_tables(batch: Dict, tables: Dict) -> Dict:
    """Resolve ``vid_rows`` against the resident tables into the canonical
    ``props (B,V,F,P,D)`` / ``seg_feats (B,V,F,Dv)`` fp32 batch fields."""
    rows = batch["vid_rows"].to(torch.int32).contiguous()  # (B, V)
    B, V, F, P = batch["prop_mask"].shape
    D = _row_width(tables["feats"]) // (F * P)
    Dv = _row_width(tables["seg"]) // F
    out = {k: v for k, v in batch.items() if k != "vid_rows"}
    props = gather_rows(tables["feats"], rows).reshape(B, V, F, P, D).float()
    seg = gather_rows(tables["seg"], rows).reshape(B, V, F, Dv).float()
    if "feats_scale" in tables:  # int8 tables: dequantize per vector
        fs = gather_rows(tables["feats_scale"], rows).reshape(B, V, F, P, 1)
        ss = gather_rows(tables["seg_scale"], rows).reshape(B, V, F, 1)
        props = props * fs
        seg = seg * ss
    out["props"] = props
    out["seg_feats"] = seg
    return out


def sharded_gather_from_tables(batch: Dict, tables: Dict, mesh) -> Dict:
    """``gather_from_tables`` against row-sharded tables (``shard_rows``):
    ``batch`` holds this rank's rows, ``tables`` its shard.  The global
    batch's ``vid_rows`` are all-gathered, gathered from the local shard
    (rows clamped to it), int8 dequantised here, zeroed where another rank
    owns the row, and reduce-scattered over the batch: this rank's rows
    come back, each from its one owner."""
    rows = mesh.all_gather(batch["vid_rows"].to(torch.int32).contiguous())  # (data * B, V)
    B, V, F, P = batch["prop_mask"].shape
    D = _row_width(tables["feats"]) // (F * P)
    Dv = _row_width(tables["seg"]) // F
    n = tables["feats"].shape[0]
    start = mesh.data_index * n
    mine = ((rows >= start) & (rows < start + n))[..., None]
    loc = (rows - start).clamp(0, n - 1).to(torch.int32).contiguous()
    Bg = rows.shape[0]
    f = gather_rows(tables["feats"], loc).reshape(Bg, V, -1)
    s = gather_rows(tables["seg"], loc).reshape(Bg, V, -1)
    if "feats_scale" in tables:  # int8: dequantise locally, the scatter then carries f32
        fs = gather_rows(tables["feats_scale"], loc).reshape(Bg, V, F, P, 1)
        ss = gather_rows(tables["seg_scale"], loc).reshape(Bg, V, F, 1)
        f = (f.reshape(Bg, V, F, P, D).float() * fs).reshape(Bg, V, -1)
        s = (s.reshape(Bg, V, F, Dv).float() * ss).reshape(Bg, V, -1)
    f = mesh.reduce_scatter(torch.where(mine, f, torch.zeros((), dtype=f.dtype, device=f.device)))
    s = mesh.reduce_scatter(torch.where(mine, s, torch.zeros((), dtype=s.dtype, device=s.device)))
    out = {k: v for k, v in batch.items() if k != "vid_rows"}
    out["props"] = f.reshape(B, V, F, P, D).float()
    out["seg_feats"] = s.reshape(B, V, F, Dv).float()
    return out
