"""Row gather from a resident table: ``table[clamp(rows, 0, N-1)]``.

Replaces vog_tpu/kernels/gather.py §gather_rows (Pallas manual DMA, one
async copy per row through an 8-slot semaphore ring).  CUDA kernel:
csrc/gather.cu.  Bound by bytes on the H100 (each requested row read once
and written once); the kernel splits each row into 64 KB chunks, one
block each, and moves 16-byte vectors, so it fills the card at a batch of
64 rows and is bitwise exact for every dtype.  Unlike the TPU kernel it
takes any row width, so there is no fallback: on a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from vog_tpu_torch.kernels import _build

NAME = "gather_rows"


def gather_rows_plain(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: clamp, then index the leading axis."""
    idx = rows.reshape(-1).long().clamp(0, table.shape[0] - 1)
    return table[idx].reshape(*rows.shape, *table.shape[1:])


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table`` (N, ...) of any dtype; ``rows`` int32 of any shape ->
    ``rows.shape + table.shape[1:]``."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, rows)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    dev = table.device
    if not table.is_contiguous() or table.dim() < 1:
        raise ValueError("gather_rows: table must be contiguous with a row axis")
    if rows.device != dev or rows.dtype != torch.int32 or not rows.is_contiguous():
        raise ValueError("gather_rows: rows must be contiguous int32 on the table's device")
    n = table.shape[0]
    if n == 0:
        raise ValueError("gather_rows: empty table")
    row_bytes = table[0].numel() * table.element_size()
    out = torch.empty((*rows.shape, *table.shape[1:]), dtype=table.dtype, device=dev)
    P, LL = _build.P, _build.LL
    fn = _build.function("gather.cu", "vog_gather_rows", [P, P, P, LL, LL, LL, P])
    rc = fn(table.data_ptr(), rows.data_ptr(), out.data_ptr(), n, row_bytes,
            rows.numel(), _build.stream_ptr(table))
    _build.check(rc, NAME)
    _build.count(NAME)
    return out
