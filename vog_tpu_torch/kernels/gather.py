"""Row gather from a resident table: ``table[clamp(rows, 0, N-1)]``.

Replaces vog_tpu/kernels/gather.py §gather_rows (Pallas manual DMA, one
async copy per row through an 8-slot semaphore ring).  CUDA kernel:
csrc/gather.cu.  Bound by bytes on the H100 (each requested row read once
and written once); the kernel splits a call's n_req x row_bytes evenly
into pieces of one 16-byte unit a thread, 256 a block, with streaming
loads and stores, so a call of 4 GT5 rows reaches every SM (200 blocks)
and one of 64 rows keeps every resident thread's load in flight (3,200
blocks).  It copies bytes, so it is bitwise exact for every dtype.
Unlike the TPU kernel it takes any row width (a byte a thread where the
width is not a multiple of 16 bytes), so there is no fallback: on a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs the
plain version.  An empty ``rows`` launches nothing.  The kernel is the
op ``vog::gather_rows`` (``_build.define_op``), so an exported program
(``vog_tpu_torch/export.py``) holds it as one node.
"""

from __future__ import annotations

import torch

from vog_tpu_torch.kernels import _build

NAME = "gather_rows"
_ARGTYPES = (_build.P, _build.P, _build.P, _build.LL, _build.LL, _build.LL, _build.P)


def gather_rows_plain(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: clamp, then index the leading axis."""
    idx = rows.reshape(-1).long().clamp(0, table.shape[0] - 1)
    return table[idx].reshape(*rows.shape, *table.shape[1:])


def _gather_rows_cuda(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The kernel's launch (the op's CUDA implementation)."""
    # the serving path calls this twice a flush on a few rows, where the
    # host's issue of the call costs more than the copy: checks stay cheap
    dev = table.device
    if not table.is_contiguous() or table.dim() < 1:
        raise ValueError("gather_rows: table must be contiguous with a row axis")
    if rows.device != dev or rows.dtype != torch.int32 or not rows.is_contiguous():
        raise ValueError("gather_rows: rows must be contiguous int32 on the table's device")
    n = table.shape[0]
    if n == 0:
        raise ValueError("gather_rows: empty table")
    out = torch.empty(rows.shape + table.shape[1:], dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.function("gather.cu", "vog_gather_rows", _ARGTYPES)
    rc = fn(dev.index, table.data_ptr(), rows.data_ptr(), out.data_ptr(), n,
            table.numel() // n * table.element_size(), rows.numel(), _build.stream_ptr(table))
    _build.check(rc, NAME)
    _build.count(NAME)
    return out


# the op ``vog::gather_rows``: the kernel on the card, the plain version on
# the CPU, shapes alone for a fake (traced) tensor
_build.define_op(
    "gather_rows(Tensor table, Tensor rows) -> Tensor",
    cuda=_gather_rows_cuda, cpu=gather_rows_plain,
    fake=lambda table, rows: table.new_empty(rows.shape + table.shape[1:]))


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table`` (N, ...) of any dtype; ``rows`` int32 of any shape ->
    ``rows.shape + table.shape[1:]``, through the op ``vog::gather_rows``."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    return torch.ops.vog.gather_rows(table, rows)
