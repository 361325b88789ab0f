"""ESC numeric phase for one bucket's rows, compaction fused in.

``spgemm_numeric`` launches the hand-written CUDA kernel
``csrc/esc_numeric.cu`` on CUDA tensors and runs :func:`spgemm_numeric_plain`
on CPU tensors.  It returns ``(col, val, row_nnz, overflow)``: per row the
ascending distinct columns and their value sums in ``row_capacity`` slots
(sentinel / 0 past the row's nnz), the row's true nnz even when it exceeds
the capacity, and the total of entries dropped for capacity.

Replaces ``src/repro/kernels/spgemm_numeric.py::spgemm_numeric_pallas``
(``_kernel``) together with its XLA-side ``compact``.  On the H100 the
kernel is bound by bytes: the products' A and B entries (8 bytes per
product gathered) and the output slots (8 bytes each).  One thread block
per row sorts the row's (column, value) pairs in shared memory and writes
the run sums straight into the capacity slots, so the uncompacted
``(R, next_pow2(DA·DB))`` buffers of the TPU kernel never reach device
memory; rows too wide for the 227 KB opt-in limit sort in a global scratch
slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.binning import ceil_pow2
from repro_torch.core.csr import CSRDevice
from repro_torch.core.spgemm import spgemm_rows
from . import _build

_LIB = "esc_numeric"


def spgemm_numeric_plain(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                         max_deg_a: int, max_deg_b: int, row_capacity: int):
    """Plain tensor-op version: gather, stable sort by column, segment sums
    scattered into the capacity slots (``core.spgemm.spgemm_rows``)."""
    return tuple(spgemm_rows(a, b, rows, row_capacity=row_capacity,
                             max_deg_a=max_deg_a, max_deg_b=max_deg_b))


def spgemm_numeric(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                   max_deg_a: int, max_deg_b: int, row_capacity: int,
                   rownnz_b: torch.Tensor | None = None):
    """(col int32 (R, cap), val float32 (R, cap), row_nnz int32 (R,),
    overflow int32) for ``rows`` at the bucket's degree bounds."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_LIB, a.rpt, a.col, a.val, b.rpt, b.col,
                               b.val, rownnz_b, rows)
    if dev is None:
        return spgemm_numeric_plain(a, b, rows, max_deg_a=max_deg_a,
                                    max_deg_b=max_deg_b,
                                    row_capacity=row_capacity)
    r = rows.shape[0]
    cap = int(row_capacity)
    col = torch.empty((r, cap), dtype=torch.int32, device=dev)
    val = torch.empty((r, cap), dtype=torch.float32, device=dev)
    row_nnz = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        i32 = torch.int32
        if rownnz_b.shape[0] != b.nrows:
            raise RuntimeError(f"{_LIB}: rownnz_b has {rownnz_b.shape[0]} "
                               f"entries for {b.nrows} rows of B")
        f2 = ceil_pow2(max_deg_a * max_deg_b)
        ws, grid, threads, smem, scratch = _build.row_workspace(
            _LIB, dev, max_deg_a, f2, 8, r)     # key + value: 8 bytes a lane
        fn = _build.launcher(_LIB, "pipppppppiiiiiipqiiipppip")
        rc = fn(_build.require(_LIB, rows, i32, "rows"), r,
                *_build.require_csr(_LIB, a, "a", values=True),
                *_build.require_csr(_LIB, b, "b", values=True),
                _build.require(_LIB, rownnz_b, i32, "rownnz_b"),
                a.nrows, rownnz_b.shape[0], int(max_deg_a), int(max_deg_b),
                f2, cap, scratch.data_ptr() if scratch is not None else None,
                ws, grid, threads, smem, col.data_ptr(), val.data_ptr(),
                row_nnz.data_ptr(), dev.index or 0, _build.stream_of(dev))
        _build.check(_LIB, rc)
        spgemm_numeric.launches += 1
    overflow = torch.clamp(row_nnz - cap, min=0).sum(dtype=torch.int32)
    return col, val, row_nnz, overflow


spgemm_numeric.launches = 0
