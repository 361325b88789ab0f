"""Fused Algorithm 1 + Algorithm 2 (ESC symbolic) for one bucket's sampled rows.

``fused_flop_symbolic`` launches the hand-written CUDA kernel
``csrc/esc_symbolic.cu`` on CUDA tensors and runs
:func:`fused_flop_symbolic_plain` on CPU tensors.  It returns
``(z*, f*, flop per sampled row)``: the sampled distinct-column count, the
sampled product count and Algorithm 1's FLOP of each sampled row.

Replaces ``src/repro/kernels/spgemm_symbolic.py::fused_flop_symbolic_pallas``
(``_fused_kernel``).  On the H100 the kernel is bound by bytes: one thread
block per sampled row gathers the row's product columns (4 bytes each from
B, plus A's row and B's row lengths) and sorts them in shared memory; only
rows too wide for the 227 KB opt-in limit sort in a global scratch slice.
Each row's z and FLOP are written separately and summed here, so z* and f*
are exact integers with no atomics.
"""
from __future__ import annotations

import torch

from repro_torch.core.binning import ceil_pow2
from repro_torch.core.csr import CSRDevice
from repro_torch.core.predictor import sampled_counts
from . import _build
from .flop_per_row import flop_rows_plain

_LIB = "esc_symbolic"


def fused_flop_symbolic_plain(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                              *, max_deg_a: int, max_deg_b: int,
                              rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: gather, sort and count (z*), and Algorithm 1
    over the same rows (FLOP per row and f* = its sum)."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    z, _ = sampled_counts(a, b, rows, max_deg_a, max_deg_b, rownnz_b)
    flop = flop_rows_plain(a, rownnz_b, rows, max_deg_a=max_deg_a)
    return z, flop.sum(dtype=torch.int32), flop


def fused_flop_symbolic(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                        max_deg_a: int, max_deg_b: int,
                        rownnz_b: torch.Tensor | None = None):
    """(z* int32, f* int32, FLOP per sampled row int32 (S,)) for ``rows`` at
    the bucket's degree bounds."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_LIB, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               rows)
    if dev is None:
        return fused_flop_symbolic_plain(a, b, rows, max_deg_a=max_deg_a,
                                         max_deg_b=max_deg_b,
                                         rownnz_b=rownnz_b)
    s = rows.shape[0]
    z_rows = torch.empty(s, dtype=torch.int32, device=dev)
    flop = torch.empty(s, dtype=torch.int32, device=dev)
    if s:
        i32 = torch.int32
        if rownnz_b.shape[0] != b.nrows:
            raise RuntimeError(f"{_LIB}: rownnz_b has {rownnz_b.shape[0]} "
                               f"entries for {b.nrows} rows of B")
        f2 = ceil_pow2(max_deg_a * max_deg_b)
        ws, grid, threads, smem, scratch = _build.row_workspace(
            _LIB, dev, max_deg_a, f2, 4, s)          # keys: 4 bytes a lane
        fn = _build.launcher(_LIB, "pipppppiiiipqiiippip")
        rc = fn(_build.require(_LIB, rows, i32, "rows"), s,
                *_build.require_csr(_LIB, a, "a"),
                *_build.require_csr(_LIB, b, "b"),
                _build.require(_LIB, rownnz_b, i32, "rownnz_b"),
                a.nrows, rownnz_b.shape[0], int(max_deg_a), int(max_deg_b),
                scratch.data_ptr() if scratch is not None else None, ws,
                grid, threads, smem, z_rows.data_ptr(), flop.data_ptr(),
                dev.index or 0, _build.stream_of(dev))
        _build.check(_LIB, rc)
        fused_flop_symbolic.launches += 1
    return (z_rows.sum(dtype=torch.int32), flop.sum(dtype=torch.int32), flop)


fused_flop_symbolic.launches = 0
