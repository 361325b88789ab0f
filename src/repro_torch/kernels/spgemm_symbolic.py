"""Algorithm 2 (ESC symbolic) over sampled rows: the fused per-bucket
kernel and the unfused global-pad one.

Two wrappers, each launching its hand-written CUDA kernel on CUDA tensors
and running its plain version on CPU tensors:

* :func:`fused_flop_symbolic` (``csrc/esc_symbolic.cu``) → ``(z*, f*,
  flop per sampled row)``: the sampled distinct-column count, the sampled
  FLOP and Algorithm 1's FLOP of each sampled row, at one bucket's degree
  bounds.  Replaces
  ``src/repro/kernels/spgemm_symbolic.py::fused_flop_symbolic_pallas``
  (``_fused_kernel``);
* :func:`sampled_symbolic` (``csrc/sampled_symbolic.cu``) → ``(z*, f*)``
  with f* the count of *gathered* products (each B row read to at most
  ``max_deg_b`` entries), at the global degree bounds of the paper's
  predictor.  Replaces ``sampled_symbolic_pallas`` (``_kernel``).

On the H100 both are bound by bytes: one thread block per sampled row
gathers the row's product columns (4 bytes each from B, plus A's row and
B's row lengths) and sorts them in shared memory; only rows too wide for
the 227 KB opt-in limit sort in a global scratch slice.  Each row's counts
are written separately and summed here, so z* and f* are exact integers
with no atomics.
"""
from __future__ import annotations

import torch

from repro_torch.core.binning import ceil_pow2
from repro_torch.core.csr import CSRDevice
from repro_torch.core.predictor import sampled_counts
from . import _build
from .flop_per_row import flop_rows_plain

_LIB = "esc_symbolic"
_SAMPLED = "sampled_symbolic"


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


def sampled_symbolic_plain(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                           *, max_deg_a: int, max_deg_b: int,
                           rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: gather, sort and count (z*), and count the
    gathered products (f*)."""
    return sampled_counts(a, b, rows, max_deg_a, max_deg_b, rownnz_b)


def sampled_symbolic(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                     max_deg_a: int, max_deg_b: int,
                     rownnz_b: torch.Tensor | None = None,
                     row_flop: torch.Tensor | None = None):
    """(z* int32, f* int32) for ``rows`` at the given degree bounds, f* the
    gathered products.

    ``row_flop`` (int32 (S,), optional) bounds each sampled row's gathered
    products — Algorithm 1's FLOP of the rows at ``max_deg_a`` does — and
    sizes the workspace from the widest of them; without it the workspace
    covers ``max_deg_a·max_deg_b`` products.  Either way a row sorts in
    shared memory whenever it fits there."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_SAMPLED, a.rpt, a.col, b.rpt, b.col,
                               rownnz_b, rows)
    if dev is None:
        return sampled_symbolic_plain(a, b, rows, max_deg_a=max_deg_a,
                                      max_deg_b=max_deg_b, rownnz_b=rownnz_b)
    s = rows.shape[0]
    z_rows = torch.empty(s, dtype=torch.int32, device=dev)
    f_rows = torch.empty(s, dtype=torch.int32, device=dev)
    if s:
        i32 = torch.int32
        if rownnz_b.shape[0] != b.nrows:
            raise RuntimeError(f"{_SAMPLED}: rownnz_b has "
                               f"{rownnz_b.shape[0]} entries for {b.nrows} "
                               f"rows of B")
        bound = max_deg_a * max_deg_b
        if row_flop is not None:
            bound = min(bound, int(row_flop.max()))
        smem_lanes, grid, threads, smem, scratch, slice_bytes = \
            _build.sort_workspace(_SAMPLED, dev, max_deg_a,
                                  ceil_pow2(max(1, bound)), s)
        fn = _build.launcher(_SAMPLED, "pipppppiiiiipqiiippip")
        rc = fn(_build.require(_SAMPLED, rows, i32, "rows"), s,
                *_build.require_csr(_SAMPLED, a, "a"),
                *_build.require_csr(_SAMPLED, b, "b"),
                _build.require(_SAMPLED, rownnz_b, i32, "rownnz_b"),
                a.nrows, rownnz_b.shape[0], int(max_deg_a), int(max_deg_b),
                smem_lanes,
                scratch.data_ptr() if scratch is not None else None,
                slice_bytes, grid, threads, smem, z_rows.data_ptr(),
                f_rows.data_ptr(), dev.index or 0, _build.stream_of(dev))
        _build.check(_SAMPLED, rc)
        sampled_symbolic.launches += 1
    return z_rows.sum(dtype=torch.int32), f_rows.sum(dtype=torch.int32)


sampled_symbolic.launches = 0
