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
product gathered) and the output slots (8 bytes each).  Its unit of work
follows each row's product count: a warp sorts a short row in its own
shared memory, a block takes a long one, adding a narrow-extent row's
products into dense per-warp partial rows and sorting any other row's in
shared memory where its own pairs fit, else in a global scratch slice.
The workspaces are sized by ``max_row_flop``, a bound on the launched rows'
products passed with each call (the plan passes its rows' largest FLOP), so
the uncompacted ``(R, next_pow2(DA·DB))`` buffers of the TPU kernel never
exist.  Each row's sums are taken in a fixed order: ``val`` is bitwise the
same from run to run.
"""
from __future__ import annotations

import torch

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
                   rownnz_b: torch.Tensor | None = None,
                   max_row_flop: int | None = None):
    """(col int32 (R, cap), val float32 (R, cap), row_nnz int32 (R,),
    overflow int32) for ``rows`` at the bucket's degree bounds.

    ``max_row_flop`` bounds each listed row's products (Algorithm 1's FLOP
    of the rows does) and sizes the kernel's workspaces; without it they
    cover ``max_deg_a·max_deg_b`` products.  A row past the bound still
    runs, in a spill slice of that size, one such row at a time.  B's rows
    must be sorted with distinct columns (``validate_csr``), as every
    planned operand's are."""
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
    i32 = torch.int32
    if rownnz_b.shape[0] != b.nrows:
        raise RuntimeError(f"{_LIB}: rownnz_b has {rownnz_b.shape[0]} "
                           f"entries for {b.nrows} rows of B")
    static = int(max_deg_a) * int(max_deg_b)
    bound = static if max_row_flop is None else min(static, int(max_row_flop))
    # one allocation a call (the launch's host cost is what small buckets
    # pay): col, val, row_nnz, then the kernel's control words and row
    # lists, then (for rows past the bound) the spill slice of the degree
    # bounds' pairs
    spill = 2 * static if bound < static else 0
    buf = torch.empty(2 * r * cap + 3 * r + 8 + spill, dtype=i32, device=dev)
    col = buf[:r * cap].view(r, cap)
    val = buf[r * cap:2 * r * cap].view(torch.float32).view(r, cap)
    row_nnz = buf[2 * r * cap:2 * r * cap + r]
    ctl = buf[2 * r * cap + r:]
    if not r:
        return col, val, row_nnz, torch.zeros((), dtype=i32, device=dev)
    shape = _build.esc_numeric_shape(_build.max_smem(_LIB, dev),
                                     int(max_deg_a), bound)
    # the block launches pull the rows past warp_pairs from lists; with a
    # true bound there are none when it is that small (no block launch: the
    # warps spill any row past it), and none past mid_pairs without a
    # second launch
    grid = r if bound > shape.warp_pairs else 0
    scratch = None
    if shape.slice_bytes:
        grid, scratch = _build.scratch_slices(dev, shape.slice_bytes, grid)
    base = buf.data_ptr()       # col, val, row_nnz, ctl and spill follow
    mid = shape.launches[0]
    long_ = shape.launches[1] if len(shape.launches) > 1 else None
    fn = _build.launcher(_LIB, "pipppppppiiiiiiiiiiiiiiiiiiiipqqpppppip")
    rc = fn(_build.require(_LIB, rows, i32, "rows"), r,
            *_build.require_csr(_LIB, a, "a", values=True),
            *_build.require_csr(_LIB, b, "b", values=True),
            _build.require(_LIB, rownnz_b, i32, "rownnz_b"),
            a.nrows, rownnz_b.shape[0], int(max_deg_a), int(max_deg_b), cap,
            shape.group, shape.warp_pairs, shape.mid_pairs, mid.threads,
            grid, mid.tile_n,
            mid.bins, mid.smem_bytes, mid.smem_pairs,
            *((long_.threads, grid, long_.tile_n, long_.bins,
               long_.smem_bytes, long_.smem_pairs) if long_
              else (0, 0, 0, 0, 0, 0)),
            _ptr(scratch), shape.slice_bytes, shape.slice_pairs,
            base + 4 * (2 * r * cap + 3 * r + 8) if spill else None,
            base + 4 * (2 * r * cap + r), base, base + 4 * r * cap,
            base + 8 * r * cap, dev.index or 0, _build.stream_of(dev))
    _build.check(_LIB, rc)
    spgemm_numeric.launches += 1
    return col, val, row_nnz, ctl[3]


spgemm_numeric.launches = 0


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None
