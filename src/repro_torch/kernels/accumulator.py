"""The accumulator routes' kernels: SPA (dense accumulator) and BIN
(propagation blocking), and the bitmask symbolic kernel they share.

Four wrappers, each launching its hand-written CUDA kernel on CUDA tensors
and running its plain tensor-op version on CPU tensors:

* :func:`fused_flop_symbolic_bitmask` (``csrc/bitmask_symbolic.cu``) →
  ``(z*, f*, FLOP per sampled row)``; replaces
  ``src/repro/kernels/accumulator.py::fused_flop_symbolic_bitmask_pallas``;
* :func:`bitmask_symbolic` (the second entry of the same source) →
  ``(z*, f*)``, f* the sum of the referenced B rows' untruncated lengths;
  replaces ``bitmask_symbolic_pallas``;
* :func:`spa_numeric` (``csrc/spa_numeric.cu``) → ``(col, val, row_nnz,
  overflow)``; replaces ``spa_numeric_pallas`` with the XLA-side
  ``core.spgemm.compact_dense``;
* :func:`bin_numeric` (``csrc/bin_numeric.cu``) → the same; replaces
  ``bin_numeric_pallas`` with ``compact_dense``.

Every route addresses a row's product columns relative to the row's
smallest one (:func:`extent_relative`), so the bitmask words and the dense
tiles cover the row's column extent, not B's column space: the lever that
makes SPA cheap on banded and FEM structure.  z* and f* equal the ESC
kernel's bit for bit, and ``col``, ``row_nnz`` and ``overflow`` equal ESC's;
``val`` agrees to float tolerance.  Both numeric kernels add each
column's products in a fixed order, so their ``val`` is bitwise the same
from run to run: BIN in its stable bins' order, SPA one product at a time
in A-entry order, whichever unit (a group of lanes or a block) takes the
row.  On the H100 all three are bound by bytes (see each source).
"""
from __future__ import annotations

import torch

from repro_torch.core.binning import ceil_pow2
from repro_torch.core.csr import COL_SENTINEL, CSRDevice, row_chunks
from repro_torch.core.predictor import count_distinct_dense, sampled_counts
from repro_torch.core.spgemm import (_bin_accumulate_block, blocked_rows,
                                     window_accumulate)
from . import _build
from .flop_per_row import flop_rows_plain

_SYM = "bitmask_symbolic"
_SPA = "spa_numeric"
_BIN = "bin_numeric"


def extent_relative(cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift each row's columns to its own minimum: ``(rel_cols, lo)``.

    THE relative-addressing contract of the SPA and BIN routes.  Sentinel
    padding stays sentinel; a row with no products keeps its sentinels and
    gets ``lo = 0``."""
    lo = cols.amin(dim=-1)                                # sentinel if empty
    rel = torch.where(cols == COL_SENTINEL, COL_SENTINEL, cols - lo[:, None])
    return rel, torch.where(lo == COL_SENTINEL, 0, lo)


def bitmask_distinct(cols: torch.Tensor, n_words: int) -> torch.Tensor:
    """Distinct non-sentinel columns per row of a sentinel-padded buffer,
    counted in a bitmask of ``n_words`` 32-bit words addressed relative to
    the row's smallest column: a column whose relative lane falls past the
    ``32·n_words`` lanes is not counted.  Plain version: one presence lane
    a bit, summed; rows in chunks that keep the lanes bounded."""
    lanes = 32 * int(n_words)
    out = [torch.zeros(0, dtype=torch.int32, device=cols.device)]
    for lo, hi in row_chunks(cols.shape[0], lanes + 1):
        rel, _ = extent_relative(cols[lo:hi])
        idx = torch.where(rel < lanes, rel, lanes).long()
        present = torch.zeros((hi - lo, lanes + 1), dtype=torch.bool,
                              device=cols.device).scatter_(1, idx, True)
        out.append(present[:, :lanes].sum(dim=1, dtype=torch.int32))
    return torch.cat(out)


# --------------------------------------------------------------------------- #
# Kernels 4 and 8: bitmask symbolic (SPA and BIN buckets; unfused)
# --------------------------------------------------------------------------- #
def _n_words(ncols_b: int, span: int) -> int:
    n = min(int(span), ncols_b) if span else ncols_b
    return -(-n // 32)


def fused_flop_symbolic_bitmask_plain(a: CSRDevice, b: CSRDevice,
                                      rows: torch.Tensor, *, max_deg_a: int,
                                      max_deg_b: int, span: int = 0,
                                      rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: gather and bitmask-count (z*), and
    Algorithm 1 over the same rows (FLOP per row and f* = its sum)."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    z, _ = sampled_counts(
        a, b, rows, max_deg_a, max_deg_b, rownnz_b,
        count=lambda cols: count_distinct_dense(cols, b.ncols, span))
    flop = flop_rows_plain(a, rownnz_b, rows, max_deg_a=max_deg_a)
    return z, flop.sum(dtype=torch.int32), flop


def fused_flop_symbolic_bitmask(a: CSRDevice, b: CSRDevice,
                                rows: torch.Tensor, *, max_deg_a: int,
                                max_deg_b: int, span: int = 0,
                                rownnz_b: torch.Tensor | None = None):
    """(z* int32, f* int32, FLOP per sampled row int32 (S,)) for ``rows`` at
    the bucket's degree bounds; ``span`` bounds the rows' product-column
    extent (0 → B's column space) and sizes the bitmask.  B's rows must be
    sorted (``validate_csr``), as every planned operand's are."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_SYM, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               rows)
    if dev is None:
        return fused_flop_symbolic_bitmask_plain(
            a, b, rows, max_deg_a=max_deg_a, max_deg_b=max_deg_b, span=span,
            rownnz_b=rownnz_b)
    s = rows.shape[0]
    z_rows = torch.empty(s, dtype=torch.int32, device=dev)
    flop = torch.empty(s, dtype=torch.int32, device=dev)
    if s:
        _bitmask_launch(None, a, b, rows, max_deg_a, max_deg_b, span,
                        rownnz_b, dev, z_rows, flop)
        fused_flop_symbolic_bitmask.launches += 1
    return (z_rows.sum(dtype=torch.int32), flop.sum(dtype=torch.int32), flop)


def bitmask_symbolic_plain(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                           *, max_deg_a: int, max_deg_b: int, span: int = 0,
                           rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: gather and bitmask-count (z*), and sum the
    referenced B rows' untruncated lengths (f*, Algorithm 1 over the
    rows)."""
    z, f, _ = fused_flop_symbolic_bitmask_plain(
        a, b, rows, max_deg_a=max_deg_a, max_deg_b=max_deg_b, span=span,
        rownnz_b=rownnz_b)
    return z, f


def bitmask_symbolic(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                     max_deg_a: int, max_deg_b: int, span: int = 0,
                     rownnz_b: torch.Tensor | None = None):
    """(z* int32, f* int32) for ``rows`` by bitmask popcount: z* equals the
    ESC count bit for bit while ``span`` covers the rows' extent, and f*
    sums the referenced B rows' untruncated lengths — unlike
    :func:`repro_torch.kernels.spgemm_symbolic.sampled_symbolic`, whose f*
    counts the products gathered at ``max_deg_b``, as in the JAX
    package."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_SYM, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               rows)
    if dev is None:
        return bitmask_symbolic_plain(a, b, rows, max_deg_a=max_deg_a,
                                      max_deg_b=max_deg_b, span=span,
                                      rownnz_b=rownnz_b)
    s = rows.shape[0]
    z_rows = torch.empty(s, dtype=torch.int32, device=dev)
    f_total = torch.zeros(1, dtype=torch.int32, device=dev)
    if s:
        _bitmask_launch("bitmask_symbolic_unfused", a, b, rows, max_deg_a,
                        max_deg_b, span, rownnz_b, dev, z_rows, f_total)
        bitmask_symbolic.launches += 1
    return z_rows.sum(dtype=torch.int32), f_total[0]


def _bitmask_launch(entry, a, b, rows, max_deg_a, max_deg_b, span,
                    rownnz_b, dev, z_rows, flop_out) -> None:
    """Launch an entry of ``csrc/bitmask_symbolic.cu`` over ``rows``."""
    _check_rownnz(_SYM, rownnz_b, b)
    s = rows.shape[0]
    n_words = _n_words(b.ncols, span)
    ws_bytes = _build.align16(4 * (max_deg_a + 1)) + 4 * n_words
    grid, threads, smem, scratch, slice_bytes = _build.block_workspace(
        _SYM, dev, ws_bytes,
        _build.row_threads(ceil_pow2(max_deg_a * max_deg_b)), s)
    fn = _build.launcher(_SYM, "pipppppiiiiipqiiippip", entry=entry)
    rc = fn(_build.require(_SYM, rows, torch.int32, "rows"), s,
            *_build.require_csr(_SYM, a, "a"),
            *_build.require_csr(_SYM, b, "b"),
            _build.require(_SYM, rownnz_b, torch.int32, "rownnz_b"),
            a.nrows, rownnz_b.shape[0], int(max_deg_a), int(max_deg_b),
            n_words, _ptr(scratch), slice_bytes, grid, threads, smem,
            z_rows.data_ptr(), flop_out.data_ptr(), dev.index or 0,
            _build.stream_of(dev))
    _build.check(_SYM, rc)


fused_flop_symbolic_bitmask.launches = 0
bitmask_symbolic.launches = 0


# --------------------------------------------------------------------------- #
# Kernels 5 and 6: SPA and BIN numeric, compaction fused in
# --------------------------------------------------------------------------- #
def spa_numeric_plain(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                      max_deg_a: int, max_deg_b: int, row_capacity: int,
                      tile_n: int, n_tiles: int):
    """Plain tensor-op version: gather, scatter-add into the
    ``n_tiles·tile_n``-lane extent-relative window with presence beside it,
    and compact (``core.spgemm.window_accumulate``)."""
    window = tile_n * n_tiles
    return tuple(blocked_rows(
        a, b, rows, row_capacity=row_capacity, max_deg_a=max_deg_a,
        max_deg_b=max_deg_b, window=window,
        accumulate=lambda c, v: window_accumulate(c, v, window,
                                                  row_capacity)))


def bin_numeric_plain(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                      max_deg_a: int, max_deg_b: int, row_capacity: int,
                      tile_n: int, n_tiles: int):
    """Plain tensor-op version: the window cut into ``n_tiles`` bins, each
    compacted on its own, the runs concatenated
    (``core.spgemm._bin_accumulate_block``)."""
    return tuple(blocked_rows(
        a, b, rows, row_capacity=row_capacity, max_deg_a=max_deg_a,
        max_deg_b=max_deg_b, window=tile_n * n_tiles,
        accumulate=lambda c, v: _bin_accumulate_block(
            c, v, row_capacity, tile_n, n_tiles)))


def spa_numeric(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                max_deg_a: int, max_deg_b: int, row_capacity: int,
                tile_n: int, n_tiles: int,
                rownnz_b: torch.Tensor | None = None):
    """(col int32 (R, cap), val float32 (R, cap), row_nnz int32 (R,),
    overflow int32) for ``rows`` through a dense accumulator of ``n_tiles``
    tiles of ``tile_n`` lanes (a power of two ≥ 128) relative to each row's
    smallest product column.  B's rows must be sorted; a row that repeats
    a column has the repeats added one at a time."""
    return _numeric(_SPA, spa_numeric, spa_numeric_plain, a, b, rows,
                    max_deg_a, max_deg_b, row_capacity, tile_n, n_tiles,
                    rownnz_b)


def bin_numeric(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                max_deg_a: int, max_deg_b: int, row_capacity: int,
                tile_n: int, n_tiles: int,
                rownnz_b: torch.Tensor | None = None,
                max_row_flop: int | None = None):
    """As :func:`spa_numeric`, by propagation blocking: each row's products
    are gathered once and scattered, stably, into ``n_tiles`` bins of
    ``tile_n`` columns, and the bins are reduced densely, in parallel.
    ``max_row_flop`` bounds each row's products and sizes the pair buffer,
    as in :func:`repro_torch.kernels.spgemm_numeric.spgemm_numeric`."""
    return _numeric(_BIN, bin_numeric, bin_numeric_plain, a, b, rows,
                    max_deg_a, max_deg_b, row_capacity, tile_n, n_tiles,
                    rownnz_b, max_row_flop)


spa_numeric.launches = 0
bin_numeric.launches = 0


def _numeric(lib, wrapper, plain, a, b, rows, max_deg_a, max_deg_b,
             row_capacity, tile_n, n_tiles, rownnz_b, max_row_flop=None):
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(lib, a.rpt, a.col, a.val, b.rpt, b.col,
                               b.val, rownnz_b, rows)
    if dev is None:
        return plain(a, b, rows, max_deg_a=max_deg_a, max_deg_b=max_deg_b,
                     row_capacity=row_capacity, tile_n=tile_n,
                     n_tiles=n_tiles)
    tile_n, n_tiles = int(tile_n), int(n_tiles)
    if tile_n < 128 or tile_n & (tile_n - 1) or n_tiles < 1:
        raise RuntimeError(f"{lib}: tiles must be a power of two of at least "
                           f"128 lanes, got {n_tiles} of {tile_n}")
    if lib == _BIN and tile_n > 1024:
        # a warp compacts its bin's tile 32 lanes at a time, a word a lane
        raise RuntimeError(f"{lib}: bins are at most 1024 columns wide, got "
                           f"{tile_n}")
    r = rows.shape[0]
    cap = int(row_capacity)
    col = torch.empty((r, cap), dtype=torch.int32, device=dev)
    val = torch.empty((r, cap), dtype=torch.float32, device=dev)
    row_nnz = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        _check_rownnz(lib, rownnz_b, b)
        args = (_build.require(lib, rows, torch.int32, "rows"), r,
                *_build.require_csr(lib, a, "a", values=True),
                *_build.require_csr(lib, b, "b", values=True),
                _build.require(lib, rownnz_b, torch.int32, "rownnz_b"),
                a.nrows, rownnz_b.shape[0], int(max_deg_a), int(max_deg_b),
                tile_n, n_tiles, cap)
        if lib == _SPA:
            shape = _build.spa_numeric_shape(
                _build.max_smem(lib, dev), int(max_deg_a), int(max_deg_b),
                tile_n, r, _build.sm_count(dev))
            grid, scratch = -(-r // shape.units), None
            if shape.slice_bytes:
                grid, scratch = _build.scratch_slices(
                    dev, shape.units * shape.slice_bytes, grid)
            ctl = torch.empty(1, dtype=torch.int32, device=dev)
            fn = _build.launcher(lib, "pipppppppiiiiiiiipqiiippppip")
            rc = fn(*args, shape.group, _ptr(scratch), shape.unit_bytes,
                    grid, shape.threads, shape.smem_bytes, col.data_ptr(),
                    val.data_ptr(), row_nnz.data_ptr(), ctl.data_ptr(),
                    dev.index or 0, _build.stream_of(dev))
            overflow = ctl[0]
        else:
            static = int(max_deg_a) * int(max_deg_b)
            bound = static if max_row_flop is None else min(
                static, int(max_row_flop))
            shape = _build.bin_numeric_shape(_build.max_smem(lib, dev),
                                             int(max_deg_a), bound, tile_n,
                                             n_tiles)
            (launch,) = shape.launches
            grid, scratch = r, None
            if shape.slice_bytes:
                grid, scratch = _build.scratch_slices(dev, shape.slice_bytes,
                                                      r)
            # the spill lock and the entries dropped for capacity, then
            # (for rows past the bound) one spill slice of the degree
            # bounds' pairs, taken under the lock
            ctl = torch.empty(4 + (2 * static if bound < static else 0),
                              dtype=torch.int32, device=dev)
            fn = _build.launcher(lib, "pipppppppiiiiiiiipqqppiiipppip")
            rc = fn(*args, launch.smem_pairs, _ptr(scratch),
                    shape.slice_bytes, shape.slice_pairs,
                    ctl[4:].data_ptr() if bound < static else None,
                    ctl.data_ptr(), grid, launch.threads, launch.smem_bytes,
                    col.data_ptr(),
                    val.data_ptr(), row_nnz.data_ptr(), dev.index or 0,
                    _build.stream_of(dev))
            overflow = ctl[1]
        _build.check(lib, rc)
        wrapper.launches += 1
    if not r:
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
    return col, val, row_nnz, overflow


def _check_rownnz(lib: str, rownnz_b: torch.Tensor, b: CSRDevice) -> None:
    if rownnz_b.shape[0] != b.nrows:
        raise RuntimeError(f"{lib}: rownnz_b has {rownnz_b.shape[0]} "
                           f"entries for {b.nrows} rows of B")


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None
