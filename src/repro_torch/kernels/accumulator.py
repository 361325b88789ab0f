"""The accumulator routes' kernels: SPA (dense accumulator) and BIN
(propagation blocking), and the bitmask symbolic kernel they share.

Six wrappers, each launching its hand-written CUDA kernel on CUDA tensors
and running its plain tensor-op version on CPU tensors:

* :func:`fused_flop_symbolic_bitmask` (``csrc/bitmask_symbolic.cu``) →
  ``(z*, f*, FLOP per sampled row)`` at one bucket's bounds; replaces
  ``src/repro/kernels/accumulator.py::fused_flop_symbolic_bitmask_pallas``;
* :func:`fused_flop_symbolic_bitmask_buckets`: the same outputs for every
  SPA and BIN sample of a binned prediction in one launch, each row at its
  own bucket's bounds (a :class:`BitmaskTable`) — what the TPU kernel
  gives bucket by bucket;
* :func:`exact_row_counts_bitmask`: the same launch over every row of a SPA
  or BIN bucket in its per-row count mode → each row's distinct columns,
  the re-planning loop's exact-symbolic fallback (counted outside Pallas
  in the JAX package);
* :func:`bitmask_symbolic` (the same kernel at the global bounds) →
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

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.csr import COL_SENTINEL, CSRDevice, row_chunks
from repro_torch.core.predictor import distinct_per_row, sampled_counts
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
    return _bitmask_plain(a, b, rows, max_deg_a, max_deg_b,
                          _n_words(b.ncols, span), rownnz_b)


def _bitmask_plain(a, b, rows, max_deg_a, max_deg_b, n_words, rownnz_b):
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    z, _ = sampled_counts(a, b, rows, max_deg_a, max_deg_b, rownnz_b,
                          count=lambda cols: bitmask_distinct(cols, n_words))
    flop = flop_rows_plain(a, rownnz_b, rows, max_deg_a=max_deg_a)
    return z, flop.sum(dtype=torch.int32), flop


def fused_flop_symbolic_bitmask(a: CSRDevice, b: CSRDevice,
                                rows: torch.Tensor, *, max_deg_a: int,
                                max_deg_b: int, span: int = 0,
                                rownnz_b: torch.Tensor | None = None):
    """(z* int32, f* int32, FLOP per sampled row int32 (S,)) for ``rows`` at
    the bucket's degree bounds; ``span`` bounds the rows' product-column
    extent (0 → B's column space) and sizes the bitmask.  B's rows must be
    sorted (``validate_csr``), as every planned operand's are.  One launch,
    each row on a warp or a block by its own products (decided on the
    card)."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_SYM, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               rows)
    if dev is None:
        return fused_flop_symbolic_bitmask_plain(
            a, b, rows, max_deg_a=max_deg_a, max_deg_b=max_deg_b, span=span,
            rownnz_b=rownnz_b)
    if not rows.shape[0]:
        return _empty_counts(dev)
    out = _bitmask_dual(a, b, rows, max_deg_a, max_deg_b,
                        _n_words(b.ncols, span), rownnz_b, dev, fused=True)
    fused_flop_symbolic_bitmask.launches += 1
    return out


class BitmaskTable(NamedTuple):
    """The sampled rows of one :func:`fused_flop_symbolic_bitmask_buckets`
    launch, on one device (built by :func:`bitmask_table`), long rows
    first, and the host-side bounds that size the launch."""

    samples: torch.Tensor   # int32 (5, S): each sample's row of A, its
    #                         bucket's deg_a, deg_b and mask words, and its
    #                         place in the caller's order
    n_long: int             # the first n_long rows take a block each
    words: int              # most mask words of a sample (0: none)
    max_deg_a: int          # largest deg_a of a sample


def bitmask_table(rows, deg_a, deg_b, n_words, row_flop,
                  device) -> BitmaskTable:
    """:class:`BitmaskTable` of the sampled ``rows`` (host int arrays, one
    entry a sample, duplicates kept) at their buckets' bounds ``deg_a``,
    ``deg_b`` and mask words ``n_words``, with ``row_flop`` each row's FLOP
    at ``deg_a`` or a bound on it (Algorithm 1's floprC does).  A row whose
    products, at most ``min(row_flop, deg_a·deg_b)``, pass a warp's
    :data:`_build.BMS_WARP_MAX` goes first, to a block; the rest to a warp
    each (one past the FLOP it was given is handed on to a block on the
    card).  One upload to ``device``."""
    rows = np.asarray(rows, dtype=np.int32)
    deg_a = np.asarray(deg_a, dtype=np.int32)
    deg_b = np.asarray(deg_b, dtype=np.int32)
    n_words = np.asarray(n_words, dtype=np.int32)
    bound = np.minimum(np.asarray(row_flop, dtype=np.int64),
                       deg_a.astype(np.int64) * deg_b)
    long = bound > _build.BMS_WARP_MAX
    order = np.argsort(~long, kind="stable")
    packed = np.stack([rows, deg_a, deg_b, n_words,
                       np.arange(rows.size, dtype=np.int32)])
    samples = torch.from_numpy(np.ascontiguousarray(packed[:, order]))
    peak = lambda x: int(x.max()) if x.size else 0
    return BitmaskTable(samples.to(device), n_long=int(long.sum()),
                        words=peak(n_words), max_deg_a=peak(deg_a))


def fused_flop_symbolic_bitmask_buckets_plain(
        a: CSRDevice, b: CSRDevice, table: BitmaskTable, *,
        rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: the per-bucket plain version over the rows
    of each ``(deg_a, deg_b, n_words)`` triple, the FLOP put back in the
    caller's order."""
    rows, deg_a, deg_b, n_words, out = table.samples
    flop = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    z = torch.zeros((), dtype=torch.int32, device=rows.device)
    for da, db, nw in sorted(set(map(tuple,
                                     table.samples[1:4].T.tolist()))):
        sel = torch.nonzero((deg_a == da) & (deg_b == db)
                            & (n_words == nw))[:, 0]
        zb, _, fl = _bitmask_plain(a, b, rows[sel], da, db, nw, rownnz_b)
        z = z + zb
        flop[out[sel].long()] = fl
    return z, flop.sum(dtype=torch.int32), flop


def fused_flop_symbolic_bitmask_buckets(a: CSRDevice, b: CSRDevice,
                                        table: BitmaskTable, *,
                                        rownnz_b: torch.Tensor | None = None):
    """(z* int32, f* int32, FLOP per sample int32 (S,), in the caller's
    order) for the table's rows, each at its own bucket's bounds and mask
    words, in one launch: every SPA and BIN sample of a binned prediction
    (``predictor.bitmask_sample_table``)."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_SYM, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               table.samples)
    if dev is None:
        return fused_flop_symbolic_bitmask_buckets_plain(a, b, table,
                                                         rownnz_b=rownnz_b)
    s = table.samples.shape[1]
    if not s:
        return _empty_counts(dev)
    out = _bitmask_launch(a, b, rownnz_b, dev, _table_ptrs(table), s,
                          table.n_long, 0, 0, 0, table.words,
                          table.max_deg_a, fused=True)
    fused_flop_symbolic_bitmask_buckets.launches += 1
    return out


def _table_ptrs(table: BitmaskTable) -> list:
    samples = table.samples
    if (samples.dim() != 2 or samples.shape[0] != 5
            or samples.dtype != torch.int32 or not samples.is_contiguous()):
        raise RuntimeError(f"{_SYM}: samples must be a contiguous (5, S) "
                           f"int32 tensor")
    s = samples.shape[1]
    return [samples.data_ptr() + 4 * s * k for k in range(5)]


def exact_row_counts_bitmask_plain(a: CSRDevice, b: CSRDevice,
                                   table: BitmaskTable, *,
                                   rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: gather and bitmask-count each row over the
    rows of each ``(deg_a, deg_b, n_words)`` triple
    (``predictor.distinct_per_row``), the counts put back in the caller's
    order."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    rows, deg_a, deg_b, n_words, out = table.samples
    z = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    for da, db, nw in sorted(set(map(tuple,
                                     table.samples[1:4].T.tolist()))):
        sel = torch.nonzero((deg_a == da) & (deg_b == db)
                            & (n_words == nw))[:, 0]
        z[out[sel].long()] = distinct_per_row(
            a, b, rows[sel], da, db, rownnz_b,
            lambda cols, nw=nw: bitmask_distinct(cols, nw))
    return z


def exact_row_counts_bitmask(a: CSRDevice, b: CSRDevice,
                             table: BitmaskTable, *,
                             rownnz_b: torch.Tensor | None = None):
    """Each listed row's distinct product columns, int32 ``(S,)`` in the
    caller's order, at its own bounds and mask words: kernel 4's launch of
    :func:`fused_flop_symbolic_bitmask_buckets` in its per-row count mode,
    over every row of a SPA or BIN bucket (the re-planning loop's
    exact-symbolic fallback, ``predictor.exact_row_counts``) instead of a
    sample."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_SYM, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               table.samples)
    if dev is None:
        return exact_row_counts_bitmask_plain(a, b, table, rownnz_b=rownnz_b)
    s = table.samples.shape[1]
    z = torch.empty(s, dtype=torch.int32, device=dev)
    if not s:
        return z
    _bitmask_launch(a, b, rownnz_b, dev, _table_ptrs(table), s, table.n_long,
                    0, 0, 0, table.words, table.max_deg_a, fused=True,
                    z_out=z)
    exact_row_counts_bitmask.launches += 1
    return z


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
    package.  One launch; each row takes a warp or a block by its own
    products, decided on the card, with nothing read back."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_SYM, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               rows)
    if dev is None:
        return bitmask_symbolic_plain(a, b, rows, max_deg_a=max_deg_a,
                                      max_deg_b=max_deg_b, span=span,
                                      rownnz_b=rownnz_b)
    if not rows.shape[0]:
        return _empty_counts(dev)[:2]
    out = _bitmask_dual(a, b, rows, max_deg_a, max_deg_b,
                        _n_words(b.ncols, span), rownnz_b, dev, fused=False)
    bitmask_symbolic.launches += 1
    return out[:2]


def _bitmask_dual(a, b, rows, max_deg_a, max_deg_b, n_words, rownnz_b, dev,
                  fused):
    """One launch over ``rows`` at one pair of bounds, the rows as given:
    each takes a block when ``max_deg_a·max_deg_b`` passes a warp's
    products, else a warp, and the row's own products, counted on the
    card, decide whether one warp or the whole block counts it."""
    s = rows.shape[0]
    n_long = s if int(max_deg_a) * int(max_deg_b) > _build.BMS_WARP_MAX \
        else 0
    return _bitmask_launch(
        a, b, rownnz_b, dev,
        [_build.require(_SYM, rows, torch.int32, "rows"), None, None, None,
         None], s, n_long, max_deg_a, max_deg_b, n_words, n_words,
        max_deg_a, fused)


def _bitmask_launch(a, b, rownnz_b, dev, ptrs, s, n_long, max_deg_a,
                    max_deg_b, n_words, words, table_deg_a, fused,
                    z_out=None):
    """One launch of ``csrc/bitmask_symbolic.cu`` over ``s`` samples
    (``ptrs``: rows, then the table's deg_a, deg_b, n_words and output slot,
    or None each for the launch's bounds), the first ``n_long`` long.
    Returns ``(z*, f*, FLOP per sample)``, int32 views of one buffer the
    kernel fills (no FLOP without ``fused``); with ``z_out`` (int32
    ``(s,)``) the kernel also writes each sample's distinct columns there,
    in its output slot (the per-row count mode)."""
    _check_rownnz(_SYM, rownnz_b, b)
    res = torch.empty(2 + (s if fused else 0), dtype=torch.int32,
                      device=dev)
    # the other rows go to group blocks spread over the SMs, a block an SM,
    # up to BMS_WARPS rows a block
    short_rows = s - n_long
    warp_rows = min(_build.BMS_WARPS,
                    max(1, -(-short_rows // _build.sm_count(dev))))
    shape = _build.bitmask_shape(_build.max_smem(_SYM, dev), n_long,
                                 -(-short_rows // warp_rows), words,
                                 table_deg_a)
    scratch = (torch.empty((shape.long_blocks + shape.group_blocks)
                           * shape.slice_bytes, dtype=torch.uint8,
                           device=dev)
               if shape.slice_bytes else None)
    fn = _build.launcher(_SYM, "pppppiiiiiiiiipppppiiipqipppip")
    rc = fn(*ptrs, s, n_long, shape.long_blocks, warp_rows,
            shape.group_blocks, int(max_deg_a), int(max_deg_b), int(n_words),
            int(table_deg_a), *_build.require_csr(_SYM, a, "a"),
            *_build.require_csr(_SYM, b, "b"),
            _build.require(_SYM, rownnz_b, torch.int32, "rownnz_b"),
            a.nrows, rownnz_b.shape[0], shape.smem_words, _ptr(scratch),
            shape.slice_bytes, shape.smem_bytes, res.data_ptr(),
            res.data_ptr() + 8 if fused else None,
            None if z_out is None else _build.require(_SYM, z_out,
                                                      torch.int32, "z_out"),
            dev.index or 0, _build.stream_of(dev))
    _build.check(_SYM, rc)
    return res[0], res[1], res[2:]


def _empty_counts(dev):
    zero = torch.zeros(2, dtype=torch.int32, device=dev)
    return zero[0], zero[1], zero[2:]


fused_flop_symbolic_bitmask.launches = 0
fused_flop_symbolic_bitmask_buckets.launches = 0
exact_row_counts_bitmask.launches = 0
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
