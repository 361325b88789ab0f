"""Numeric SpGEMM on device (torch), allocated from the paper's prediction.

Three accumulator routes (DESIGN.md §5, §11), one output contract:

* ESC (expand, sort, compress): expand each row's products into a buffer,
  sort them by column carrying values and sum each run of equal columns;
* SPA (dense accumulator): scatter-add the value products into a dense
  window addressed relative to the row's smallest product column, with
  presence tracked apart from value (a sum that cancels to 0.0 is still an
  entry), and compact the window (:func:`compact_dense`);
* BIN (propagation blocking): the same window cut into ``n_tiles`` bins of
  ``tile_n`` columns, each compacted on its own, the runs concatenated.

Each writes a row's distinct columns in ascending order into its predicted
``row_capacity`` slots, so ``col``, ``row_nnz`` and ``overflow`` agree across
routes and ``val`` to float tolerance.  A row's true nnz survives
truncation, so overflow (a row whose true nnz exceeds its capacity) is
counted and returned — the caller re-plans.

With ``use_kernel`` a bucket runs through the port's hand-written CUDA
kernel for its route (``repro_torch.kernels.ops``); without it, and always on
a CPU tensor, the plain tensor-op versions below run.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .binning import ROUTE_BIN, ROUTE_SPA, ceil_pow2
from .csr import COL_SENTINEL, CSRDevice, expand_products, row_chunks
from .flop import flop_per_row


class SpGEMMOut(NamedTuple):
    col: torch.Tensor       # (M, row_capacity) int32, COL_SENTINEL padded
    val: torch.Tensor       # (M, row_capacity) float32
    row_nnz: torch.Tensor   # (M,) int32 — true nnz per row (may exceed capacity)
    overflow: torch.Tensor  # scalar int32 — total entries dropped for capacity


def gather_products(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                    max_deg_a: int, max_deg_b: int,
                    rownnz_b: torch.Tensor | None = None):
    """Columns AND value-products of all intermediate products of ``rows``
    (value-carrying view of :func:`repro_torch.core.csr.expand_products`)."""
    return expand_products(a, b, rows, max_deg_a, max_deg_b,
                           rownnz_b=rownnz_b, with_values=True)


def _accumulate_block(cols: torch.Tensor, vals: torch.Tensor,
                      row_capacity: int):
    """Sort-merge accumulation for one block of rows → (col, val, row_nnz,
    overflow)."""
    c_s, order = torch.sort(cols, dim=-1, stable=True)
    v_s = torch.gather(vals, -1, order)
    valid = c_s != COL_SENTINEL
    newseg = torch.cat(
        [valid[:, :1], (c_s[:, 1:] != c_s[:, :-1]) & valid[:, 1:]], dim=-1)
    seg = torch.cumsum(newseg.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    row_nnz = seg[:, -1] + 1
    # invalid or overflowing slots land in one spill column, cut off below
    seg_sc = torch.where(valid & (seg < row_capacity), seg,
                         row_capacity).long()
    bs = cols.shape[0]
    out_val = torch.zeros((bs, row_capacity + 1), dtype=torch.float32,
                          device=cols.device).scatter_add_(1, seg_sc, v_s)
    out_col = torch.full((bs, row_capacity + 1), COL_SENTINEL,
                         dtype=torch.int32, device=cols.device).scatter_reduce_(
        1, seg_sc, c_s, reduce="amin")
    overflow = torch.clamp(row_nnz - row_capacity, min=0).sum(dtype=torch.int32)
    return (out_col[:, :row_capacity], out_val[:, :row_capacity],
            row_nnz.to(torch.int32), overflow)


def dense_window(cols: torch.Tensor, vals: torch.Tensor, window: int):
    """Scatter-add one block's value products into a dense ``(bs, window)``
    accumulator addressed relative to each row's smallest product column:
    ``(acc, present, lo)``, the output contract of the TPU's SPA and BIN
    kernels.  Products past the window are dropped."""
    from repro_torch.kernels.accumulator import extent_relative
    rel, lo = extent_relative(cols)
    inside = rel < window                   # the sentinel never is
    idx = torch.where(inside, rel, window).long()
    bs = cols.shape[0]
    acc = torch.zeros((bs, window + 1), dtype=torch.float32,
                      device=cols.device).scatter_add_(
        1, idx, torch.where(inside, vals, 0.0))
    present = torch.zeros((bs, window + 1), dtype=torch.bool,
                          device=cols.device).scatter_(1, idx, True)
    return acc[:, :window], present[:, :window], lo


def compact_dense(acc: torch.Tensor, present: torch.Tensor,
                  row_capacity: int, col_offset: torch.Tensor | None = None):
    """Dense accumulator (+ presence mask) → predicted-capacity buffers
    ``(col, val, row_nnz, overflow)``: ascending columns, ``row_nnz`` the
    structural count (may exceed the capacity), slots past the capacity
    dropped — the same structure as the ESC compaction.  ``col_offset``
    (per-row int32) restores absolute column ids of an extent-relative
    window."""
    bs, n = acc.shape
    seg = torch.cumsum(present, dim=-1, dtype=torch.int32) - 1
    keep = present & (seg < row_capacity)
    # unkept lanes land in one spill column, cut off below
    slot = torch.where(keep, seg, row_capacity).long()
    dev = acc.device
    col_ids = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    if col_offset is not None:
        col_ids = col_ids + col_offset.to(torch.int32)[:, None]
    out_val = torch.zeros((bs, row_capacity + 1), dtype=torch.float32,
                          device=dev).scatter_(1, slot, acc)
    out_col = torch.full((bs, row_capacity + 1), COL_SENTINEL,
                         dtype=torch.int32, device=dev).scatter_(
        1, slot, col_ids.expand(bs, n))
    row_nnz = present.sum(dim=-1, dtype=torch.int32)
    overflow = torch.clamp(row_nnz - row_capacity, min=0).sum(dtype=torch.int32)
    return (out_col[:, :row_capacity], out_val[:, :row_capacity], row_nnz,
            overflow)


def window_accumulate(cols: torch.Tensor, vals: torch.Tensor, window: int,
                      row_capacity: int):
    """Dense-SPA accumulation of one block of rows in an extent-relative
    window of ``window`` lanes → (col, val, row_nnz, overflow)."""
    acc, present, lo = dense_window(cols, vals, window)
    return compact_dense(acc, present, row_capacity, col_offset=lo)


def _dense_accumulate_block(cols: torch.Tensor, vals: torch.Tensor,
                            ncols_b: int, row_capacity: int, span: int = 0):
    """Dense-SPA accumulation for one block of rows (DESIGN §5).  With
    ``span`` (the planner's per-row column-extent bound) the accumulator
    covers the pow2-padded extent, else B's whole column space.  The JAX
    package addresses the whole-space window by absolute column; relative
    to the row's smallest column it holds the same entries, since no
    relative column reaches ``ncols_b``."""
    return window_accumulate(cols, vals, _spa_window(ncols_b, span),
                             row_capacity)


def _spa_window(ncols_b: int, span: int) -> int:
    return ceil_pow2(min(int(span), ncols_b)) if span else ncols_b


def _bin_accumulate_block(cols: torch.Tensor, vals: torch.Tensor,
                          row_capacity: int, tile_n: int, n_tiles: int):
    """Propagation-blocking accumulation for one block of rows (DESIGN.md
    §11): value products scatter into an extent-relative window of
    ``n_tiles`` bins × ``tile_n`` columns, each bin compacts on its own
    (capacity ``min(tile_n, row_capacity)``), and the per-bin runs —
    ascending, bins in column order — concatenate through one final
    compaction into the ``row_capacity`` slots.

    The retained set equals the sort path's first ``row_capacity`` columns:
    a bin only truncates when ``row_capacity < tile_n`` and the bin alone
    exceeds it, and then the dropped entries lie past the row's capacity in
    the global order too.  ``row_nnz`` sums the true per-bin counts, so
    overflow matches ESC exactly."""
    bs = cols.shape[0]
    acc, present, lo = dense_window(cols, vals, tile_n * n_tiles)
    cap_bin = min(tile_n, row_capacity)
    offs = (lo[:, None].to(torch.int32)
            + torch.arange(n_tiles, dtype=torch.int32,
                           device=cols.device)[None, :] * tile_n).reshape(-1)
    c_b, v_b, nnz_b, _ = compact_dense(
        acc.reshape(bs * n_tiles, tile_n),
        present.reshape(bs * n_tiles, tile_n), cap_bin, col_offset=offs)
    c_cat = c_b.reshape(bs, n_tiles * cap_bin)
    v_cat = v_b.reshape(bs, n_tiles * cap_bin)
    valid = c_cat != COL_SENTINEL
    seg = torch.cumsum(valid, dim=-1, dtype=torch.int32) - 1
    slot = torch.where(valid & (seg < row_capacity), seg, row_capacity).long()
    out_val = torch.zeros((bs, row_capacity + 1), dtype=torch.float32,
                          device=cols.device).scatter_(1, slot, v_cat)
    out_col = torch.full((bs, row_capacity + 1), COL_SENTINEL,
                         dtype=torch.int32, device=cols.device).scatter_(
        1, slot, c_cat)
    row_nnz = nnz_b.reshape(bs, n_tiles).sum(dim=1, dtype=torch.int32)
    overflow = torch.clamp(row_nnz - row_capacity, min=0).sum(dtype=torch.int32)
    return (out_col[:, :row_capacity], out_val[:, :row_capacity], row_nnz,
            overflow)


def blocked_rows(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                 row_capacity: int, max_deg_a: int, max_deg_b: int,
                 accumulate, window: int = 0) -> SpGEMMOut:
    """Shared scaffolding of the plain numeric passes: expand ``rows`` in
    chunks of at most :data:`~repro_torch.core.csr.PLAIN_CHUNK_LANES` lanes
    (a row's lanes are its ``max_deg_a·max_deg_b`` products or its
    ``window`` accumulator lanes, whichever is wider), run
    ``accumulate(cols, vals)`` on each chunk and concatenate."""
    rownnz_b = torch.diff(b.rpt)
    parts = []
    for lo, hi in row_chunks(rows.shape[0],
                             max(max_deg_a * max_deg_b, window)):
        cols, vals, _ = gather_products(a, b, rows[lo:hi], max_deg_a,
                                        max_deg_b, rownnz_b=rownnz_b)
        parts.append(accumulate(cols, vals))
    if not parts:
        dev = a.rpt.device
        return SpGEMMOut(
            torch.full((0, row_capacity), COL_SENTINEL, dtype=torch.int32,
                       device=dev),
            torch.zeros((0, row_capacity), dtype=torch.float32, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))
    return SpGEMMOut(torch.cat([p[0] for p in parts]),
                     torch.cat([p[1] for p in parts]),
                     torch.cat([p[2] for p in parts]),
                     torch.stack([p[3] for p in parts]).sum(dtype=torch.int32))


def spgemm_rows(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                row_capacity: int, max_deg_a: int,
                max_deg_b: int) -> SpGEMMOut:
    """Numeric phase (ESC/sort route) for an explicit row-id list (one degree
    bucket, or all rows).  Output row ``i`` corresponds to ``rows[i]``."""
    return blocked_rows(
        a, b, rows, row_capacity=row_capacity, max_deg_a=max_deg_a,
        max_deg_b=max_deg_b,
        accumulate=lambda c, v: _accumulate_block(c, v, row_capacity))


def spgemm_rows_spa(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                    row_capacity: int, max_deg_a: int, max_deg_b: int,
                    span: int = 0) -> SpGEMMOut:
    """Numeric phase, dense-SPA route: the contract of :func:`spgemm_rows`
    (identical ``col``/``row_nnz``/``overflow``; ``val`` to float tolerance,
    the sums are taken in another order).  ``span`` is the planner's bound
    on the rows' product-column extent (0 → full column space)."""
    return blocked_rows(
        a, b, rows, row_capacity=row_capacity, max_deg_a=max_deg_a,
        max_deg_b=max_deg_b, window=_spa_window(b.ncols, span),
        accumulate=lambda c, v: _dense_accumulate_block(
            c, v, b.ncols, row_capacity, span))


def spgemm_rows_bin(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                    row_capacity: int, max_deg_a: int, max_deg_b: int,
                    tile_n: int = 128, n_tiles: int = 1) -> SpGEMMOut:
    """Numeric phase, propagation-blocking bin route: the contract of
    :func:`spgemm_rows`.  ``tile_n``/``n_tiles`` are the planner's bin
    layout (``binning.bin_tile``): ``n_tiles·tile_n`` must bound the rows'
    product-column extent."""
    return blocked_rows(
        a, b, rows, row_capacity=row_capacity, max_deg_a=max_deg_a,
        max_deg_b=max_deg_b, window=tile_n * n_tiles,
        accumulate=lambda c, v: _bin_accumulate_block(
            c, v, row_capacity, tile_n, n_tiles))


def spgemm(a: CSRDevice, b: CSRDevice, *, row_capacity: int,
           max_deg_a: int, max_deg_b: int,
           use_kernel: bool = False) -> SpGEMMOut:
    """C = A·B numeric phase with predicted-capacity output buffers, all
    rows at the global degree bounds on the ESC route (the paper's flow,
    and the quickstart's).  With ``use_kernel`` it runs through the ESC
    numeric kernel (``kernels.ops.spgemm_numeric``) on a CUDA tensor, its
    plain version on a CPU tensor; the kernel's workspaces are sized by the
    largest row's FLOP, computed on the device and read back once."""
    rows = torch.arange(a.nrows, dtype=torch.int32, device=a.rpt.device)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        max_flop = (int(flop_per_row(a, b)[0].max()) if a.nrows else 0)
        return SpGEMMOut(*kops.spgemm_numeric(
            a, b, rows, max_deg_a=max_deg_a, max_deg_b=max_deg_b,
            row_capacity=row_capacity, max_row_flop=max_flop))
    return spgemm_rows(a, b, rows, row_capacity=row_capacity,
                       max_deg_a=max_deg_a, max_deg_b=max_deg_b)


def routed_spgemm_rows(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                       row_capacity: int, deg_a: int, deg_b: int,
                       block_rows: int = 256, route: str = "esc",
                       tile_n: int = 0, n_tiles: int = 0, span: int = 0,
                       use_kernel: bool = False,
                       max_row_flop: int | None = None,
                       rownnz_b: torch.Tensor | None = None) -> SpGEMMOut:
    """One bucket's numeric phase on its planned accumulator route — the
    per-bucket dispatch shared by :func:`spgemm_binned` and the plan
    executor.  ``block_rows`` is the JAX package's row-block height; the
    port's kernels size their work by each row's products and its plain
    versions chunk by lanes, so it changes nothing here.  ``max_row_flop``
    (a bound on the rows' products, per call) sizes the kernels'
    workspaces; the plain versions need none.  ``rownnz_b`` (B's row
    lengths) saves each kernel call from recomputing them.  As in the JAX
    package, a BIN bucket without a bin layout (``tile_n == 0``) runs ESC on
    the plain path."""
    from repro_torch.kernels import ops as kops
    if use_kernel:
        return SpGEMMOut(*kops.spgemm_numeric_routed(
            a, b, rows, max_deg_a=deg_a, max_deg_b=deg_b,
            row_capacity=row_capacity, route=route, tile_n=tile_n,
            n_tiles=n_tiles, span=span, max_row_flop=max_row_flop,
            rownnz_b=rownnz_b))
    kops.check_route(route)
    if route == ROUTE_SPA:
        return spgemm_rows_spa(a, b, rows, row_capacity=row_capacity,
                               max_deg_a=deg_a, max_deg_b=deg_b, span=span)
    if route == ROUTE_BIN and tile_n:
        return spgemm_rows_bin(a, b, rows, row_capacity=row_capacity,
                               max_deg_a=deg_a, max_deg_b=deg_b,
                               tile_n=tile_n, n_tiles=max(1, n_tiles))
    return spgemm_rows(a, b, rows, row_capacity=row_capacity,
                       max_deg_a=deg_a, max_deg_b=deg_b)


def assemble(nrows: int, cap_out: int, parts, device) -> SpGEMMOut:
    """Write per-bucket results into one ``(nrows, cap_out)`` output.

    ``parts`` yields ``(rows, SpGEMMOut)`` pairs, one per bucket, whose rows
    partition the output rows.  Each bucket's ``(rows, cap)`` block lands in
    its rows' first ``cap`` slots of a buffer pre-filled with the sentinel
    and 0 — in place, so the assembled output is the only full-width buffer
    (the JAX package pads every block to ``cap_out`` and concatenates, which
    holds about three output-sized buffers at once)."""
    col = torch.full((nrows, cap_out), COL_SENTINEL, dtype=torch.int32,
                     device=device)
    val = torch.zeros((nrows, cap_out), dtype=torch.float32, device=device)
    row_nnz = torch.zeros(nrows, dtype=torch.int32, device=device)
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    for rows, (c, v, n, of) in parts:
        rows = rows.long()
        col[rows, :c.shape[1]] = c
        val[rows, :v.shape[1]] = v
        row_nnz[rows] = n
        overflow = overflow + of
    return SpGEMMOut(col, val, row_nnz, overflow)


def spgemm_binned(a: CSRDevice, b: CSRDevice, plan, *,
                  alloc, use_kernel: bool = False) -> SpGEMMOut:
    """C = A·B numeric phase, bucket-iterated (DESIGN.md §4).

    ``plan`` is a ``core.binning.BinningPlan``; ``alloc`` is either an int
    (uniform row capacity) or a ``predictor.BinnedAllocationPlan``
    (per-bucket capacities).  Each bucket runs its planned route."""
    dev = a.rpt.device
    if isinstance(alloc, (int, np.integer)):
        caps = [int(alloc)] * len(plan.buckets)
        cap_out = int(alloc)
    else:
        caps = list(alloc.bucket_capacities)
        cap_out = max(caps) if caps else alloc.row_capacity

    def parts():
        for bucket, cap in zip(plan.buckets, caps):
            rows = torch.from_numpy(bucket.rows).to(dev)
            yield rows, routed_spgemm_rows(
                a, b, rows, row_capacity=cap, deg_a=bucket.deg_a,
                deg_b=bucket.deg_b, block_rows=bucket.block_rows,
                route=bucket.route, tile_n=bucket.tile_n,
                n_tiles=bucket.n_tiles, span=bucket.span,
                use_kernel=use_kernel)

    return assemble(plan.nrows, cap_out, parts(), dev)


def dense_of(out: SpGEMMOut, ncols: int) -> torch.Tensor:
    """Densify (tests only)."""
    m, cap = out.col.shape
    valid = out.col != COL_SENTINEL
    safe = torch.where(valid, out.col, 0).long()
    dense = torch.zeros((m, ncols), dtype=torch.float32, device=out.col.device)
    return dense.scatter_add_(1, safe, torch.where(valid, out.val, 0.0))
