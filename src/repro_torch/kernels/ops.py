"""Public entry points of the port's kernels.

Mirrors ``repro.kernels.ops``, all of it, under its names and argument
order: the callers in ``core`` reach every SpGEMM kernel through here, and
in the routed entry points each bucket's accumulator route (ESC, SPA or
BIN, static plan metadata) picks its kernel; :func:`flash_attention` has no
caller in the port, as its JAX twin has none in the JAX package.  Each
wrapper launches its hand-written CUDA kernel on CUDA tensors and runs its
plain tensor-op version on CPU tensors.  The TPU grid knobs of the SpGEMM
entry points (``block_rows``, ``block_samples``) size Pallas blocks and mean
nothing to kernels that give each row its own thread block or warp, so
they are dropped; flash attention keeps ``block_q`` and ``block_k`` for
JAX's divisibility checks.  Five entries have no JAX twin of their own:
:func:`flop_rows_buckets`, :func:`fused_flop_symbolic_buckets` and
:func:`fused_flop_symbolic_bitmask_buckets` compute what
:func:`flop_rows` and the ESC and SPA/BIN branches of
:func:`fused_flop_symbolic_routed` give bucket by bucket, for a whole
binned prediction in one launch each; :func:`exact_row_counts_esc` and
:func:`exact_row_counts_bitmask` give the per-row distinct counts that the
JAX package computes outside Pallas (``core.predictor.exact_row_counts``).
"""
from __future__ import annotations

import torch

from repro_torch.core.binning import (DEFAULT_LANE_BUDGET, ROUTE_BIN,
                                      ROUTE_ESC, ROUTE_SPA, ROUTES, bin_tile,
                                      spa_tile)
from repro_torch.core.csr import CSRDevice
from repro_torch.core.errors import PlanMismatchError
from . import accumulator as _acc_k
from . import flash_attention as _fa_k
from . import flop_per_row as _flop_k
from . import spgemm_numeric as _num_k
from . import spgemm_symbolic as _sym_k


def check_route(route: str) -> None:
    """Raise unless ``route`` is one of the accumulator routes."""
    if route not in ROUTES:
        # routes are static plan metadata — an unknown string would otherwise
        # silently fall through to the ESC path and mask a planner bug
        raise PlanMismatchError(f"unknown kernel route {route!r}")


def flop_per_row(a: CSRDevice, b: CSRDevice, *,
                 max_deg_a: int = 128) -> torch.Tensor:
    """floprC for all M rows, reading at most ``max_deg_a`` entries per A
    row (the JAX package's default of 128 included: wider rows are
    undercounted there and here alike)."""
    return _flop_k.flop_per_row(a, torch.diff(b.rpt), max_deg_a=max_deg_a)


def flop_rows(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
              max_deg_a: int) -> torch.Tensor:
    """floprC for the listed rows only (the binned pipeline's FLOP phase)."""
    return _flop_k.flop_rows(a, torch.diff(b.rpt), rows, max_deg_a=max_deg_a)


def flop_rows_buckets(a: CSRDevice, b: CSRDevice,
                      tables: _flop_k.FlopTables) -> torch.Tensor:
    """floprC for every row of a binned plan in one launch, each row at its
    bucket's bound (``tables`` from ``predictor.plan_tables``)."""
    return _flop_k.flop_rows_buckets(a, torch.diff(b.rpt), tables)


def sampled_symbolic(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                     max_deg_a: int, max_deg_b: int, *, rownnz_b=None,
                     row_flop=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(z*, f*) for the proposed predictor at global bounds, f* the
    gathered products.  ``row_flop`` (the sampled rows' FLOP, optional)
    sizes each row's workspace in the kernel's one launch."""
    return _sym_k.sampled_symbolic(a, b, rows, max_deg_a=max_deg_a,
                                   max_deg_b=max_deg_b, rownnz_b=rownnz_b,
                                   row_flop=row_flop)


def fused_flop_symbolic(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                        max_deg_a: int, max_deg_b: int, *, rownnz_b=None):
    """(z*, f*, FLOP per sampled row) in one ESC kernel, unrouted."""
    return _sym_k.fused_flop_symbolic(a, b, rows, max_deg_a=max_deg_a,
                                      max_deg_b=max_deg_b, rownnz_b=rownnz_b)


def fused_flop_symbolic_buckets(a: CSRDevice, b: CSRDevice,
                                table: _sym_k.SampleTable, *, rownnz_b=None):
    """(z*, f*, FLOP per sample) for the sampled rows of a binned
    prediction's ESC buckets in one launch, each at its bucket's bounds
    (``table`` from ``predictor.esc_sample_table``)."""
    return _sym_k.fused_flop_symbolic_buckets(a, b, table, rownnz_b=rownnz_b)


def fused_flop_symbolic_bitmask_buckets(a: CSRDevice, b: CSRDevice,
                                        table: _acc_k.BitmaskTable, *,
                                        rownnz_b=None):
    """(z*, f*, FLOP per sample) for the sampled rows of a binned
    prediction's SPA and BIN buckets in one launch, each at its bucket's
    bounds and mask words (``table`` from
    ``predictor.bitmask_sample_table``)."""
    return _acc_k.fused_flop_symbolic_bitmask_buckets(a, b, table,
                                                      rownnz_b=rownnz_b)


def exact_row_counts_esc(a: CSRDevice, b: CSRDevice,
                         table: _sym_k.SampleTable, *, rownnz_b=None):
    """Each listed row's distinct product columns (int32, the caller's
    order) in one launch of the fused ESC kernel's per-row count mode: the
    exact-symbolic fallback over an ESC bucket's rows (``table`` from
    ``spgemm_symbolic.sample_table`` at the bucket's bounds)."""
    return _sym_k.exact_row_counts_esc(a, b, table, rownnz_b=rownnz_b)


def exact_row_counts_bitmask(a: CSRDevice, b: CSRDevice,
                             table: _acc_k.BitmaskTable, *, rownnz_b=None):
    """The same by the bitmask kernel's per-row count mode, over a SPA or
    BIN bucket's rows (``table`` from ``accumulator.bitmask_table`` at the
    bucket's bounds and mask words)."""
    return _acc_k.exact_row_counts_bitmask(a, b, table, rownnz_b=rownnz_b)


def bitmask_symbolic(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                     max_deg_a: int, max_deg_b: int, *, span: int = 0,
                     rownnz_b=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(z*, f*) by bitmask popcount (the SPA symbolic route), z* bit-equal
    to :func:`sampled_symbolic`'s while ``span`` covers the extent, f* the
    referenced B rows' untruncated lengths.  ``span`` bounds the rows'
    product-column extent (0 → B's column space)."""
    return _acc_k.bitmask_symbolic(a, b, rows, max_deg_a=max_deg_a,
                                   max_deg_b=max_deg_b, span=span,
                                   rownnz_b=rownnz_b)


def fused_flop_symbolic_routed(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                               *, max_deg_a: int, max_deg_b: int,
                               route: str = ROUTE_ESC, span: int = 0,
                               rownnz_b=None):
    """Route-dispatched fused (z*, f*, FLOP per sampled row) — the binned
    predictor's one kernel call per bucket.  Distinct counts do not depend
    on the bins, so BIN shares SPA's bitmask kernel; ``span`` bounds the
    rows' column extent there (0 → B's column space)."""
    check_route(route)
    if route in (ROUTE_SPA, ROUTE_BIN):
        return _acc_k.fused_flop_symbolic_bitmask(
            a, b, rows, max_deg_a=max_deg_a, max_deg_b=max_deg_b, span=span,
            rownnz_b=rownnz_b)
    return _sym_k.fused_flop_symbolic(a, b, rows, max_deg_a=max_deg_a,
                                      max_deg_b=max_deg_b, rownnz_b=rownnz_b)


def spgemm_numeric(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                   max_deg_a: int, max_deg_b: int, row_capacity: int,
                   rownnz_b=None, max_row_flop=None):
    """ESC numeric phase with fused compaction → (col, val, row_nnz,
    overflow); ``max_row_flop`` bounds each row's products and sizes the
    kernel's workspaces."""
    return _num_k.spgemm_numeric(a, b, rows, max_deg_a=max_deg_a,
                                 max_deg_b=max_deg_b,
                                 row_capacity=row_capacity, rownnz_b=rownnz_b,
                                 max_row_flop=max_row_flop)


def _tiling(tiler, b: CSRDevice, tile_n: int, n_tiles: int, span: int):
    """The SPA/BIN tile layout: with ``tile_n <= 0`` derived from ``span``
    (0 → B's column space) as the JAX package derives it, and with
    ``n_tiles <= 0`` tiles covering B's column space."""
    if tile_n <= 0:
        tile_n, n_tiles = tiler(min(span, b.ncols) if span else b.ncols,
                                DEFAULT_LANE_BUDGET)
    if n_tiles <= 0:
        n_tiles = -(-b.ncols // tile_n)
    return tile_n, n_tiles


def spgemm_numeric_spa(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                       max_deg_a: int, max_deg_b: int, row_capacity: int,
                       tile_n: int, n_tiles: int = 0, span: int = 0,
                       rownnz_b=None):
    """Dense-SPA numeric phase with fused compaction — the output contract
    of :func:`spgemm_numeric` (col/row_nnz/overflow identical, values to
    float tolerance).  ``n_tiles·tile_n`` must bound every row's
    product-column extent."""
    tile_n, n_tiles = _tiling(spa_tile, b, tile_n, n_tiles, span)
    return _acc_k.spa_numeric(a, b, rows, max_deg_a=max_deg_a,
                              max_deg_b=max_deg_b, row_capacity=row_capacity,
                              tile_n=tile_n, n_tiles=n_tiles,
                              rownnz_b=rownnz_b)


def spgemm_numeric_bin(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                       max_deg_a: int, max_deg_b: int, row_capacity: int,
                       tile_n: int, n_tiles: int = 0, span: int = 0,
                       rownnz_b=None, max_row_flop=None):
    """Propagation-blocking numeric phase with fused compaction — the
    output contract of :func:`spgemm_numeric`."""
    tile_n, n_tiles = _tiling(bin_tile, b, tile_n, n_tiles, span)
    return _acc_k.bin_numeric(a, b, rows, max_deg_a=max_deg_a,
                              max_deg_b=max_deg_b, row_capacity=row_capacity,
                              tile_n=tile_n, n_tiles=n_tiles,
                              rownnz_b=rownnz_b, max_row_flop=max_row_flop)


def spgemm_numeric_routed(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                          max_deg_a: int, max_deg_b: int, row_capacity: int,
                          route: str = ROUTE_ESC, tile_n: int = 0,
                          n_tiles: int = 0, span: int = 0, rownnz_b=None,
                          max_row_flop=None):
    """Route-dispatched numeric phase with fused compaction — the
    per-bucket kernel entry point → (col, val, row_nnz, overflow).  SPA and
    BIN take the planner's tiling, or derive it (:func:`_tiling`).
    ``max_row_flop`` (a bound on each row's products) sizes the ESC and BIN
    kernels' workspaces; the SPA kernel's follow its tile."""
    check_route(route)
    kw = dict(max_deg_a=max_deg_a, max_deg_b=max_deg_b,
              row_capacity=row_capacity, rownnz_b=rownnz_b)
    if route == ROUTE_ESC:
        return spgemm_numeric(a, b, rows, max_row_flop=max_row_flop, **kw)
    if route == ROUTE_SPA:
        return spgemm_numeric_spa(a, b, rows, tile_n=tile_n, n_tiles=n_tiles,
                                  span=span, **kw)
    return spgemm_numeric_bin(a, b, rows, tile_n=tile_n, n_tiles=n_tiles,
                              span=span, max_row_flop=max_row_flop, **kw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Blocked GQA attention, q ``(B, Hq, Sq, D)``, k and v ``(B, Hkv, Sk,
    D)``, with the TPU kernel's top-left causal mask (``kernels/
    flash_attention.py``)."""
    return _fa_k.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                 block_k=block_k)
