"""Route-checked entry points of the port's kernels.

Mirrors ``repro.kernels.ops``: the callers in ``core`` reach every kernel
through here, and each bucket's accumulator route (ESC, SPA or BIN, static
plan metadata) picks its kernel.  Each wrapper launches its hand-written
CUDA kernel on CUDA tensors and runs its plain tensor-op version on CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.binning import (DEFAULT_LANE_BUDGET, ROUTE_BIN,
                                      ROUTE_ESC, ROUTE_SPA, ROUTES, bin_tile,
                                      spa_tile)
from repro_torch.core.csr import CSRDevice
from repro_torch.core.errors import PlanMismatchError
from . import accumulator as _acc_k
from . import flop_per_row as _flop_k
from . import spgemm_numeric as _num_k
from . import spgemm_symbolic as _sym_k


def check_route(route: str) -> None:
    """Raise unless ``route`` is one of the accumulator routes."""
    if route not in ROUTES:
        # routes are static plan metadata — an unknown string would otherwise
        # silently fall through to the ESC path and mask a planner bug
        raise PlanMismatchError(f"unknown kernel route {route!r}")


def flop_rows(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
              max_deg_a: int) -> torch.Tensor:
    """floprC for the listed rows only (the binned pipeline's FLOP phase)."""
    return _flop_k.flop_rows(a, torch.diff(b.rpt), rows, max_deg_a=max_deg_a)


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


def spgemm_numeric_routed(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                          max_deg_a: int, max_deg_b: int, row_capacity: int,
                          route: str = ROUTE_ESC, tile_n: int = 0,
                          n_tiles: int = 0, span: int = 0, rownnz_b=None):
    """Route-dispatched numeric phase with fused compaction — the
    per-bucket kernel entry point → (col, val, row_nnz, overflow).  SPA and
    BIN take the planner's tiling; with ``tile_n <= 0`` it is derived from
    ``span`` (0 → B's column space) as the JAX package derives it, and with
    ``n_tiles <= 0`` the tiles cover B's column space."""
    check_route(route)
    if route == ROUTE_ESC:
        return _num_k.spgemm_numeric(a, b, rows, max_deg_a=max_deg_a,
                                     max_deg_b=max_deg_b,
                                     row_capacity=row_capacity,
                                     rownnz_b=rownnz_b)
    if tile_n <= 0:
        tiling = spa_tile if route == ROUTE_SPA else bin_tile
        tile_n, n_tiles = tiling(min(span, b.ncols) if span else b.ncols,
                                 DEFAULT_LANE_BUDGET)
    if n_tiles <= 0:
        n_tiles = -(-b.ncols // tile_n)
    kernel = _acc_k.spa_numeric if route == ROUTE_SPA else _acc_k.bin_numeric
    return kernel(a, b, rows, max_deg_a=max_deg_a, max_deg_b=max_deg_b,
                  row_capacity=row_capacity, tile_n=tile_n, n_tiles=n_tiles,
                  rownnz_b=rownnz_b)
