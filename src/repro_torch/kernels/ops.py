"""Route-checked entry points of the port's kernels.

Mirrors ``repro.kernels.ops``: the callers in ``core`` reach every kernel
through here.  Each wrapper launches its hand-written CUDA kernel on CUDA
tensors and runs its plain tensor-op version on CPU tensors.  Only the ESC
accumulator route is ported so far: a bucket planned on SPA or BIN raises a
typed :class:`~repro_torch.core.errors.PlanMismatchError` on either device.
"""
from __future__ import annotations

import torch

from repro_torch.core.binning import ROUTE_BIN, ROUTE_ESC, ROUTE_SPA
from repro_torch.core.csr import CSRDevice
from repro_torch.core.errors import PlanMismatchError
from . import flop_per_row as _flop_k
from . import spgemm_numeric as _num_k
from . import spgemm_symbolic as _sym_k


def check_route(route: str) -> None:
    """Raise unless ``route`` is one this port runs (ESC)."""
    if route in (ROUTE_SPA, ROUTE_BIN):
        raise PlanMismatchError(
            f"accumulator route {route!r} is not ported yet: plan with "
            f"route='esc'", observed=route, planned=ROUTE_ESC)
    if route != ROUTE_ESC:
        # routes are static plan metadata — an unknown string would otherwise
        # silently fall through to the ESC path and mask a planner bug
        raise PlanMismatchError(f"unknown kernel route {route!r}")


def flop_rows(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
              max_deg_a: int) -> torch.Tensor:
    """floprC for the listed rows only (the binned pipeline's FLOP phase)."""
    return _flop_k.flop_rows(a, torch.diff(b.rpt), rows, max_deg_a=max_deg_a)


def fused_flop_symbolic_routed(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                               *, max_deg_a: int, max_deg_b: int,
                               route: str = ROUTE_ESC, rownnz_b=None):
    """Route-dispatched fused (z*, f*, FLOP per sampled row) — the binned
    predictor's one kernel call per bucket."""
    check_route(route)
    return _sym_k.fused_flop_symbolic(a, b, rows, max_deg_a=max_deg_a,
                                      max_deg_b=max_deg_b, rownnz_b=rownnz_b)


def spgemm_numeric_routed(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                          max_deg_a: int, max_deg_b: int, row_capacity: int,
                          route: str = ROUTE_ESC, rownnz_b=None):
    """Route-dispatched numeric phase — ``spgemm_binned``'s per-bucket
    kernel entry point: the ESC numeric phase with fused compaction →
    (col, val, row_nnz, overflow)."""
    check_route(route)
    return _num_k.spgemm_numeric(a, b, rows, max_deg_a=max_deg_a,
                                 max_deg_b=max_deg_b,
                                 row_capacity=row_capacity,
                                 rownnz_b=rownnz_b)
