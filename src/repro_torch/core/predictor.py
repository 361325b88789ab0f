"""The paper's sampled-compression-ratio predictor, on device (torch).

Algorithm 2 as the JAX package adapts it (DESIGN.md §3): for each of S
sampled rows of A, gather the intermediate-product columns, count the
distinct ones, and sum over the sample:

  z* = Σ distinct counts;  f* = Σ product counts
  r* = f*/z*;  Z2* = F/r*;  nnzr*(C) = floprC / r*        (paper eq. 4)

The same counts drive the reference design  Z1* = z*/p  (paper eq. 2).

Each degree bucket counts distinct columns on its planned accumulator route:
ESC sorts, SPA and BIN set bits in a bitmask.  With ``use_kernel`` the
per-bucket counting runs in the port's hand-written CUDA kernels
(``repro_torch.kernels``) on a CUDA tensor; without it — and always on a CPU
tensor — the plain tensor-op versions below run.  Integer
counts are int32 and the eq. 4 chain is float32 in the JAX package's order
of operations, so both packages predict the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .binning import ROUTE_BIN, ROUTE_SPA, BinningPlan, ceil_pow2
from .csr import COL_SENTINEL, CSRDevice, expand_products, row_chunks
from .flop import flop_per_row

class PredictionDev(NamedTuple):
    nnz_total: torch.Tensor        # predicted NNZ(C)
    structure: torch.Tensor        # predicted nnz per output row (float32, (M,))
    compression_ratio: torch.Tensor
    sampled_flop: torch.Tensor
    sampled_nnz: torch.Tensor
    total_flop: torch.Tensor


def _host_rows(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        return rows.cpu().numpy()
    return np.asarray(rows)


def gather_sampled_products(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                            max_deg_a: int, max_deg_b: int,
                            rownnz_b: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand the sampled rows' product columns (column-only view of
    :func:`repro_torch.core.csr.expand_products`).

    Returns (cols (S, DA*DB) int32 with COL_SENTINEL padding, valid mask).
    """
    cols, _, valid = expand_products(a, b, rows, max_deg_a, max_deg_b,
                                     rownnz_b=rownnz_b, with_values=False)
    return cols, valid


def count_distinct_sorted(cols: torch.Tensor) -> torch.Tensor:
    """Sort rows and count distinct non-sentinel entries per row (ESC)."""
    srt = torch.sort(cols, dim=-1).values
    first = (srt[:, :1] != COL_SENTINEL).to(torch.int32)
    ascents = ((srt[:, 1:] != srt[:, :-1]) &
               (srt[:, 1:] != COL_SENTINEL)).to(torch.int32)
    return first[:, 0] + ascents.sum(dim=-1, dtype=torch.int32)


def count_distinct_dense(cols: torch.Tensor, ncols_b: int,
                         span: int = 0) -> torch.Tensor:
    """Distinct non-sentinel entries per row via the bitmask accumulator —
    the SPA and BIN routes' plain path.  A distinct count is a property of
    the column set, so this equals :func:`count_distinct_sorted` exactly.
    ``span`` (the planner's per-row column-extent bound, 0 → B's column
    space) sizes the bitmask, addressed relative to each row's smallest
    column."""
    from repro_torch.kernels.accumulator import bitmask_distinct
    n = min(int(span), ncols_b) if span else ncols_b
    return bitmask_distinct(cols, -(-n // 32))


def sampled_counts(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                   max_deg_a: int, max_deg_b: int,
                   rownnz_b: torch.Tensor | None = None,
                   count=count_distinct_sorted
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(z, f) over ``rows`` at the given degree bounds, expanded in chunks
    so a wide bucket never materialises all its rows at once.  ``count``
    maps a chunk's product columns to its distinct count per row (ESC's
    sort by default)."""
    z = torch.zeros((), dtype=torch.int32, device=a.rpt.device)
    f = torch.zeros((), dtype=torch.int32, device=a.rpt.device)
    for lo, hi in row_chunks(rows.shape[0], max_deg_a * max_deg_b):
        cols, valid = gather_sampled_products(a, b, rows[lo:hi], max_deg_a,
                                              max_deg_b, rownnz_b=rownnz_b)
        z = z + count(cols).sum(dtype=torch.int32)
        f = f + valid.sum(dtype=torch.int32)
    return z, f


def _eq4(floprc: torch.Tensor, total_flop: torch.Tensor, z_star: torch.Tensor,
         f_star: torch.Tensor) -> PredictionDev:
    r_star = (f_star.to(torch.float32)
              / torch.clamp(z_star, min=1).to(torch.float32))
    z2 = total_flop.to(torch.float32) / r_star
    return PredictionDev(z2, floprc.to(torch.float32) / r_star, r_star,
                         f_star, z_star, total_flop)


def _eq2(floprc: torch.Tensor, total_flop: torch.Tensor, z_star: torch.Tensor,
         f_star: torch.Tensor, p: float) -> PredictionDev:
    z1 = z_star.to(torch.float32) / p
    cr = total_flop.to(torch.float32) / torch.clamp(z1, min=1.0)
    return PredictionDev(z1, floprc.to(torch.float32) / cr, cr, f_star,
                         z_star, total_flop)


def proposed_predict(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                     max_deg_a: int, max_deg_b: int) -> PredictionDev:
    """THE PAPER'S METHOD (eq. 4) at global degree bounds (plain version;
    the JAX package's kernel variant of this call is not ported yet)."""
    floprc, total_flop = flop_per_row(a, b)
    z_star, f_star = sampled_counts(a, b, rows, max_deg_a, max_deg_b)
    return _eq4(floprc, total_flop, z_star, f_star)


def reference_predict(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                      max_deg_a: int, max_deg_b: int) -> PredictionDev:
    """Reference design (eq. 2): Z1* = z*/p."""
    floprc, total_flop = flop_per_row(a, b)
    z_star, f_star = sampled_counts(a, b, rows, max_deg_a, max_deg_b)
    return _eq2(floprc, total_flop, z_star, f_star, rows.shape[0] / a.nrows)


# --------------------------------------------------------------------------- #
# Binned prediction (DESIGN.md §4): per-bucket buffers instead of global pad.
# --------------------------------------------------------------------------- #
def binned_symbolic_counts(a: CSRDevice, b: CSRDevice, rows,
                           plan: BinningPlan, use_kernel: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Σ over buckets of the sampled (z*, f*), each bucket at its own degree
    bounds and on its planned accumulator route — exact ints, so the totals
    equal the global-pad / all-ESC totals bit for bit whatever the
    routing."""
    from repro_torch.kernels import ops as kops
    dev = a.rpt.device
    z = torch.zeros((), dtype=torch.int32, device=dev)
    f = torch.zeros((), dtype=torch.int32, device=dev)
    rownnz_b = torch.diff(b.rpt)         # hoisted out of the per-bucket calls
    for bucket, sub in zip(plan.buckets, plan.subset(_host_rows(rows))):
        kops.check_route(bucket.route)
        if sub.size == 0:
            continue            # no sampled rows landed in this bucket
        sub_d = torch.from_numpy(sub).to(dev)
        if use_kernel:
            zb, fb, _ = kops.fused_flop_symbolic_routed(
                a, b, sub_d, max_deg_a=bucket.deg_a, max_deg_b=bucket.deg_b,
                route=bucket.route, span=bucket.span, rownnz_b=rownnz_b)
        elif bucket.route in (ROUTE_SPA, ROUTE_BIN):
            zb, fb = sampled_counts(
                a, b, sub_d, bucket.deg_a, bucket.deg_b, rownnz_b=rownnz_b,
                count=lambda cols, span=bucket.span: count_distinct_dense(
                    cols, b.ncols, span))
        else:
            zb, fb = sampled_counts(a, b, sub_d, bucket.deg_a, bucket.deg_b,
                                    rownnz_b=rownnz_b)
        z = z + zb
        f = f + fb
    return z, f


def _binned_floprc(a: CSRDevice, b: CSRDevice, plan: BinningPlan) -> torch.Tensor:
    """floprC assembled bucket by bucket through the per-bucket FLOP kernel —
    each bucket gathers at its own deg_a bound, not the global one."""
    from repro_torch.kernels import ops as kops
    dev = a.rpt.device
    if not plan.buckets:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    parts = [kops.flop_rows(a, b, torch.from_numpy(bucket.rows).to(dev),
                            max_deg_a=bucket.deg_a)
             for bucket in plan.buckets]
    perm = torch.from_numpy(plan.inverse_perm()).to(dev)
    return torch.cat(parts)[perm]


def proposed_predict_binned(a: CSRDevice, b: CSRDevice, rows,
                            plan: BinningPlan,
                            use_kernel: bool = False,
                            floprc=None) -> PredictionDev:
    """THE PAPER'S METHOD (eq. 4), bucket-iterated.

    Identical outputs to :func:`proposed_predict`: z*/f* are exact integer
    counts whatever the padding.  With ``use_kernel`` the per-bucket pass
    is the fused FLOP + symbolic kernel and floprC runs through the
    per-bucket FLOP kernel.  ``floprc`` (Algorithm 1's per-row FLOP) may be
    passed in by callers that already computed it (the planner)."""
    if floprc is not None:
        floprc = torch.as_tensor(floprc, device=a.rpt.device)
        total_flop = floprc.sum(dtype=torch.int32)
    elif use_kernel:
        floprc = _binned_floprc(a, b, plan)
        total_flop = floprc.sum(dtype=torch.int32)
    else:
        floprc, total_flop = flop_per_row(a, b)
    z_star, f_star = binned_symbolic_counts(a, b, rows, plan, use_kernel)
    return _eq4(floprc, total_flop, z_star, f_star)


def reference_predict_binned(a: CSRDevice, b: CSRDevice, rows,
                             plan: BinningPlan,
                             use_kernel: bool = False) -> PredictionDev:
    """Reference design (eq. 2), bucket-iterated — mirrors reference_predict."""
    floprc, total_flop = flop_per_row(a, b)
    z_star, f_star = binned_symbolic_counts(a, b, rows, plan, use_kernel)
    return _eq2(floprc, total_flop, z_star, f_star,
                _host_rows(rows).shape[0] / a.nrows)


# --------------------------------------------------------------------------- #
# Allocation planning: prediction → output capacities (DESIGN.md §3).
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AllocationPlan:
    """Output capacities for the numeric phase, derived from a prediction."""
    row_capacity: int       # per-row output slots (padded uniform rows)
    total_capacity: int     # total output slots if using compacted layout
    safety: float

    @staticmethod
    def from_prediction(pred_structure, flopr, safety: float = 1.2,
                        align: int = 8, pow2: bool = False) -> "AllocationPlan":
        ps = np.asarray(pred_structure, dtype=np.float64)
        fl = np.asarray(flopr, dtype=np.float64)
        # Never exceed the per-row upper bound; round to ``align`` lanes.
        per_row = np.minimum(np.ceil(ps * safety), fl)
        cap = int(per_row.max()) if per_row.size else 0
        cap = max(align, ((cap + align - 1) // align) * align)
        # alignment must never push past the upper bound (flopr is always safe)
        ub = int(fl.max()) if fl.size else cap
        cap = min(cap, max(ub, align))
        if pow2:
            cap = ceil_pow2(cap)
        total = int(per_row.sum())
        total = max(align, ((total + align - 1) // align) * align)
        return AllocationPlan(cap, total, safety)


@dataclasses.dataclass(frozen=True)
class BinnedAllocationPlan:
    """Per-bucket output capacities for the binned numeric phase: each
    bucket is sized by the worst predicted row *in that bucket*, so
    low-degree buckets keep small output buffers."""

    bucket_capacities: tuple[int, ...]   # per-bucket row_capacity
    row_capacity: int                    # max — width of the assembled output
    total_capacity: int                  # Σ bucket rows · bucket capacity
    safety: float

    @staticmethod
    def from_prediction(plan: BinningPlan, pred_structure, flopr,
                        safety: float = 1.2, align: int = 8,
                        pow2: bool = False) -> "BinnedAllocationPlan":
        ps = np.asarray(pred_structure, dtype=np.float64)
        fl = np.asarray(flopr, dtype=np.float64)
        caps = []
        total = 0
        for bucket in plan.buckets:
            sub = AllocationPlan.from_prediction(
                ps[bucket.rows], fl[bucket.rows], safety=safety, align=align,
                pow2=pow2)
            caps.append(sub.row_capacity)
            total += bucket.n_rows * sub.row_capacity
        return BinnedAllocationPlan(
            bucket_capacities=tuple(caps),
            row_capacity=max(caps) if caps else align,
            total_capacity=total, safety=safety)
