"""The paper's sampled-compression-ratio predictor, on device (torch).

Algorithm 2 as the JAX package adapts it (DESIGN.md §3): for each of S
sampled rows of A, gather the intermediate-product columns, count the
distinct ones, and sum over the sample:

  z* = Σ distinct counts;  f* = Σ product counts
  r* = f*/z*;  Z2* = F/r*;  nnzr*(C) = floprC / r*        (paper eq. 4)

The same counts drive the reference design  Z1* = z*/p  (paper eq. 2).

The global-pad predictors (the paper's Algorithm 2 as stated: one pad at
the global degree bounds) count with ESC's sort.  The binned ones count each
degree bucket on its planned accumulator route: ESC sorts, SPA and BIN set
bits in a bitmask.  With ``use_kernel`` the counting and Algorithm 1 run in
the port's hand-written CUDA kernels (``repro_torch.kernels``) on a CUDA
tensor — Algorithm 1 for all of a plan's rows in one launch, the ESC
buckets' sampled rows in one launch and the SPA and BIN buckets' in
another, from tables cached with the plan (:func:`plan_tables`); without
it the plain tensor-op versions below run,
and on a CPU tensor the kernel wrappers run theirs.  Integer
counts are int32 and the eq. 4 chain is float32 in the JAX package's order
of operations, so both packages predict the same numbers.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple

import numpy as np
import torch

from . import faults as faults_mod
from .binning import ROUTE_BIN, ROUTE_ESC, ROUTE_SPA, BinningPlan, ceil_pow2
from .csr import COL_SENTINEL, CSRDevice, expand_products, row_chunks
from .flop import flop_per_row

SAMPLE_FRACTION = 0.003
SAMPLE_CAP = 300


class PredictionDev(NamedTuple):
    nnz_total: torch.Tensor        # predicted NNZ(C)
    structure: torch.Tensor        # predicted nnz per output row (float32, (M,))
    compression_ratio: torch.Tensor
    sampled_flop: torch.Tensor
    sampled_nnz: torch.Tensor
    total_flop: torch.Tensor


def static_sample_num(m: int, fraction: float = SAMPLE_FRACTION,
                      cap: int = SAMPLE_CAP) -> int:
    """Paper Algorithm 2 line 1, resolved from the row count."""
    return max(1, min(int(fraction * m), cap))


def draw_sample_rows(generator: torch.Generator, m: int,
                     sample_num: int) -> torch.Tensor:
    """rid = M * rand[r] (with replacement, as in the paper): int32 row ids
    on ``generator``'s device.  The float32 ``M·rand`` is cut to an int and
    clipped to ``[0, M-1]`` as in the JAX package, whose ``jax.random``
    stream this generator does not reproduce."""
    rand = torch.rand(sample_num, generator=generator,
                      device=generator.device, dtype=torch.float32)
    return torch.clamp((m * rand).to(torch.int32), 0, m - 1)


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


def distinct_per_row(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                     max_deg_a: int, max_deg_b: int,
                     rownnz_b: torch.Tensor | None = None,
                     count=count_distinct_sorted) -> torch.Tensor:
    """Each row's distinct product columns (int32 ``(S,)``) at the given
    degree bounds, expanded in chunks as :func:`sampled_counts` expands
    them; ``count`` as there."""
    out = [torch.zeros(0, dtype=torch.int32, device=a.rpt.device)]
    for lo, hi in row_chunks(rows.shape[0], max_deg_a * max_deg_b):
        cols, _ = gather_sampled_products(a, b, rows[lo:hi], max_deg_a,
                                          max_deg_b, rownnz_b=rownnz_b)
        out.append(count(cols).to(torch.int32))
    return torch.cat(out)


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


def _global_counts(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                   max_deg_a: int, max_deg_b: int, use_kernel: bool):
    """(floprC, F, z*, f*) at the global degree bounds.  With
    ``use_kernel`` floprC runs through the all-rows FLOP kernel at
    ``max_deg_a`` (exact, since it bounds A's rows) and (z*, f*) through
    the global-pad symbolic kernel, each sampled row's workspace sized by
    its FLOP."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        floprc = kops.flop_per_row(a, b, max_deg_a=max_deg_a)
        total_flop = floprc.sum(dtype=torch.int32)
        z_star, f_star = kops.sampled_symbolic(
            a, b, rows, max_deg_a, max_deg_b, row_flop=floprc[rows.long()])
    else:
        floprc, total_flop = flop_per_row(a, b)
        z_star, f_star = sampled_counts(a, b, rows, max_deg_a, max_deg_b)
    return floprc, total_flop, z_star, f_star


def proposed_predict(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                     max_deg_a: int, max_deg_b: int,
                     use_kernel: bool = False) -> PredictionDev:
    """THE PAPER'S METHOD (eq. 4) at global degree bounds: ``rows`` from
    :func:`draw_sample_rows` (or given), ``max_deg_a``/``max_deg_b`` the
    largest row degrees of A and B.  With ``use_kernel`` Algorithm 1 and
    the sampled symbolic pass run in their CUDA kernels on a CUDA tensor
    (their plain versions on a CPU tensor); the numbers are the same."""
    return _eq4(*_global_counts(a, b, rows, max_deg_a, max_deg_b,
                                use_kernel))


def reference_predict(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                      max_deg_a: int, max_deg_b: int,
                      use_kernel: bool = False) -> PredictionDev:
    """Reference design (eq. 2): Z1* = z*/p, on the counts of
    :func:`proposed_predict` (``use_kernel`` as there)."""
    return _eq2(*_global_counts(a, b, rows, max_deg_a, max_deg_b,
                                use_kernel), rows.shape[0] / a.nrows)


# --------------------------------------------------------------------------- #
# Binned prediction (DESIGN.md §4): per-bucket buffers instead of global pad.
# --------------------------------------------------------------------------- #
class PlanTables(NamedTuple):
    """A binned plan's tables for the one-launch kernels: Algorithm 1's on
    the device, and each bucket's bounds and route on the host (where the
    per-sample tables are built from them)."""

    flop: "FlopTables"      # kernels.flop_per_row.FlopTables, on the device
    deg_a: np.ndarray       # int32 (buckets,)
    deg_b: np.ndarray       # int32 (buckets,)
    esc: np.ndarray         # bool (buckets,): the bucket counts on ESC
    span: np.ndarray        # int64 (buckets,): column-extent bound (0: B's)


# id(plan) -> (weak reference to the plan, {device: PlanTables}).  A
# BinningPlan holds arrays, so it cannot be hashed; its identity keys the
# cache, and the weak reference both checks that identity and drops the
# entry when the plan goes.
_PLAN_TABLES: dict = {}


def _drop_tables(key: int, ref) -> None:
    if _PLAN_TABLES.get(key, (None,))[0] is ref:
        del _PLAN_TABLES[key]


def drop_plan_tables(plan: BinningPlan) -> None:
    """Forget ``plan``'s cached tables on every device (they are rebuilt on
    the next call of :func:`plan_tables`)."""
    entry = _PLAN_TABLES.get(id(plan))
    if entry is not None and entry[0]() is plan:
        del _PLAN_TABLES[id(plan)]


def plan_tables(plan: BinningPlan, device) -> PlanTables:
    """``plan``'s :class:`PlanTables` on ``device``, built and uploaded on
    the first call for that plan and device (one copy), then reused for as
    long as the plan lives."""
    from repro_torch.kernels.flop_per_row import flop_tables
    key = id(plan)
    entry = _PLAN_TABLES.get(key)
    if entry is None or entry[0]() is not plan:
        entry = (weakref.ref(plan, lambda ref, key=key: _drop_tables(key,
                                                                     ref)),
                 {})
        _PLAN_TABLES[key] = entry
    dev = torch.device(device)
    per_device = entry[1]
    if dev not in per_device:
        deg_a = np.array([bk.deg_a for bk in plan.buckets], dtype=np.int32)
        per_device[dev] = PlanTables(
            flop_tables(plan.row_bucket, deg_a, dev), deg_a,
            np.array([bk.deg_b for bk in plan.buckets], dtype=np.int32),
            np.array([bk.route == ROUTE_ESC for bk in plan.buckets],
                     dtype=bool),
            np.array([bk.span for bk in plan.buckets], dtype=np.int64))
    return per_device[dev]


def _rows_and_flop(rows, floprc: torch.Tensor):
    """Host copies of the sampled rows and of ``floprc`` at them: one
    read-back when the rows already lie on ``floprc``'s device."""
    if isinstance(rows, torch.Tensor) and rows.device == floprc.device:
        both = torch.stack([rows.to(floprc.dtype),
                            floprc.index_select(0, rows)]).cpu().numpy()
        return both[0].astype(np.int64), both[1]
    rows = np.asarray(_host_rows(rows), dtype=np.int64)
    idx = torch.from_numpy(rows).to(floprc.device)
    return rows, floprc.index_select(0, idx).cpu().numpy()


def esc_sample_table(plan: BinningPlan, tables: PlanTables, rows,
                     row_flop, device):
    """The :class:`~repro_torch.kernels.spgemm_symbolic.SampleTable` of the
    sampled ``rows`` (host ids, duplicates kept) that fall in ``plan``'s ESC
    buckets, each at its bucket's bounds and sized by ``row_flop`` (floprC
    at ``rows``), uploaded to ``device``; None when no sampled row falls in
    an ESC bucket."""
    from repro_torch.kernels.spgemm_symbolic import sample_table
    rows = np.asarray(rows, dtype=np.int64)
    bk = plan.row_bucket[rows]
    sel = tables.esc[bk]
    if not sel.any():
        return None
    return sample_table(rows[sel], tables.deg_a[bk[sel]],
                        tables.deg_b[bk[sel]], np.asarray(row_flop)[sel],
                        device)


def bitmask_sample_table(plan: BinningPlan, tables: PlanTables, rows,
                         row_flop, ncols_b: int, device):
    """The :class:`~repro_torch.kernels.accumulator.BitmaskTable` of the
    sampled ``rows`` (host ids, duplicates kept) that fall in ``plan``'s SPA
    and BIN buckets, each at its bucket's bounds and with the mask words
    its bucket's span allows over B's ``ncols_b`` columns, sized by
    ``row_flop`` (floprC at ``rows``), uploaded to ``device``; None when no
    sampled row falls in such a bucket."""
    from repro_torch.kernels.accumulator import bitmask_table
    rows = np.asarray(rows, dtype=np.int64)
    bk = plan.row_bucket[rows]
    sel = ~tables.esc[bk]
    if not sel.any():
        return None
    span = tables.span[bk[sel]]
    lanes = np.where(span > 0, np.minimum(span, ncols_b), ncols_b)
    return bitmask_table(rows[sel], tables.deg_a[bk[sel]],
                         tables.deg_b[bk[sel]], -(-lanes // 32),
                         np.asarray(row_flop)[sel], device)


def binned_symbolic_counts(a: CSRDevice, b: CSRDevice, rows,
                           plan: BinningPlan, use_kernel: bool = False,
                           *, floprc: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Σ over buckets of the sampled (z*, f*), each bucket at its own degree
    bounds and on its planned accumulator route — exact ints, so the totals
    equal the global-pad / all-ESC totals bit for bit whatever the
    routing.

    With ``use_kernel`` every sampled row of an ESC bucket goes to one
    launch of the fused ESC kernel and every one of a SPA or BIN bucket to
    one launch of the bitmask kernel, each row at its own bucket's bounds
    and its workspace sized by its FLOP (``floprc``, Algorithm 1's per-row
    FLOP at the buckets' bounds or above, computed by
    :func:`_binned_floprc` when not given)."""
    from repro_torch.kernels import ops as kops
    dev = a.rpt.device
    rownnz_b = torch.diff(b.rpt)         # hoisted out of the per-bucket calls
    for bucket in plan.buckets:
        kops.check_route(bucket.route)
    if not use_kernel:
        z = torch.zeros((), dtype=torch.int32, device=dev)
        f = torch.zeros((), dtype=torch.int32, device=dev)
        for bucket, sub in zip(plan.buckets, plan.subset(_host_rows(rows))):
            if sub.size == 0:
                continue        # no sampled rows landed in this bucket
            sub_d = torch.from_numpy(sub).to(dev)
            if bucket.route in (ROUTE_SPA, ROUTE_BIN):
                zb, fb = sampled_counts(
                    a, b, sub_d, bucket.deg_a, bucket.deg_b,
                    rownnz_b=rownnz_b,
                    count=lambda cols, span=bucket.span: count_distinct_dense(
                        cols, b.ncols, span))
            else:
                zb, fb = sampled_counts(a, b, sub_d, bucket.deg_a,
                                        bucket.deg_b, rownnz_b=rownnz_b)
            z = z + zb
            f = f + fb
        return z, f
    tables = plan_tables(plan, dev)
    if floprc is None:
        floprc = _binned_floprc(a, b, plan)
    rows_h, row_flop = _rows_and_flop(rows, floprc)
    esc = tables.esc[plan.row_bucket[rows_h]]
    parts = []
    if esc.any():
        table = esc_sample_table(plan, tables, rows_h, row_flop, dev)
        parts.append(kops.fused_flop_symbolic_buckets(a, b, table,
                                                      rownnz_b=rownnz_b))
    if not esc.all():
        table = bitmask_sample_table(plan, tables, rows_h, row_flop, b.ncols,
                                     dev)
        parts.append(kops.fused_flop_symbolic_bitmask_buckets(
            a, b, table, rownnz_b=rownnz_b))
    if not parts:
        zero = torch.zeros(2, dtype=torch.int32, device=dev)
        return zero[0], zero[1]
    z, f = parts[0][:2]
    for zb, fb, _ in parts[1:]:
        z, f = z + zb, f + fb
    return z, f


def exact_row_counts(a: CSRDevice, b: CSRDevice, rows, *, max_deg_a: int,
                     max_deg_b: int, route: str = "", span: int = 0,
                     use_kernel: bool = False, row_flop=None) -> np.ndarray:
    """EXACT output nnz per listed row — no sampling, no estimate.

    The same symbolic machinery as :func:`binned_symbolic_counts` (gather →
    distinct-count at the bucket's degree bounds, on the bucket's planned
    route) run over EVERY listed row instead of the sample, returning the
    per-row counts (int64) instead of the totals: the guaranteed-sufficient
    capacity source of the re-planning loop's exact fallback (DESIGN.md §9).

    Without ``use_kernel`` the plain gather and count run over the rows in
    chunks of bounded lanes (:func:`distinct_per_row`; the JAX package's
    fixed pow2 chunks bound its jit retraces, which the port does not
    have).  With ``use_kernel`` all the rows go to one
    launch in the per-row count mode of the route's symbolic kernel: ESC's
    (kernel 2, :func:`~repro_torch.kernels.spgemm_symbolic.
    exact_row_counts_esc`) or the bitmask one (kernel 4, SPA and BIN), each
    row's workspace sized by ``row_flop`` (host ints, each row's FLOP or a
    bound on it; default ``max_deg_a·max_deg_b``); on a CPU tensor the
    wrappers run their plain versions."""
    rows = np.asarray(_host_rows(rows), dtype=np.int64)
    if rows.size == 0:
        return np.zeros(0, dtype=np.int64)
    dev = a.rpt.device
    if use_kernel:
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.accumulator import bitmask_table
        from repro_torch.kernels.spgemm_symbolic import sample_table
        kops.check_route(route or ROUTE_ESC)
        da = np.full(rows.size, int(max_deg_a), dtype=np.int32)
        db = np.full(rows.size, int(max_deg_b), dtype=np.int32)
        if row_flop is None:
            row_flop = np.full(rows.size, int(max_deg_a) * int(max_deg_b),
                               dtype=np.int64)
        if route in (ROUTE_SPA, ROUTE_BIN):
            lanes = min(int(span), b.ncols) if span else b.ncols
            table = bitmask_table(rows, da, db,
                                  np.full(rows.size, -(-lanes // 32)),
                                  row_flop, dev)
            z = kops.exact_row_counts_bitmask(a, b, table)
        else:
            table = sample_table(rows, da, db, row_flop, dev)
            z = kops.exact_row_counts_esc(a, b, table)
        return z.cpu().numpy().astype(np.int64)
    count = (count_distinct_sorted if route not in (ROUTE_SPA, ROUTE_BIN)
             else lambda cols: count_distinct_dense(cols, b.ncols, span))
    z = distinct_per_row(a, b, torch.from_numpy(rows.astype(np.int32)).to(dev),
                         int(max_deg_a), int(max_deg_b), torch.diff(b.rpt),
                         count)
    return z.cpu().numpy().astype(np.int64)


def _binned_floprc(a: CSRDevice, b: CSRDevice,
                   plan: BinningPlan) -> torch.Tensor:
    """floprC of every row in one launch of the FLOP kernel, each row at its
    own bucket's deg_a bound (not the global one), from the plan's cached
    tables."""
    from repro_torch.kernels import ops as kops
    if not plan.buckets:
        return torch.zeros(0, dtype=torch.int32, device=a.rpt.device)
    return kops.flop_rows_buckets(a, b, plan_tables(plan, a.rpt.device).flop)


def proposed_predict_binned(a: CSRDevice, b: CSRDevice, rows,
                            plan: BinningPlan,
                            use_kernel: bool = False,
                            floprc=None) -> PredictionDev:
    """THE PAPER'S METHOD (eq. 4), bucket-iterated.

    Identical outputs to :func:`proposed_predict`: z*/f* are exact integer
    counts whatever the padding.  With ``use_kernel`` the per-bucket pass
    is the fused FLOP + symbolic kernels (one launch for the ESC buckets,
    one for the SPA and BIN buckets) and
    floprC runs through the FLOP kernel (one launch, each bucket at its
    bound).  ``floprc`` (Algorithm 1's per-row FLOP) may be passed in by
    callers that already computed it (the planner)."""
    if floprc is not None:
        floprc = torch.as_tensor(floprc, device=a.rpt.device)
        total_flop = floprc.sum(dtype=torch.int32)
    elif use_kernel:
        floprc = _binned_floprc(a, b, plan)
        total_flop = floprc.sum(dtype=torch.int32)
    else:
        floprc, total_flop = flop_per_row(a, b)
    z_star, f_star = binned_symbolic_counts(a, b, rows, plan, use_kernel,
                                            floprc=floprc)
    return _eq4(floprc, total_flop, z_star, f_star)


def reference_predict_binned(a: CSRDevice, b: CSRDevice, rows,
                             plan: BinningPlan,
                             use_kernel: bool = False) -> PredictionDev:
    """Reference design (eq. 2), bucket-iterated — mirrors reference_predict."""
    floprc, total_flop = flop_per_row(a, b)
    z_star, f_star = binned_symbolic_counts(a, b, rows, plan, use_kernel,
                                            floprc=floprc)
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
        # fault-injection hook (core.faults): a no-op unless a test armed
        # capacity starvation — every planned output capacity funnels here
        cap = faults_mod.scale_capacity(cap)
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


def shard_bucket_capacities(plan: BinningPlan, pred_structure, flopr,
                            bounds, safety: float = 1.2, align: int = 8,
                            pow2: bool = False, panel_structure=None,
                            panel_flopr=None
                            ) -> tuple[np.ndarray, tuple[int, ...]]:
    """Per-(bucket, shard) predicted row capacities.

    Returns ``(caps, static_caps)``: ``caps[i, s]`` is the capacity bucket
    ``i`` needs for the rows it owns inside the contiguous row range ``s``
    of ``bounds`` (0 where the intersection is empty), sized by the same
    ``min(ceil(pred·safety), flopr)`` rule as :class:`AllocationPlan` but
    restricted to that intersection; ``static_caps[i]`` is the max over
    shards (pow2-rounded under ``pow2``).  A single-device plan passes
    ``bounds=[0, M]``.

    **Column-partitioned B** (DESIGN.md §8): pass ``panel_structure`` /
    ``panel_flopr`` — each ``(n_panels, nrows)``, the per-panel predicted
    structure and per-panel FLOP from ``binning.panel_row_tables`` — and the
    capacity unit becomes (bucket, shard, panel): ``caps[i, s, p]`` sizes
    bucket ``i``'s output slots for shard ``s``'s rows restricted to panel
    ``p``, and ``static_caps[i]`` is the max over (shard, panel).
    """
    from .partition import shard_slices
    bounds = np.asarray(bounds)
    num_shards = bounds.size - 1
    # the replicated-B case is the 1-panel case: one sizing rule for both
    if panel_structure is not None:
        pps = np.asarray(panel_structure, dtype=np.float64)
        pfl = np.asarray(panel_flopr, dtype=np.float64)
    else:
        pps = np.asarray(pred_structure, dtype=np.float64)[None]
        pfl = np.asarray(flopr, dtype=np.float64)[None]
    n_panels = pps.shape[0]
    caps = np.zeros((len(plan.buckets), num_shards, n_panels),
                    dtype=np.int64)
    for i, bucket in enumerate(plan.buckets):
        lo, hi = shard_slices(bucket.rows, bounds)
        for s in range(num_shards):
            ids = bucket.rows[lo[s]:hi[s]]
            if not ids.size:
                continue
            for p in range(n_panels):
                caps[i, s, p] = AllocationPlan.from_prediction(
                    pps[p, ids], pfl[p, ids], safety=safety,
                    align=align).row_capacity
    if panel_structure is None:
        caps = caps[:, :, 0]
    if pow2:
        static_caps = tuple(ceil_pow2(int(max(align, caps[i].max())))
                            for i in range(len(plan.buckets)))
    else:
        static_caps = tuple(int(max(align, caps[i].max()))
                            for i in range(len(plan.buckets)))
    return caps, static_caps
