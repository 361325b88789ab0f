"""Admission cost model for the SpGEMM service (DESIGN.md §10).

The paper's whole point — sample a sketch, predict the compression ratio,
size buffers *before* committing resources — is exactly what a serving
front end needs as its admission model: the sampled predictor prices a
multiply (predicted FLOP + predicted nnz → bytes + seconds) before a single
executor byte is allocated.  This module turns a plan's prediction into a
:class:`CostEstimate` with two contracts the property suite pins
(``tests/test_admission.py``, held against the port in
``tests/test_torch_service.py``):

* **monotone** — scaling the predicted per-row structure or the FLOP
  upper bound up never *decreases* the estimate (an admission controller
  that prices bigger work cheaper admits its way into OOM);
* **upper bound** — ``capacity_bytes`` dominates the bytes the planner
  actually allocates for the request's output buffers, on every suite
  family, with and without ``pop_quant``/templates/panels.  Admission
  against the estimate therefore admits against a *ceiling*, never a hope.

The bound mirrors the planner's own capacity rule
(:class:`repro_torch.core.predictor.AllocationPlan`): per-row slots are
``min(ceil(structure·safety), flopr)``; every bucket's capacity is that
rule applied to a *subset* of rows, so the global max (align-8, pow2)
dominates each bucket's pow2 capacity, and pow2 population padding
inflates row counts by at most :data:`POP_PAD`.

This is the JAX package's module, reading the port's ``binning``,
``profiles`` and :class:`~repro_torch.core.plan.SpgemmPlan`; its byte
formula is kept as it is, so both packages price a plan alike.  It counts
bucket slots: an unpanelled plan's ``execute`` also holds the whole
``(M, row_capacity)`` output on the device, which the formula does not
see.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import binning as binning_mod
from repro_torch.core import profiles as profiles_mod
from repro_torch.core.errors import AdmissionRejectedError, PlanMismatchError

ENTRY_BYTES = 8      # one output/operand slot: int32 col + float32 val
RPT_BYTES = 4        # one CSR row pointer
POP_PAD = 2          # pow2 population padding inflates row counts ≤ 2×


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Per-request price: the admission controller's unit of account."""

    flop: int                # exact FLOP upper bound (Algorithm 1)
    predicted_nnz: float     # sampled-CR prediction (eq. 4)
    compression_ratio: float
    operand_bytes: int       # device uploads of A and B
    capacity_bytes: int      # ceiling on planned output buffers
    total_bytes: int         # operand + capacity: what admission reserves
    est_seconds: float

    def stats(self) -> dict:
        return dict(flop=int(self.flop),
                    predicted_nnz=round(float(self.predicted_nnz), 1),
                    compression_ratio=round(float(self.compression_ratio), 4),
                    operand_bytes=int(self.operand_bytes),
                    capacity_bytes=int(self.capacity_bytes),
                    total_bytes=int(self.total_bytes),
                    est_seconds=round(float(self.est_seconds), 6))


def capacity_bound_rows(structure, flopr, safety: float) -> int:
    """Pow2 per-row slot ceiling: dominates every bucket capacity the
    planner derives from (a subset of) the same prediction."""
    ps = np.asarray(structure, dtype=np.float64)
    fl = np.asarray(flopr, dtype=np.float64)
    if not ps.size:
        return 8
    per_row = np.minimum(np.ceil(ps * float(safety)), fl)
    cap = int(max(0.0, per_row.max(initial=0.0)))
    cap = max(8, ((cap + 7) // 8) * 8)
    return binning_mod.ceil_pow2(cap)


def estimate(nrows: int, structure, flopr, cr: float, *,
             nnz_a: int, nnz_b: int, nrows_b: int,
             safety: float = 1.3, n_panels: int = 0) -> CostEstimate:
    """Price a request from its prediction (no plan object required)."""
    fl = np.asarray(flopr, dtype=np.float64)
    total_flop = int(fl.sum())
    cap_rows = capacity_bound_rows(structure, fl, safety)
    units = max(1, int(n_panels))
    capacity_bytes = POP_PAD * int(nrows) * units * cap_rows * ENTRY_BYTES
    # pow2 operand caps ≤ 2×nnz (+ the 8-slot floor per panel slice)
    operand_bytes = (2 * max(8, int(nnz_a))
                     + 2 * int(nnz_b) + 8 * units) * ENTRY_BYTES \
        + (int(nrows) + 1 + (int(nrows_b) + 1) * units) * RPT_BYTES
    total_bytes = capacity_bytes + operand_bytes
    # device model for the time estimate: the active measured profile
    # (core.profiles, ESC-derived effective FLOP/s and bytes/s) when one
    # is loaded, analytic placeholders otherwise — serving needs *relative*
    # prices for deadline triage, not a calibrated roofline
    flops, bytes_per_s = profiles_mod.throughput()
    est_seconds = total_flop / flops + total_bytes / bytes_per_s
    ps = np.asarray(structure, dtype=np.float64)
    return CostEstimate(
        flop=total_flop,
        predicted_nnz=float(ps.sum()) if ps.size else 0.0,
        compression_ratio=float(cr),
        operand_bytes=int(operand_bytes),
        capacity_bytes=int(capacity_bytes),
        total_bytes=int(total_bytes),
        est_seconds=float(est_seconds))


def deadline_feasible(est: CostEstimate, deadline: float | None,
                      now: float) -> bool:
    """Can the request possibly meet its deadline?  A request whose priced
    ``est_seconds`` already exceeds the time remaining can NEVER finish in
    time — admitting it burns a dispatch wave to produce a result nobody
    will accept, so the service rejects it typed at planning time."""
    if deadline is None:
        return True
    return now + float(est.est_seconds) <= float(deadline)


def estimate_cost(plan) -> CostEstimate:
    """Price a planned request from the plan's own sampled prediction —
    the admission path of :class:`repro_torch.serve.spgemm_service.
    SpgemmService`
    (plan host-side first, admit against the ceiling, only then execute).

    The formula bound already dominates the plan's own capacities; a
    template grown by OTHER family members can exceed the member-local
    formula, so the ceiling is maxed with the exactly-planned bytes."""
    est = estimate(
        plan.shape_a[0], plan.structure, plan.flopr,
        plan.compression_ratio, nnz_a=plan.cap_a, nnz_b=plan.cap_b,
        nrows_b=plan.shape_b[0], safety=plan.safety,
        n_panels=plan.n_panels)
    actual = planned_bytes(plan)
    if actual > est.capacity_bytes:
        est = dataclasses.replace(
            est, capacity_bytes=actual,
            total_bytes=actual + est.operand_bytes)
    return est


def planned_bytes(plan) -> int:
    """The bytes the planner ACTUALLY allocated for output buffers — what
    ``CostEstimate.capacity_bytes`` must dominate (property-pinned): the
    slots of every (bucket[× panel]) unit at its launched population."""
    if plan.n_panels:
        pops = plan.local_populations()
        return int(sum(int(pop) * int(c) * ENTRY_BYTES
                       for pop, row in zip(pops, plan.panel_caps)
                       for c in row))
    return int(sum(int(pop) * int(c) * ENTRY_BYTES
                   for pop, c in zip(plan.local_populations(),
                                     plan.alloc.bucket_capacities)))


class MemoryBudget:
    """Byte ledger for admission: reserve at dispatch, release at terminal.

    The service is synchronous per dispatch wave, so the ledger's job is
    bounding the BATCH (how many same-template requests ride one wave) and
    rejecting requests that could never fit — not racing concurrent
    executors."""

    def __init__(self, total_bytes: int) -> None:
        if int(total_bytes) <= 0:
            raise PlanMismatchError(
                f"device budget must be positive, got {total_bytes}")
        self.total = int(total_bytes)
        self.reserved = 0

    @property
    def remaining(self) -> int:
        return self.total - self.reserved

    def fits_ever(self, est: CostEstimate) -> bool:
        return est.total_bytes <= self.total

    def fits_now(self, est: CostEstimate) -> bool:
        return est.total_bytes <= self.remaining

    def reserve(self, est: CostEstimate) -> None:
        if not self.fits_now(est):
            raise AdmissionRejectedError(
                f"cost estimate {est.total_bytes} bytes exceeds remaining "
                f"budget {self.remaining}", reason="budget",
                observed=int(est.total_bytes), planned=int(self.remaining))
        self.reserved += est.total_bytes

    def release(self, est: CostEstimate) -> None:
        self.reserved = max(0, self.reserved - est.total_bytes)

    def stats(self) -> dict:
        return dict(total=self.total, reserved=self.reserved,
                    remaining=self.remaining)
