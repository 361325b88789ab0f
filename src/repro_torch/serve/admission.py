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
formula is kept as it is, so both packages price a plan alike.  That
formula counts bucket slots, and an unpanelled plan's ``execute`` holds
the whole ``(M, row_capacity)`` output on the device, its operands and
the kernels' temporaries besides.  So the port also prices what it really
allocates (:func:`device_price`), and on a CUDA plan
:class:`MemoryBudget` reserves the larger of the two
(:attr:`CostEstimate.reserve_bytes`); on a CPU plan it keeps JAX's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import binning as binning_mod
from repro_torch.core import profiles as profiles_mod
from repro_torch.core.csr import PLAIN_CHUNK_LANES
from repro_torch.core.errors import AdmissionRejectedError, PlanMismatchError
from repro_torch.kernels import _build as build_mod

ENTRY_BYTES = 8      # one output/operand slot: int32 col + float32 val
RPT_BYTES = 4        # one CSR row pointer
POP_PAD = 2          # pow2 population padding inflates row counts ≤ 2×
# device_price: an H100's opt-in shared memory a block and SMs, which size
# the kernels' scratch where the plan's card cannot be asked (a CPU plan)
H100_SMEM = 232_448
H100_SMS = 132
PLAIN_LANE_BYTES = 96   # the plain versions' temporaries per expanded lane
ALLOC_ROUND = 512       # the caching allocator's rounding, per tensor
PRICE_MARGIN = 2 << 20  # scalars, reduction and scan temporaries


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Per-request price: the admission controller's unit of account."""

    flop: int                # exact FLOP upper bound (Algorithm 1)
    predicted_nnz: float     # sampled-CR prediction (eq. 4)
    compression_ratio: float
    operand_bytes: int       # device uploads of A and B
    capacity_bytes: int      # ceiling on planned output buffers
    total_bytes: int         # operand + capacity: JAX's reservation
    est_seconds: float

    @property
    def reserve_bytes(self) -> int:
        """What :class:`MemoryBudget` reserves: JAX's ``total_bytes`` (a
        CUDA plan's :class:`DeviceCostEstimate` takes the larger of it and
        the port's device price)."""
        return int(self.total_bytes)

    @property
    def reserved_by(self) -> str:
        """Which price set :attr:`reserve_bytes`."""
        return "jax_estimate"

    def stats(self) -> dict:
        return dict(flop=int(self.flop),
                    predicted_nnz=round(float(self.predicted_nnz), 1),
                    compression_ratio=round(float(self.compression_ratio), 4),
                    operand_bytes=int(self.operand_bytes),
                    capacity_bytes=int(self.capacity_bytes),
                    total_bytes=int(self.total_bytes),
                    est_seconds=round(float(self.est_seconds), 6))


@dataclasses.dataclass(frozen=True)
class DeviceCostEstimate(CostEstimate):
    """A CUDA plan's price: JAX's estimate and the port's price of its real
    device allocation (:func:`device_price`); admission reserves the
    larger, and ``stats()`` says which."""

    device_bytes: int = 0

    @property
    def reserve_bytes(self) -> int:
        return max(int(self.total_bytes), int(self.device_bytes))

    @property
    def reserved_by(self) -> str:
        return ("device_price" if int(self.device_bytes)
                > int(self.total_bytes) else "jax_estimate")

    def stats(self) -> dict:
        return dict(super().stats(), device_bytes=int(self.device_bytes),
                    reserve_bytes=self.reserve_bytes,
                    reserved_by=self.reserved_by)


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
    if _on_cuda(plan):
        est = DeviceCostEstimate(**dataclasses.asdict(est),
                                 device_bytes=device_price(plan)["total"])
    return est


def _on_cuda(plan) -> bool:
    devices = (plan.mesh.devices if plan.distributed and plan.mesh
               is not None else [plan.device])
    return any(d.type == "cuda" for d in devices)


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


# --------------------------------------------------------------------------- #
# The port's device price: what plan_spgemm → execute → reassemble allocate
# on the card for one request, priced from the plan before it runs.
# --------------------------------------------------------------------------- #
def _csr_bytes(nrows: int, cap: int) -> int:
    return RPT_BYTES * (int(nrows) + 1) + ENTRY_BYTES * int(cap)


def _launch_bytes(route: str, pop: int, cap: int, deg_a: int, deg_b: int,
                  bound: int, tile_n: int, n_tiles: int, use_kernel: bool,
                  width: int, smem: int, sms: int) -> tuple[int, int]:
    """``(output, transient)`` bytes of one numeric launch over ``pop``
    rows at ``cap`` slots: the buffer it returns (kept as the unit's block
    or written into the output) and what lives only while it runs (the
    kernels' scratch and spill; the plain versions' expanded chunks and
    their concatenation).  ``width`` is the plain versions' lanes a row."""
    pop, cap = int(pop), int(cap)
    static = int(deg_a) * max(1, int(deg_b))
    bound = min(static, max(0, int(bound)))
    out = ENTRY_BYTES * pop * cap + 4 * pop
    if not pop:
        return out, 0
    if not use_kernel:
        step = max(1, PLAIN_CHUNK_LANES // max(1, width))
        lanes = min(pop, step) * max(1, width)
        return out, PLAIN_LANE_BYTES * lanes + out
    spill = ENTRY_BYTES * static if bound < static else 0
    scratch = 0
    if route == binning_mod.ROUTE_SPA:
        shape = build_mod.spa_numeric_shape(smem, int(deg_a), int(deg_b),
                                            int(tile_n), pop, sms)
        if shape.slice_bytes:
            units = shape.units
            grid = -(-pop // units)
            grid = max(1, min(grid, build_mod.SCRATCH_BYTES
                              // (units * shape.slice_bytes)))
            scratch = grid * units * shape.slice_bytes
        return out + 8, scratch
    if route == binning_mod.ROUTE_BIN and tile_n:
        shape = build_mod.bin_numeric_shape(smem, int(deg_a), bound,
                                            int(tile_n), max(1, int(n_tiles)))
        out += 16 + spill
    else:
        shape = build_mod.esc_numeric_shape(smem, int(deg_a), bound)
        out += 8 * pop + 32 + spill
    if shape.slice_bytes:
        grid = max(1, min(pop, build_mod.SCRATCH_BYTES // shape.slice_bytes))
        scratch = grid * shape.slice_bytes
    return out, scratch


def _card_limits(plan) -> tuple[int, int]:
    """The shared-memory limit and SM count that size the plan's kernels:
    its card's when it is a CUDA plan running the kernels, an H100's
    otherwise."""
    dev = plan.device
    if plan.use_kernel and dev.type == "cuda":
        return build_mod.max_smem("esc_numeric", dev), build_mod.sm_count(dev)
    return H100_SMEM, H100_SMS


def _plain_width(bk, deg_b: int, ncols_b: int) -> int:
    """The plain versions' lanes a row: its products, or its dense window
    where that is wider (SPA, BIN)."""
    width = int(bk.deg_a) * max(1, int(deg_b))
    if bk.route == binning_mod.ROUTE_SPA:
        span = int(bk.span)
        win = (binning_mod.ceil_pow2(min(span, ncols_b)) if span
               else ncols_b)
        width = max(width, win)
    elif bk.route == binning_mod.ROUTE_BIN and bk.tile_n:
        width = max(width, int(bk.tile_n) * max(1, int(bk.n_tiles)))
    return width


def _gather_bytes(nrows: int, groups: int, slots: int, kept: int) -> int:
    """``reassemble``'s temporaries for blocks of ``slots`` slots that keep
    at most ``kept`` entries: the (row × group) tables of counts, offsets
    and starts, the row pointers, the concatenated blocks and their masks,
    the gather index and the gathered entries."""
    return (8 * 4 * int(nrows) * groups + 8 * (int(nrows) + 1)
            + 9 * int(slots) + 3 * 8 * int(kept) + ENTRY_BYTES * int(kept))


def device_price(plan) -> dict:
    """The bytes ``plan_spgemm`` → ``execute`` → ``reassemble`` allocate on
    the card for this plan (the port's own allocation, not JAX's bucket
    slots): the operands at their padded capacities, the prediction's
    tables, the executor's row tables, the output (the ``(M,
    row_capacity)`` buffer, or the panel or shard blocks), the largest
    launch's temporaries (kernel scratch and spill; the plain versions'
    expanded chunks), and ``reassemble``'s.  A distributed plan is priced
    per device — its operand copies, tables and launches there, and on the
    mesh's first device the stacked blocks and the reassembly — summing the
    shares of the shards a device holds; ``total`` is the largest device's
    sum.  Re-planning's widened buffers are not priced: they depend on what
    the run finds.  Returns ``{"total", "devices": [per device dict]}``."""
    m, k = int(plan.shape_a[0]), int(plan.shape_b[0])
    ncols_b = int(plan.shape_b[1])
    smem, sms = _card_limits(plan)
    buckets = plan.binning.buckets
    n_samples = int(np.asarray(plan.sample_rows).size)
    operands = _csr_bytes(m, plan.cap_a) + _csr_bytes(k, plan.cap_b)
    predict = 16 * m + 64 * n_samples + 4 * (k + 1)
    allocs = 64

    def launch(bk, pop, cap, deg_b, bound):
        return _launch_bytes(bk.route, pop, cap, bk.deg_a, deg_b, bound,
                             bk.tile_n, bk.n_tiles, plan.use_kernel,
                             _plain_width(bk, deg_b, ncols_b), smem, sms)

    def finish(devices):
        for d in devices:
            d["total"] = int(d["persistent"] + d["transient"]
                             + ALLOC_ROUND * allocs + PRICE_MARGIN)
        return dict(total=max(d["total"] for d in devices),
                    devices=devices)

    real_slots = sum(bk.n_rows * int(c) for bk, c in
                     zip(buckets, plan.alloc.bucket_capacities))
    if not plan.distributed:
        pops = plan.local_populations()
        tables = 4 * sum(int(p) for p in pops)
        if not plan.n_panels:
            width = int(plan.alloc.row_capacity)
            bounds = plan.flop_bounds()
            worst = 0
            for bk, pop, cap, bound in zip(buckets, pops,
                                           plan.alloc.bucket_capacities,
                                           bounds):
                o, t = launch(bk, pop, cap, bk.deg_b, bound)
                worst = max(worst, o + t + 8 * int(pop))
                allocs += 8
            reasm = m * width + 3 * ENTRY_BYTES * real_slots
            persistent = (operands + predict + tables + 4 * k
                          + ENTRY_BYTES * m * width + 4 * m)
            return finish([dict(device=str(plan.device),
                                persistent=persistent,
                                transient=max(worst, reasm))])
        npan = plan.n_panels
        bounds = plan.panel_flop_bounds()
        structs = 0
        for (prpt, pcol, pidx), cap in zip(plan._panel_host,
                                           plan._panel_caps_dev):
            structs += (4 * (k + 1) + 4 * int(cap) + 8 * int(pidx.size)
                        + 4 * int(cap) + 4 * k)
        structs += 4 * int(plan._panel_b_fp[0])
        blocks, worst, slots = 0, 0, 0
        for i, (bk, pop) in enumerate(zip(buckets, pops)):
            for p in range(npan):
                cap = int(plan.panel_caps[i, p])
                o, t = launch(bk, pop, cap, plan.panel_deg_b[i],
                              bounds[i][p])
                blocks += o
                worst = max(worst, t)
                slots += int(pop) * cap
                allocs += 6
        kept = sum(bk.n_rows * int(c) for bk, row in
                   zip(buckets, plan.panel_caps) for c in row)
        persistent = operands + predict + tables + structs + blocks
        return finish([dict(device=str(plan.device), persistent=persistent,
                            transient=max(worst, _gather_bytes(
                                m, npan, slots, kept)))])

    # distributed: per distinct device of the mesh (the plan's device when
    # it was planned without one)
    devices = (list(plan.mesh.devices) if plan.mesh is not None
               else [plan.device] * plan.num_shards)
    distinct = []
    for d in devices:
        if d not in distinct:
            distinct.append(d)
    npan = max(1, plan.n_panels)
    bounds = plan.shard_flop_bounds()
    pg = plan._panel_gather
    out = []
    for dev in distinct:
        pos = [s for s, d in enumerate(devices) if d == dev]
        first = dev == devices[0]
        persistent = 4 * sum(t.table.size for t in plan.shard_tables)
        if pg is None:
            persistent += operands + 4 * k
        else:
            rs = {s // npan for s in pos}
            persistent += (_csr_bytes(m, plan.cap_a)
                           + 4 * len(rs) * int(plan.cap_a)
                           + len(pos) * (4 * (pg.nref + 1) + 4 * pg.ecap
                                         + 8 * pg.ecap + 4 * pg.nref
                                         + 4 * pg.ecap + 13 * pg.ecap)
                           + 4 * int(plan._panel_b_fp[0]))
        if first:
            persistent += predict + _csr_bytes(k, plan.cap_b)
        worst = 0
        for i, (bk, t) in enumerate(zip(buckets, plan.shard_tables)):
            deg_b = plan.panel_deg_b[i] if plan.n_panels else bk.deg_b
            for s in pos:
                o, tr = launch(bk, t.rows_pb, t.capacity, deg_b,
                               bounds[i][s])
                worst = max(worst, o + tr)
                allocs += 6
        transient = worst
        if first:
            slots = sum(t.table.size * t.capacity
                        for t in plan.shard_tables)
            persistent += sum(t.table.size * (ENTRY_BYTES * t.capacity + 4)
                              for t in plan.shard_tables)
            kept = sum(int(t.valid.sum()) * t.capacity
                       for t in plan.shard_tables)
            rows = sum(t.table.size for t in plan.shard_tables)
            transient = max(transient, _gather_bytes(m, npan, slots, kept)
                            + 40 * rows)
        out.append(dict(device=str(dev), shards=pos, persistent=persistent,
                        transient=transient))
    return finish(out)


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
        return est.reserve_bytes <= self.total

    def fits_now(self, est: CostEstimate) -> bool:
        return est.reserve_bytes <= self.remaining

    def reserve(self, est: CostEstimate) -> None:
        if not self.fits_now(est):
            raise AdmissionRejectedError(
                f"cost estimate {est.reserve_bytes} bytes exceeds remaining "
                f"budget {self.remaining}", reason="budget",
                observed=int(est.reserve_bytes), planned=int(self.remaining))
        self.reserved += est.reserve_bytes

    def release(self, est: CostEstimate) -> None:
        self.reserved = max(0, self.reserved - est.reserve_bytes)

    def stats(self) -> dict:
        return dict(total=self.total, reserved=self.reserved,
                    remaining=self.remaining)
