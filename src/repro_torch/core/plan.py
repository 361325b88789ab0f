"""SpGEMM planner/executor on one device, with a signature-keyed executor cache.

The paper's whole point end to end (DESIGN.md §6), single-device subset of
``repro.core.plan``:

  1. **sample → predict**: the binned sampled-CR predictor
     (``predictor.proposed_predict_binned``, eq. 4);
  2. **capacities per bucket**: each degree bucket's output buffer is sized
     from the prediction restricted to that bucket's rows
     (``predictor.BinnedAllocationPlan``);
  3. **execute through the binned kernels**: every bucket runs through
     ``spgemm.routed_spgemm_rows`` on its planned accumulator route (ESC,
     SPA or BIN; with ``use_kernel`` through that route's CUDA kernel);
  4. **re-plan on overflow** (``retry_safety``/``retry_policy``, DESIGN.md
     §7, §9): the numeric kernels report each row's true nnz even where its
     capacity truncates it, so :func:`execute` re-runs ONLY the overflowing
     buckets at pow2-bumped capacities and splices them into the output on
     the device; when the ladder runs out it falls back once to an exact
     symbolic count of the offending buckets
     (``predictor.exact_row_counts``: kernels 2 and 4 in their per-row
     count mode).

Executors are built once per *plan key* — matrix shapes, padded device-CSR
capacities and the ordered per-bucket ``(signature, population, capacity)``
tuples — so repeated same-structure SpGEMMs reuse one executor;
``PlanCache.stats()["traces"]`` counts executor builds.  **Population
quantization** (``pop_quant=True``) pow2-pads the populations, degree bounds
and capacities in the key, so same-family different-seed matrices share
executors at ≤ 2× row padding; a :class:`PlanTemplate` (``template=...`` or
``template="auto"``) freezes a family's bucket ladder, and every member
planned after its last growth lands on one key.

**Column-partitioned B** (``n_panels=P``, DESIGN.md §8): B is split into
``P`` contiguous column panels (``partition.column_panels``), each bucket's
capacity is sized per panel from the per-panel FLOP table
(``binning.panel_row_tables``), and :func:`execute` runs one launch of the
bucket's numeric kernel per (bucket × panel) unit against that panel's
operand, each into its own block (:class:`~repro_torch.core.spgemm.
PanelSpgemmOut`) — no ``(M, row_capacity)`` output exists.  Re-planning's
unit is then (bucket × panel).

**Failure containment** (DESIGN.md §9): every executor dispatch goes
through :func:`_invoke_executor`, which fires the fault-injection hook
(``core.faults``) and turns any failure inside the executor into a typed
:class:`~repro_torch.core.errors.ShardFailureError` naming the unit.  A
plan armed with a :class:`DispatchBudget` (the straggler watchdog,
DESIGN.md §12) also times each wave against its priced seconds
(``core.profiles``); a wave that blows its budget raises a typed
:class:`~repro_torch.core.errors.StragglerError` and replays unit by unit
through ``core.recovery``, bitwise equal to the clean wave.

**Distributed plans** (``mesh=`` a :class:`~repro_torch.core.mesh.Mesh`,
or ``num_shards=`` to plan without devices): the rows are partitioned into
contiguous shards on the predicted structure (``partition.
balanced_contiguous``), every bucket gets a per-shard row table
(:class:`BucketShardTable`) and a per-shard capacity, and :func:`execute`
runs shard ``s``'s tables on ``mesh.devices[s]`` — one process drives the
mesh, as JAX's ``shard_map`` does, with A and B uploaded once per distinct
device and each bucket's output stacked per shard on the mesh's first
device (:class:`DistSpgemmOut`).  With ``n_panels`` the panel axis folds
onto the shard axis (device ``d = s·P + p``), and each device receives
only the panel entries of the B rows its row shard references
(:class:`PanelGather`).  A failed or lost shard's wave re-executes unit by
unit and re-homes the lost shard's rows on the survivors
(``core.recovery``).

**Spans and counters** (``core.tracing``): while a profiler records,
:func:`plan_spgemm` and :func:`execute` open the ranges ``repro_torch.plan``
(``.validate``, ``.bin``, ``.flop``, ``.upload``, ``.predict``, ``.alloc``,
``.panels``) and ``repro_torch.execute`` (``.operands``, ``.dispatch``,
``.readback``, ``.replan``; a distributed plan's execute has the outer
range alone); the counters ``plan.rows`` and ``replan.rows`` are always
on.

Public API::

    plan = plan_spgemm(a, b, use_kernel=True)   # route="auto"
    out  = execute(plan, a, b)                  # SpGEMMOut
    c    = reassemble(plan, out, ncols=b.ncols) # host CSR
    plan = plan_spgemm(a, b, n_panels=4)        # column panels
    out  = execute(plan, a, b)                  # PanelSpgemmOut
    plan = plan_spgemm(a, b, mesh=make_mesh((4,), ("data",)))
    out  = execute(plan, a, b)                  # DistSpgemmOut
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build as build_mod
from repro_torch.sparse.formats import CSR
from . import binning as binning_mod
from . import csr as csr_mod
from . import faults as faults_mod
from . import mesh as mesh_mod
from . import oracle
from . import partition as part_mod
from . import predictor as predictor_mod
from . import profiles as profiles_mod
from . import tracing
from . import validate as validate_mod
from .csr import COL_SENTINEL, CSRDevice
from .errors import (CapacityExhaustedError, OperandValidationError,
                     PlanMismatchError, ShardFailureError, SpgemmError,
                     StragglerError)
from .spgemm import (PanelSpgemmOut, SpGEMMOut, assemble,
                     routed_spgemm_rows)


class PlanCache:
    """Maps plan keys to built executors.

    ``hits``/``misses`` count executor lookups; ``traces`` counts executor
    builds, so a cache-served SpGEMM over a same-shaped bucket set leaves
    ``traces`` unchanged."""

    def __init__(self) -> None:
        self._executors: dict = {}
        self.hits = 0
        self.misses = 0
        self.traces = 0

    def executor(self, key, build):
        """Get-or-build the executor for ``key`` (hashable plan key)."""
        if key in self._executors:
            self.hits += 1
        else:
            self.misses += 1
            self.traces += 1
            self._executors[key] = build()
        return self._executors[key]

    def stats(self) -> dict:
        return dict(size=len(self._executors), hits=self.hits,
                    misses=self.misses, traces=self.traces)

    def clear(self) -> None:
        self._executors.clear()
        self.hits = self.misses = self.traces = 0


_DEFAULT_CACHE = PlanCache()


def plan_cache() -> PlanCache:
    """The session-level default plan cache."""
    return _DEFAULT_CACHE


# --------------------------------------------------------------------------- #
# Retry escalation policy (DESIGN.md §9)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry escalation for the overflow re-planning loop.

    ``rounds`` pow2-bump ladder rounds (``×growth^attempt``, floored at the
    observed need) with an optional per-round capacity ceiling
    ``max_capacity``; when the ladder runs out (no budget, or every bump
    ceiling-clamped) and ``exact_fallback`` is on, the loop escalates ONCE
    to an exact symbolic count (``predictor.exact_row_counts``) of only the
    offending buckets — termination in ≤ ``rounds``+1 re-execute waves with
    the output of an ample plan, recorded in ``plan.stats()
    ["degradations"]``.  Residual overflow after that (only possible with
    the fallback off) follows ``on_exhausted``: ``"raise"`` raises a typed
    :class:`~repro_torch.core.errors.CapacityExhaustedError`; ``"surface"``
    leaves the overflow on the result, and :func:`reassemble` raises.
    """

    rounds: int = 4
    growth: float = 1.5
    max_capacity: int | None = None
    exact_fallback: bool = True
    on_exhausted: str = "raise"       # "raise" | "surface"

    def __post_init__(self):
        if self.rounds < 0:
            raise PlanMismatchError(f"RetryPolicy.rounds must be >= 0, got "
                                    f"{self.rounds}")
        if self.on_exhausted not in ("raise", "surface"):
            raise PlanMismatchError(
                f"RetryPolicy.on_exhausted must be 'raise' or 'surface', "
                f"got {self.on_exhausted!r}")

    def clamp(self, cap: int, new_cap: int) -> int:
        """Apply the per-round ceiling; never shrink below the current cap."""
        if self.max_capacity is None:
            return new_cap
        return min(new_cap, max(int(self.max_capacity), cap))


@dataclasses.dataclass(frozen=True)
class DispatchBudget:
    """Straggler watchdog for executor dispatches (DESIGN.md §12).

    A plan armed with a budget (``plan_spgemm(dispatch_budget=...)``) times
    every wave/recovery dispatch through :func:`_invoke_executor` and raises
    a typed :class:`~repro_torch.core.errors.StragglerError` when the
    dispatch exceeds ``multiple ×`` the PRICED expected seconds — per-unit
    seconds from :func:`repro_torch.core.profiles.unit_seconds` (a measured
    profile when one is active, the analytic roofline otherwise) — floored
    at ``floor_s`` so tiny dispatches never trip on scheduler noise.
    Pricing rule::

        limit = max(floor_s, multiple · Σ_units unit_seconds(route, w, span, rows))

    Two exemptions keep the watchdog deterministic: the first dispatch of
    an executor, and any dispatch during which a kernel library was loaded
    (or built), never count their real wall time — loading is not a
    straggler — and injected ``delay_executor`` seconds always count, so
    chaos tests exercise the full straggler → recovery path without real
    sleeps.
    """

    multiple: float = 10.0
    floor_s: float = 0.05

    def limit(self, priced_s: float) -> float:
        return max(float(self.floor_s),
                   float(self.multiple) * max(0.0, float(priced_s)))


@dataclasses.dataclass(frozen=True)
class BucketShardTable:
    """One bucket's static shard execution table (distributed plans).

    ``table[s]`` lists the bucket rows shard ``s`` computes, padded to the
    bucket's max per-shard population ``rows_pb`` by repeating the shard's
    last owned row (or any bucket row when the shard owns none — padded
    outputs are masked off by ``valid`` at reassembly/overflow time).
    """

    table: np.ndarray       # (num_shards, rows_pb) int32
    valid: np.ndarray       # (num_shards, rows_pb) bool
    capacity: int           # static per-row output slots (max per-shard need)

    @property
    def rows_pb(self) -> int:
        return int(self.table.shape[1])


class DistSpgemmOut(NamedTuple):
    """Distributed numeric-phase output: per-bucket stacked shard blocks,
    on the mesh's first device."""

    cols: tuple        # per bucket: (num_shards, rows_pb, cap_b) int32
    vals: tuple        # per bucket: (num_shards, rows_pb, cap_b) float32
    row_nnz: tuple     # per bucket: (num_shards, rows_pb) int32 — true nnz
    shard_overflow: np.ndarray   # (num_shards,) int64 — valid rows only


def _plan_key_id(plan) -> str:
    """Short stable fingerprint of ``plan.key`` for error context."""
    return format(hash(plan.key) & 0xFFFFFFFF, "08x")


@dataclasses.dataclass(eq=False)   # identity compare; plans match via .key
class SpgemmPlan:
    """The plan: prediction + partition + capacities + executor key.
    ``device`` is where the prediction ran and where a single-device plan
    executes; a distributed plan executes on its mesh's devices."""

    binning: binning_mod.BinningPlan
    alloc: predictor_mod.BinnedAllocationPlan
    structure: np.ndarray           # predicted nnz per output row (float64)
    flopr: np.ndarray               # FLOP per output row (int64)
    predicted_nnz: float
    compression_ratio: float
    sample_rows: np.ndarray
    shape_a: tuple[int, int]
    shape_b: tuple[int, int]
    cap_a: int                      # device-CSR col/val capacity (pow2-padded)
    cap_b: int
    safety: float
    use_kernel: bool
    device: torch.device
    # plan-key quantization + overflow re-planning (DESIGN.md §7, §9)
    pop_quant: bool = False         # pow2-padded populations/degrees/caps
    retries: int = 0                # rounds the last execute() needed
    retry_events: list = dataclasses.field(default_factory=list)  # last execute()
    retry_policy: RetryPolicy | None = None      # None → re-planning off
    degradations: list = dataclasses.field(default_factory=list)  # last execute()
    # the straggler watchdog (DESIGN.md §12); None → dispatches untimed
    dispatch_budget: DispatchBudget | None = None
    recoveries: list = dataclasses.field(default_factory=list)  # last execute()
    # plan_spgemm's max_retries: a recovery unit's dispatch attempts when no
    # retry policy is set (the JAX plan's max_retries field)
    _max_retries: int = 4
    validation: dict = dataclasses.field(
        default_factory=lambda: dict(operands_validated=0,
                                     fingerprint_checks=0))
    # column-partitioned B (DESIGN.md §8); n_panels == 0 → whole-B mode
    n_panels: int = 0
    panels: part_mod.PanelPartition | None = None
    panel_deg_b: tuple = ()         # per-bucket panel deg_b bound (≤ full deg_b)
    panel_caps: np.ndarray | None = None   # (buckets, n_panels) current caps
    _panel_host: tuple | None = dataclasses.field(default=None, repr=False)
    _panel_caps_dev: tuple = ()     # per-panel operand capacities
    # (n_panels, M) FLOP of each row restricted to each panel (host)
    _panel_flopr: np.ndarray | None = dataclasses.field(default=None,
                                                        repr=False)
    _panel_bounds: tuple | None = dataclasses.field(default=None, repr=False)
    # per-panel operand structure uploaded once per plan: single-device,
    # a tuple of (rpt, col, entry index into b.val) per panel; distributed,
    # per mesh key the panel gather's arrays on each distinct device
    _panel_dev: object = dataclasses.field(default=None, repr=False)
    # the PLANNED B's (nnz, col-sum) fingerprint and its (rpt, col) copy:
    # the panel slices bake B's structure in, so execute() rejects an
    # operand of another structure instead of silently pairing its values
    # with the wrong entries
    _panel_b_fp: tuple | None = None
    _panel_b_structure: tuple | None = dataclasses.field(default=None,
                                                         repr=False)
    # distributed-only (num_shards == 0 → single device)
    num_shards: int = 0
    axis: str = "data"
    partition: part_mod.Partition | None = None
    shard_tables: tuple = ()        # BucketShardTable per bucket
    shard_capacities: np.ndarray | None = None  # (buckets, shards) needs
    mesh: object = None             # not part of the key (see _mesh_key)
    row_shards: int = 0             # with panels: num_shards // n_panels
    _panel_gather: object = None    # PanelGather (distributed panel operands)
    _panel_a_fp: tuple | None = None
    _panel_a_structure: tuple | None = dataclasses.field(default=None,
                                                         repr=False)
    # per mesh key: each shard's row tables on its device, uploaded once
    _shard_dev: dict = dataclasses.field(default_factory=dict, repr=False)
    _shard_bounds: tuple | None = dataclasses.field(default=None, repr=False)
    _template: object = None        # PlanTemplate this plan was fit against
    _pop_override: tuple | None = dataclasses.field(default=None, repr=False)
    _host_tables: tuple | None = dataclasses.field(default=None, repr=False)
    _device_args: tuple | None = dataclasses.field(default=None, repr=False)
    _flop_bounds: tuple | None = dataclasses.field(default=None, repr=False)
    # ((host_a, host_b), (ad, bd)) from planning — execute() on the planned
    # operands reuses the prediction pass's upload instead of a second copy
    _planned_pair: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def distributed(self) -> bool:
        return self.num_shards > 0

    @property
    def retry_safety(self) -> float:
        """The policy's growth factor (0 when re-planning is off)."""
        return self.retry_policy.growth if self.retry_policy else 0.0

    @property
    def max_retries(self) -> int:
        """The policy's ladder rounds (0 when re-planning is off)."""
        return self.retry_policy.rounds if self.retry_policy else 0

    def local_populations(self) -> tuple[int, ...]:
        """Per-bucket rows the executor launches — the exact populations,
        their pow2 pads under ``pop_quant``, or the template's grown pads
        when planned against one."""
        if self._pop_override is not None:
            return self._pop_override
        if self.pop_quant:
            return tuple(binning_mod.ceil_pow2(bk.n_rows)
                         for bk in self.binning.buckets)
        return tuple(bk.n_rows for bk in self.binning.buckets)

    def host_tables(self) -> tuple:
        """Each bucket's row table as launched (int32, host): its rows, and
        under ``pop_quant`` padded to :meth:`local_populations` by repeating
        its last row (row 0 for a bucket a template member leaves empty).
        The validity mask of a padded table is its first ``n_rows`` entries:
        pad rows come last, so assembly and the overflow count cut them off
        by length (:meth:`valid_rows`)."""
        if self._host_tables is None:
            if not self.pop_quant:
                self._host_tables = tuple(bk.rows
                                          for bk in self.binning.buckets)
            else:
                tables = []
                for bk, pop in zip(self.binning.buckets,
                                   self.local_populations()):
                    ids = np.empty(pop, dtype=np.int32)
                    ids[:bk.n_rows] = bk.rows
                    ids[bk.n_rows:] = bk.rows[-1] if bk.n_rows else 0
                    tables.append(ids)
                self._host_tables = tuple(tables)
        return self._host_tables

    def valid_rows(self) -> tuple[int, ...]:
        """Real (unpadded) rows at the head of each launched table."""
        return tuple(bk.n_rows for bk in self.binning.buckets)

    def device_args(self) -> tuple:
        """Executor row tables (:meth:`host_tables`), uploaded once per
        plan."""
        if self._device_args is None:
            self._device_args = tuple(
                torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32)).to(
                    self.device) for t in self.host_tables())
        return self._device_args

    def flop_bounds(self) -> tuple:
        """Each launched table's largest row FLOP (``flopr``, pad rows
        included: an empty template bucket launches row 0), the bound the
        numeric kernels size their workspaces by.  It travels with every
        call, beside :meth:`device_args`, and never enters :attr:`key`: a
        cached executor serves same-keyed plans whose rows carry other
        FLOP."""
        if self._flop_bounds is None:
            self._flop_bounds = tuple(
                int(self.flopr[t].max()) if t.size else 0
                for t in self.host_tables())
        return self._flop_bounds

    def panel_flop_bounds(self) -> tuple:
        """Per bucket, per panel: the launched table's largest row FLOP
        restricted to that panel — each (bucket × panel) unit's own bound,
        which sizes the ESC and BIN kernels' workspaces (a row's panel
        products are a subset of its products, so it never passes
        :meth:`flop_bounds`).  Like :meth:`flop_bounds`, never in
        :attr:`key`."""
        if self._panel_bounds is None:
            self._panel_bounds = tuple(
                tuple(int(fp[t].max()) if t.size else 0
                      for fp in self._panel_flopr)
                for t in self.host_tables())
        return self._panel_bounds

    def shard_flop_bounds(self) -> tuple:
        """Per bucket, per shard (per device ``d = s·P + p`` with panels):
        the largest FLOP of the rows that shard's table launches, pad rows
        included, restricted to its panel with panels — each (bucket ×
        shard) unit's own bound, as :meth:`flop_bounds` is a bucket's.
        Never in :attr:`key`."""
        if self._shard_bounds is None:
            out = []
            for t in self.shard_tables:
                per = []
                for d in range(t.table.shape[0]):
                    fl = (self._panel_flopr[d % self.n_panels]
                          if self.n_panels else self.flopr)
                    per.append(int(fl[t.table[d]].max())
                               if t.table.shape[1] else 0)
                out.append(tuple(per))
            self._shard_bounds = tuple(out)
        return self._shard_bounds

    @property
    def key(self) -> tuple:
        """The static half of the executor contract (the mesh's fingerprint
        is added at executor lookup, :func:`_executor_key`), laid out as the
        JAX package's key."""
        if self.n_panels:
            # panel plans key on the panel layout (quantized edges), the
            # operand capacities, and per-bucket panel degree bounds and
            # capacities — the whole numeric contract of §8
            if self.distributed:
                buckets = tuple(
                    (bk.signature, db, t.rows_pb, t.capacity)
                    for bk, db, t in zip(self.binning.buckets,
                                         self.panel_deg_b, self.shard_tables))
                pan = (self.panels.key, self.row_shards,
                       self._panel_gather.nref, self._panel_gather.ecap)
            else:
                buckets = tuple(
                    (bk.signature, db, pop,
                     tuple(int(c) for c in self.panel_caps[i]))
                    for i, (bk, db, pop) in enumerate(
                        zip(self.binning.buckets, self.panel_deg_b,
                            self.local_populations())))
                pan = (self.panels.key, self._panel_caps_dev)
            return ("spgemm-plan-panels", self.num_shards, self.axis,
                    self.use_kernel, self.pop_quant, self.shape_a,
                    self.shape_b, self.cap_a, buckets, pan)
        if self.distributed:
            buckets = tuple(
                (bk.signature, t.rows_pb, t.capacity)
                for bk, t in zip(self.binning.buckets, self.shard_tables))
        else:
            buckets = tuple(
                (bk.signature, pop, int(cap))
                for bk, pop, cap in zip(self.binning.buckets,
                                        self.local_populations(),
                                        self.alloc.bucket_capacities))
        return ("spgemm-plan", self.num_shards, self.axis, self.use_kernel,
                self.pop_quant, self.shape_a, self.shape_b, self.cap_a,
                self.cap_b, self.alloc.row_capacity, buckets)

    def shard_slots(self) -> int:
        """Output slots each shard allocates under this plan
        (Σ buckets rows_pb·capacity; identical on every shard)."""
        if not self.distributed:
            return int(self.alloc.total_capacity)
        return int(sum(t.rows_pb * t.capacity for t in self.shard_tables))

    def comm_stats(self) -> dict:
        """Per-device B footprint + gather volume of a panel-distributed plan
        vs the replicated-B executor — the §8 acceptance metric.  On a
        single-controller mesh the gather is an index gather on each device,
        so these are the bytes a device holds and receives, not a transfer
        that was timed."""
        if not (self.n_panels and self.distributed):
            raise PlanMismatchError(
                "comm_stats needs a distributed panel plan",
                plan_key=_plan_key_id(self))
        pg = self._panel_gather
        # index+value bytes per entry (int32 col + float32 val) + rpt words
        rep_bytes = self.cap_b * 8 + (self.shape_b[0] + 1) * 4
        dev_bytes = pg.ecap * 8 + (pg.nref + 1) * 4
        payload_max = int(pg.ref_nnz.max()) if pg.ref_nnz.size else 0
        nnz_b = int(self._panel_b_fp[0])
        return dict(
            n_panels=self.n_panels,
            devices=self.num_shards,
            row_shards=self.row_shards,
            replicated_b_bytes=int(rep_bytes),
            per_device_b_bytes=int(dev_bytes),
            footprint_reduction=round(rep_bytes / max(1, dev_bytes), 3),
            b_nnz=nnz_b,
            payload_entries_max=payload_max,
            payload_reduction=round(nnz_b / max(1, payload_max), 3),
            gathered_entries_total=int(pg.ref_nnz.sum()),
            gathered_bytes_total=int(pg.ref_nnz.sum()) * 8,
        )

    def release_device(self) -> None:
        """Drop every device buffer the plan caches — the prediction pass's
        operand uploads, the row tables, the panel structure, the
        prediction's tables — so that a plan kept only for its record holds
        no device memory; they are uploaded again by the next
        :func:`execute`.  The service calls it when a request ends."""
        self._planned_pair = None
        self._device_args = None
        self._panel_dev = None
        self._shard_dev = {}
        predictor_mod.drop_plan_tables(self.binning)

    def to_device(self, m: CSR, which: str) -> CSRDevice:
        """Convert one operand at the plan's padded device capacity."""
        cap = self.cap_a if which == "a" else self.cap_b
        shape = self.shape_a if which == "a" else self.shape_b
        validate_mod.validate_csr(m, name=which)
        if m.shape != shape:
            raise PlanMismatchError(
                f"operand {which} shape {m.shape} != planned {shape}",
                operand=which, observed=list(m.shape), planned=list(shape),
                plan_key=_plan_key_id(self))
        if m.nnz > cap:
            raise PlanMismatchError(
                f"operand {which} nnz {m.nnz} exceeds planned device "
                f"capacity {cap}", operand=which, observed=int(m.nnz),
                planned=int(cap), plan_key=_plan_key_id(self))
        return csr_mod.to_device(m, capacity=cap, device=self.device)

    def stats(self) -> dict:
        out = dict(
            predicted_nnz=round(float(self.predicted_nnz), 1),
            compression_ratio=round(float(self.compression_ratio), 4),
            num_buckets=len(self.binning.buckets),
            lane_reduction=round(self.binning.lane_reduction, 3),
            route_rows=self.binning.route_rows(),
            route_profile=profiles_mod.status(),
            bucket_capacities=list(self.alloc.bucket_capacities),
            total_capacity=int(self.alloc.total_capacity),
            device=str(self.device),
        )
        if self.distributed:
            out.update(
                num_shards=self.num_shards,
                imbalance=round(self.partition.imbalance, 4),
                shard_slots=self.shard_slots(),
                bucket_rows_per_shard=[t.rows_pb for t in self.shard_tables],
                shard_bucket_capacities=[t.capacity
                                         for t in self.shard_tables],
            )
        if self.pop_quant:
            real = max(1, sum(bk.n_rows for bk in self.binning.buckets))
            out.update(pop_quant=True,
                       row_padding=round(sum(self.local_populations()) / real,
                                         4))
        if self.retry_policy is not None:
            out.update(retry_safety=self.retry_safety, retries=self.retries,
                       retry_events=list(self.retry_events),
                       final_capacities=(
                           [[int(c) for c in row] for row in self.panel_caps]
                           if self.n_panels else
                           [t.capacity for t in self.shard_tables]
                           if self.distributed else
                           list(self.alloc.bucket_capacities)))
        if self.n_panels:
            out.update(n_panels=self.n_panels,
                       panel_edges=[int(e) for e in self.panels.edges],
                       panel_nnz=[int(n) for n in self.panels.panel_nnz])
            if self.distributed:
                out.update(row_shards=self.row_shards,
                           comm=self.comm_stats())
        if self.dispatch_budget is not None:
            out.update(dispatch_budget=dict(
                multiple=float(self.dispatch_budget.multiple),
                floor_s=float(self.dispatch_budget.floor_s)))
        out.update(retries=int(self.retries),
                   degradations=[dict(e) for e in self.degradations],
                   validation=dict(self.validation),
                   recoveries=[dict(e) for e in self.recoveries])
        return out


# --------------------------------------------------------------------------- #
# Plan templates — the family-level executor contract (DESIGN.md §7).
#
# Per-component pow2 rounding cannot make two matrices share a key when the
# bucket LADDER itself differs (a width band present in one seed's histogram
# and absent in the other's, or a hub degree crossing a pow2 boundary).  A
# template freezes one quantized plan's static half — bucket signatures,
# padded populations, capacities, device-CSR caps — and other same-shape
# matrices plan AGAINST it: rows are assigned to the first template bucket
# whose degree bounds dominate them, populations/capacities grow (pow2,
# monotone, in place) only when a member exceeds the template, and every
# member planned after the last growth lands on the SAME plan key.
# --------------------------------------------------------------------------- #
class PlanTemplate:
    """Mutable static execution profile shared by a family of matrices.

    Build from a representative plan, then pass to
    ``plan_spgemm(template=...)``::

        tpl = PlanTemplate.from_plan(plan_spgemm(a0, b0, pop_quant=True))
        p1  = plan_spgemm(a1, b1, template=tpl)   # same key as a0·b0's plan
                                                  # unless a1/b1 outgrow it

    Growth events (``tpl.growths``) re-key subsequent plans once; members
    planned after the last growth all share one executor.
    """

    def __init__(self, shape_a, shape_b, cap_a, cap_b, sigs, pops, caps):
        self.shape_a = tuple(shape_a)
        self.shape_b = tuple(shape_b)
        self.cap_a = int(cap_a)
        self.cap_b = int(cap_b)
        self.sigs = list(sigs)      # per-bucket RowBucket.signature tuples
        self.pops = list(pops)      # pow2 padded populations
        self.caps = list(caps)      # pow2 row capacities
        self.growths = 0

    @staticmethod
    def from_plan(plan: SpgemmPlan) -> "PlanTemplate":
        if not plan.pop_quant:
            raise PlanMismatchError("templates require a pop_quant=True plan",
                                    plan_key=_plan_key_id(plan))
        return PlanTemplate(
            plan.shape_a, plan.shape_b, plan.cap_a, plan.cap_b,
            sigs=[bk.signature for bk in plan.binning.buckets],
            pops=list(plan.local_populations()),
            caps=list(plan.alloc.bucket_capacities))

    def _grow_sig(self, i: int, da: int, db: int, span: int,
                  lane_budget: int = binning_mod.DEFAULT_LANE_BUDGET) -> None:
        """Raise bucket ``i``'s static bounds to dominate (da, db, span)."""
        da0, db0, _, route, _, span0 = self.sigs[i]
        da = max(da0, binning_mod.ceil_pow2(da))
        db = max(db0, binning_mod.ceil_pow2(db))
        span = max(span0, binning_mod.ceil_pow2(span))
        blk = binning_mod._pick_block_rows(da * db, lane_budget,
                                           binning_mod.DEFAULT_MAX_BLOCK_ROWS)
        if route == binning_mod.ROUTE_SPA:
            tile, _ = binning_mod.spa_tile(span, lane_budget)
            blk = int(max(1, min(blk, binning_mod.floor_pow2(
                max(1, lane_budget // tile)))))
            self.sigs[i] = (da, db, blk, route, tile, span)
        elif route == binning_mod.ROUTE_BIN:
            tile, ntiles = binning_mod.bin_tile(span, lane_budget)
            blk = int(max(1, min(blk, binning_mod.floor_pow2(
                max(1, lane_budget // (tile * ntiles))))))
            self.sigs[i] = (da, db, blk, route, tile, span)
        else:
            self.sigs[i] = (da, db, blk, route, 0, 0)
        self.growths += 1

    def assign(self, deg_a: np.ndarray, dbmax: np.ndarray,
               spans: np.ndarray | None) -> np.ndarray:
        """Row → bucket index under degree-bound dominance (first/narrowest
        dominating bucket wins; -1 when no bucket covers the row)."""
        m = deg_a.size
        out = np.full(m, -1, dtype=np.int32)
        for i, (da, db, _blk, route, _tile, span) in enumerate(self.sigs):
            ok = (out < 0) & (deg_a <= da) & (dbmax <= db)
            if (route in (binning_mod.ROUTE_SPA, binning_mod.ROUTE_BIN)
                    and spans is not None):
                ok &= spans <= span
            out[ok] = i
        return out

    def fit(self, a, b) -> binning_mod.BinningPlan:
        """Assign every row of ``a·b`` to a template bucket, growing the
        template (monotone, pow2) where the member exceeds it, and return
        the member's :class:`~repro_torch.core.binning.BinningPlan` carrying
        the template's static bounds."""
        if a.shape != self.shape_a or b.shape != self.shape_b:
            raise PlanMismatchError(
                f"member shapes {a.shape}/{b.shape} do not match template "
                f"{self.shape_a}/{self.shape_b}",
                observed=[list(a.shape), list(b.shape)],
                planned=[list(self.shape_a), list(self.shape_b)])
        a_rpt = np.asarray(a.rpt)
        a_col = np.asarray(a.col)
        b_rpt = np.asarray(b.rpt)
        rownnz_b = np.diff(b_rpt.astype(np.int64))
        deg_a, dbmax, _width = binning_mod.row_widths(a_rpt, a_col, rownnz_b)
        need_spans = any(s[3] in (binning_mod.ROUTE_SPA,
                                  binning_mod.ROUTE_BIN) for s in self.sigs)
        spans = (binning_mod.row_spans(a_rpt, a_col, b_rpt,
                                       np.asarray(b.col))
                 if need_spans else None)
        which = self.assign(deg_a, dbmax, spans)
        if (which < 0).any():
            # grow the widest bucket to cover the escapees, then re-assign
            left = which < 0
            self._grow_sig(len(self.sigs) - 1,
                           int(deg_a[left].max(initial=1)),
                           int(dbmax[left].max(initial=1)),
                           int(spans[left].max(initial=1))
                           if spans is not None else 1)
            which = self.assign(deg_a, dbmax, spans)
            assert (which >= 0).all()
        buckets = []
        row_bucket = np.zeros(deg_a.size, dtype=np.int32)
        for i, sig in enumerate(self.sigs):
            ids = np.ascontiguousarray(
                np.flatnonzero(which == i).astype(np.int32))
            da, db, blk, route, tile, span = sig
            n_tiles = (-(-binning_mod.ceil_pow2(max(1, span)) // tile)
                       if route in (binning_mod.ROUTE_SPA,
                                    binning_mod.ROUTE_BIN) and tile else 0)
            buckets.append(binning_mod.RowBucket(
                rows=ids, deg_a=da, deg_b=db, block_rows=blk, route=route,
                tile_n=tile, n_tiles=n_tiles, span=span))
            row_bucket[ids] = i
            if ids.size > self.pops[i]:
                self.pops[i] = binning_mod.ceil_pow2(ids.size)
                self.growths += 1
        gda = int(deg_a.max()) if deg_a.size else 1
        gdb = int(rownnz_b.max()) if rownnz_b.size else 1
        return binning_mod.BinningPlan(
            buckets=tuple(buckets), nrows=deg_a.size,
            global_deg_a=max(1, gda), global_deg_b=max(1, gdb),
            row_bucket=row_bucket)

    def grow_caps(self, member_caps) -> None:
        for i, c in enumerate(member_caps):
            if int(c) > self.caps[i]:
                self.caps[i] = binning_mod.ceil_pow2(int(c))
                self.growths += 1

    def dist_profile(self, num_shards: int) -> dict:
        """Per-mesh-size static shard profile: pow2 ``rows_pb`` and per-shard
        capacities per bucket, grown monotonically like the local half
        (first use seeds from the member without counting growth)."""
        if not hasattr(self, "_dist"):
            self._dist = {}
        return self._dist.setdefault(
            int(num_shards), dict(rows_pb=[0] * len(self.sigs),
                                  caps=[0] * len(self.sigs)))

    def grow_dist(self, num_shards: int, rows_pb, caps) -> tuple[list, list]:
        d = self.dist_profile(num_shards)
        fresh = not any(d["rows_pb"])
        for i, (r, c) in enumerate(zip(rows_pb, caps)):
            if int(r) > d["rows_pb"][i]:
                d["rows_pb"][i] = binning_mod.ceil_pow2(int(r))
                self.growths += 0 if fresh else 1
            if int(c) > d["caps"][i]:
                d["caps"][i] = binning_mod.ceil_pow2(int(c))
                self.growths += 0 if fresh else 1
        return list(d["rows_pb"]), list(d["caps"])

    def grow_device_caps(self, nnz_a: int, nnz_b: int) -> None:
        if nnz_a > self.cap_a:
            self.cap_a = _device_capacity(nnz_a)
            self.growths += 1
        if nnz_b > self.cap_b:
            self.cap_b = _device_capacity(nnz_b)
            self.growths += 1

    def stats(self) -> dict:
        return dict(buckets=len(self.sigs), sigs=[list(s) for s in self.sigs],
                    pops=list(self.pops), caps=list(self.caps),
                    cap_a=self.cap_a, cap_b=self.cap_b, growths=self.growths)


# --------------------------------------------------------------------------- #
# Automatic template selection — a session registry keyed on a cheap
# structural sketch, so callers get template-level executor sharing without
# holding the PlanTemplate handle (``plan_spgemm(template="auto")``).
# --------------------------------------------------------------------------- #
def _structural_sketch(a, b) -> tuple:
    """Cheap structural fingerprint of an operand pair: exact shapes plus a
    vector of log2 degree-regime statistics (mean/median gather width, mean
    A degree, mean referenced-B degree).

    The shapes match EXACTLY (templates require it); the statistics are
    matched with a tolerance by :class:`TemplateRegistry` — any hard
    quantization boundary would split a family whose seed-to-seed jitter
    straddles it, which is exactly the fragmentation templates exist to
    remove.  Genuinely different degree regimes differ by ≥ 1 in these
    log2 stats and never match at the default tolerance."""
    rownnz_b = np.diff(np.asarray(b.rpt, dtype=np.int64))
    deg_a, dbmax, width = binning_mod.row_widths(
        np.asarray(a.rpt), np.asarray(a.col), rownnz_b)
    if width.size:
        vec = (float(np.log2(max(1.0, width.mean()))),
               float(np.log2(max(1.0, np.median(width)))),
               float(np.log2(max(1.0, deg_a.mean()))),
               float(np.log2(1.0 + dbmax.mean())))
    else:
        vec = (0.0, 0.0, 0.0, 0.0)
    return (tuple(a.shape), tuple(b.shape)), vec


# How far (in log2 space) a member's sketch statistics may sit from a
# family's and still resolve to its template.
_SKETCH_TOL = 0.75


class TemplateRegistry:
    """Session-level structural-sketch → :class:`PlanTemplate` map.

    ``plan_spgemm(template="auto")`` resolves the member's sketch here: a
    hit plans against the family's existing template (growing it if the
    member exceeds it), a miss seeds a fresh template from the member's own
    quantized plan.  Matching is shape-exact and TOLERANT on the degree
    statistics (within ``_SKETCH_TOL`` in log2 space), so same-family
    different-seed members resolve to one template even when a statistic
    sits on a quantization boundary.
    """

    def __init__(self) -> None:
        self._families: dict = {}    # shapes → [(stats_vec, PlanTemplate)]
        self.hits = 0
        self.misses = 0

    def _match(self, shapes, vec) -> PlanTemplate | None:
        for ref, tpl in self._families.get(shapes, ()):
            if max(abs(x - y) for x, y in zip(vec, ref)) <= _SKETCH_TOL:
                return tpl
        return None

    def lookup(self, a, b) -> PlanTemplate | None:
        return self._match(*_structural_sketch(a, b))

    def get_or_create(self, a, b, build) -> PlanTemplate:
        # sketch ONCE per call — it is an O(nnz) host pass over A
        shapes, vec = _structural_sketch(a, b)
        tpl = self._match(shapes, vec)
        if tpl is None:
            self.misses += 1
            tpl = build()
            self._families.setdefault(shapes, []).append((vec, tpl))
        else:
            self.hits += 1
        return tpl

    def stats(self) -> dict:
        tpls = [t for fam in self._families.values() for _, t in fam]
        return dict(size=len(tpls), hits=self.hits, misses=self.misses,
                    growths=sum(t.growths for t in tpls))


_DEFAULT_REGISTRY = TemplateRegistry()


def template_registry() -> TemplateRegistry:
    """The session-level default template registry."""
    return _DEFAULT_REGISTRY


# --------------------------------------------------------------------------- #
# Planning
# --------------------------------------------------------------------------- #
def _device_capacity(nnz: int) -> int:
    """pow2-padded device-CSR capacity: same-family matrices land on the
    same padded capacity and so on the same executor key."""
    return binning_mod.ceil_pow2(max(8, int(nnz)))


@tracing.spanned("plan")
def plan_spgemm(a: CSR, b: CSR, *, mesh=None, num_shards: int | None = None,
                axis: str = "data", seed: int = 0, safety: float = 1.3,
                route: str = "auto", use_kernel: bool = False,
                sample_rows: np.ndarray | None = None,
                min_rows: int = binning_mod.DEFAULT_MIN_ROWS,
                deg_align: int = 1, pop_quant: bool = False,
                retry_safety: float = 0.0, max_retries: int = 4,
                retry_policy: RetryPolicy | None = None,
                validate: bool = True,
                template: "PlanTemplate | str | None" = None,
                registry: TemplateRegistry | None = None,
                n_panels: int = 0,
                dispatch_budget: DispatchBudget | None = None,
                device=None) -> SpgemmPlan:
    """Plan ``C = A·B``: sample → predict (binned) → partition on predicted
    nnz → per-bucket(-per-shard) capacities.

    ``a``/``b`` are host ``CSR``; planning is a launch-time host step, and
    the prediction pass runs on ``device`` (default: the mesh's first
    device, else the CUDA card; with none present this raises unless
    ``device="cpu"`` is given).  ``route`` picks each bucket's accumulator:
    ``"auto"`` by the analytic cost model, or ``"esc"``/``"spa"``/``"bin"``
    for every bucket; the plan's buckets, prediction and capacities do not
    depend on it.

    ``mesh`` (a :class:`~repro_torch.core.mesh.Mesh`) or ``num_shards``
    selects distributed planning over the mesh axis ``axis``:
    ``num_shards`` alone plans without devices (a mesh is then given to
    :func:`execute`).

    ``pop_quant`` pow2-pads bucket populations (distributed: ``rows_pb``),
    degree bounds and capacities, so same-family different-seed matrices
    share executors at ≤ 2× row padding.  ``retry_safety`` > 0 arms the
    overflow re-planning loop of :func:`execute` (``×retry_safety^n``
    pow2-rounded capacity bumps of only the overflowing units, ≤
    ``max_retries`` rounds, the overflow surfaced after that);
    ``retry_policy`` arms it with a :class:`RetryPolicy` (by default an
    exact-symbolic fallback when the ladder runs out).  ``template``
    (implies ``pop_quant``) plans against a :class:`PlanTemplate`'s frozen
    bucket ladder instead of the member's own width histogram;
    ``template="auto"`` resolves it from ``registry`` (default: the session
    registry) by a structural sketch.

    ``n_panels`` > 0 selects **column-partitioned B** (DESIGN.md §8): B is
    split into ``n_panels`` contiguous column panels with about equal
    entries (edges snapped to a pow2 grid under ``pop_quant``), each bucket
    is sized per panel, and :func:`execute` runs one (bucket × panel) unit
    at a time against that panel's operand.  Distributed plans fold the
    panels onto the mesh axis — device ``d`` serves row shard ``d //
    n_panels`` and panel ``d % n_panels``, and ``n_panels`` must divide
    the axis size.

    ``dispatch_budget`` (a :class:`DispatchBudget`) arms the straggler
    watchdog: each wave is timed against its priced seconds and one that
    blows its budget replays unit by unit (``core.recovery``).
    """
    if mesh is not None and not isinstance(mesh, mesh_mod.Mesh):
        raise PlanMismatchError(
            f"mesh must be a repro_torch.core.mesh.Mesh, got "
            f"{type(mesh).__name__}", field="mesh")
    if mesh is not None and axis not in mesh.shape:
        raise PlanMismatchError(
            f"mesh has no axis {axis!r} (axes {list(mesh.axis_names)})",
            field="mesh", observed=list(mesh.axis_names), planned=axis)
    if device is None and mesh is not None:
        device = mesh.devices[0]
    dev = csr_mod.resolve_device(device)
    operands_validated = 0
    if validate:
        with tracing.span("plan.validate"):
            validate_mod.validate_pair(a, b)
        operands_validated = 2
    elif a.ncols != b.nrows:
        raise OperandValidationError(
            f"operand shapes {a.shape} and {b.shape} are incompatible "
            f"for A·B", observed=int(b.nrows), planned=int(a.ncols))
    retry_policy = _policy_of(retry_policy, retry_safety, max_retries)
    if isinstance(template, str):
        if template != "auto":
            raise PlanMismatchError(f"unknown template mode {template!r}")
        reg = registry if registry is not None else _DEFAULT_REGISTRY
        template = reg.get_or_create(a, b, lambda: PlanTemplate.from_plan(
            plan_spgemm(a, b, seed=seed, safety=safety, route=route,
                        use_kernel=use_kernel, sample_rows=sample_rows,
                        min_rows=min_rows, pop_quant=True, device=dev)))
    if n_panels and (mesh is not None or num_shards):
        shards_chk = int(num_shards if num_shards else mesh.shape[axis])
        if shards_chk % int(n_panels):
            raise PlanMismatchError(
                f"n_panels={n_panels} must divide the mesh axis size "
                f"{shards_chk} (panels fold onto the data axis)",
                observed=int(shards_chk), planned=int(n_panels))
    if template is not None:
        pop_quant = True
        template.grow_device_caps(a.nnz, b.nnz)
        with tracing.span("plan.bin"):
            binplan = template.fit(a, b)
    else:
        if pop_quant and deg_align <= 1:
            # quantized plans need quantized degree bounds, or the per-bucket
            # signatures (exact degree maxima) would fragment the key anyway
            deg_align = binning_mod.POW2_DEG_ALIGN
        with tracing.span("plan.bin"):
            binplan = binning_mod.build_plan(a, b, route=route,
                                             min_rows=min_rows,
                                             deg_align=deg_align)
    with tracing.span("plan.flop"):
        flopr, total_flop = oracle.flop_per_row(a, b)
    if sample_rows is None:
        sample_rows = (oracle.sample_rows(a.nrows, seed) if a.nrows
                       else np.zeros(0, dtype=np.int64))
    sample_rows = np.asarray(sample_rows, dtype=np.int64)

    if template is not None:
        cap_a, cap_b = template.cap_a, template.cap_b
    else:
        cap_a = _device_capacity(a.nnz)
        cap_b = _device_capacity(b.nnz)
    devpair = None
    if total_flop > 0 and sample_rows.size:
        with tracing.span("plan.upload"):
            ad = csr_mod.to_device(a, capacity=cap_a, device=dev)
            bd = csr_mod.to_device(b, capacity=cap_b, device=dev)
        devpair = (ad, bd)
        with tracing.span("plan.predict"):
            pred = predictor_mod.proposed_predict_binned(
                ad, bd,
                torch.from_numpy(sample_rows.astype(np.int32)).to(dev),
                binplan, use_kernel=use_kernel,
                floprc=torch.from_numpy(flopr.astype(np.int32)).to(dev))
            structure = pred.structure.cpu().numpy().astype(np.float64)
            predicted_nnz = float(pred.nnz_total)
            cr = float(pred.compression_ratio)
        if not np.isfinite(structure).all() or cr <= 0:
            # sampled rows had no products (f* = 0): fall back to the
            # upper-bound structure — always safe, never over-allocates
            # past flopr by construction of the capacity rule.
            structure = flopr.astype(np.float64)
            predicted_nnz = float(total_flop)
            cr = 1.0
        # fault-injection hook (core.faults): no-op unless a test armed
        # sketch corruption — models an unlucky sample end to end
        structure, predicted_nnz, cr = faults_mod.corrupt_sketch(
            structure, predicted_nnz, cr)
    else:
        structure = np.zeros(a.nrows, dtype=np.float64)
        predicted_nnz = 0.0
        cr = 1.0

    with tracing.span("plan.alloc"):
        alloc = predictor_mod.BinnedAllocationPlan.from_prediction(
            binplan, structure, flopr, safety=safety, pow2=pop_quant)
        if template is not None:
            # the family's grown capacities dominate the member's prediction
            template.grow_caps(alloc.bucket_capacities)
            caps = tuple(template.caps)
            alloc = predictor_mod.BinnedAllocationPlan(
                bucket_capacities=caps,
                row_capacity=max(caps) if caps else 8,
                total_capacity=sum(bk.n_rows * c
                                   for bk, c in zip(binplan.buckets, caps)),
                safety=safety)
    plan = SpgemmPlan(
        binning=binplan, alloc=alloc, structure=structure, flopr=flopr,
        predicted_nnz=predicted_nnz, compression_ratio=cr,
        sample_rows=sample_rows, shape_a=a.shape, shape_b=b.shape,
        cap_a=cap_a, cap_b=cap_b, safety=safety, use_kernel=use_kernel,
        device=dev, pop_quant=pop_quant, retry_policy=retry_policy,
        dispatch_budget=dispatch_budget, _max_retries=int(max_retries))
    plan.validation["operands_validated"] = operands_validated
    if template is not None:
        plan._template = template
        plan._pop_override = tuple(template.pops)
    if devpair is not None:
        # a panel execute never reads a whole device B: keep only A's
        # upload (and the host references, which gate the fingerprint check)
        plan._planned_pair = ((a, b), (devpair[0], None) if n_panels
                              else devpair)
    if mesh is not None or num_shards:
        structure_p = flopr_p = None
        if n_panels:
            structure_p, flopr_p = _panel_tables(plan, a, b, int(n_panels),
                                                 deg_align)
        _plan_shards(plan, a, mesh, num_shards, axis, template, structure_p,
                     flopr_p)
    elif n_panels:
        with tracing.span("plan.panels"):
            _plan_panel_caps(plan, *_panel_tables(plan, a, b, int(n_panels),
                                                  deg_align))
    tracing.count("plan.rows", a.nrows)
    return plan


def _slice_panels(b: CSR, edges: np.ndarray) -> tuple:
    """Split host B into column panels in ONE pass.

    Returns per panel ``(prpt, pcol, pidx)``: CSR row pointers over B's rows
    restricted to the panel, the (absolute) column ids, and each entry's
    index into ``b.col``/``b.val`` — the shared substrate of the per-panel
    degree tables and of the per-execute value gather."""
    col = np.asarray(b.col, dtype=np.int64)
    pid = np.searchsorted(np.asarray(edges, dtype=np.int64), col,
                          side="right") - 1
    rows_of = np.repeat(np.arange(b.nrows, dtype=np.int64), np.diff(b.rpt))
    out = []
    for p in range(len(edges) - 1):
        idx = np.flatnonzero(pid == p)
        prpt = np.zeros(b.nrows + 1, dtype=np.int64)
        if idx.size:
            np.cumsum(np.bincount(rows_of[idx], minlength=b.nrows),
                      out=prpt[1:])
        out.append((prpt, b.col[idx].astype(np.int32), idx))
    return tuple(out)


def _panel_tables(plan: SpgemmPlan, a: CSR, b: CSR, n_panels: int,
                  deg_align: int) -> tuple[np.ndarray, np.ndarray]:
    """The panel half of :func:`plan_spgemm` shared by single-device and
    distributed plans: slice B once, build the per-panel degree and FLOP
    tables, and return the per-panel predicted structure (the plan's
    sampled compression ratio applied per panel: FLOP partitions exactly
    over panels, so the panel predictions sum to the row's) and FLOP."""
    panels = part_mod.column_panels(b, n_panels, quantize=plan.pop_quant)
    pslices = _slice_panels(b, panels.edges)
    dbmax_p, flopr_p = binning_mod.panel_row_tables(
        a.rpt, a.col, [ps[0] for ps in pslices])
    structure_p = flopr_p.astype(np.float64) / max(
        float(plan.compression_ratio), 1e-9)
    dbrow = dbmax_p.max(axis=0) if dbmax_p.size else np.zeros(0, np.int64)
    panel_align = (binning_mod.POW2_DEG_ALIGN if plan.pop_quant
                   else deg_align)
    plan.n_panels = n_panels
    plan.panels = panels
    plan.panel_deg_b = tuple(
        binning_mod.round_deg(
            int(dbrow[bk.rows].max()) if bk.n_rows else 1, panel_align)
        for bk in plan.binning.buckets)
    plan._panel_host = pslices
    plan._panel_flopr = flopr_p
    plan._panel_b_fp = (int(b.nnz),
                        int(np.asarray(b.col, dtype=np.int64).sum()))
    plan._panel_b_structure = (np.array(b.rpt, dtype=np.int64),
                               np.array(b.col, dtype=np.int32))
    plan._panel_a_fp = (int(a.nnz),
                        int(np.asarray(a.col, dtype=np.int64).sum()))
    plan._panel_a_structure = (np.array(a.rpt, dtype=np.int64),
                               np.array(a.col, dtype=np.int32))
    return structure_p, flopr_p


def _plan_panel_caps(plan: SpgemmPlan, structure_p, flopr_p) -> None:
    """Single-device panel capacities: each (bucket × panel) unit runs on
    its own, so its capacity is its own panel's need."""
    pc_mat, _ = predictor_mod.shard_bucket_capacities(
        plan.binning, plan.structure, plan.flopr,
        np.array([0, plan.shape_a[0]]), safety=plan.safety,
        panel_structure=structure_p, panel_flopr=flopr_p)
    pc = np.maximum(8, pc_mat[:, 0, :])
    if plan.pop_quant:
        pc = np.array([[binning_mod.ceil_pow2(int(c)) for c in row]
                       for row in pc], dtype=np.int64).reshape(pc.shape)
    plan.panel_caps = pc.astype(np.int64)
    # fault-injection hook (core.faults): no-op unless a test armed gather
    # starvation — an under-sized operand is detected at upload, never
    # written past
    plan._panel_caps_dev = tuple(
        faults_mod.scale_gather_cap(_device_capacity(int(n)))
        for n in plan.panels.panel_nnz)


def _plan_shards(plan: SpgemmPlan, a: CSR, mesh, num_shards, axis: str,
                 template, structure_p, flopr_p) -> None:
    """The distributed half of :func:`plan_spgemm` (the JAX package's mesh
    branch): partition the rows into contiguous shards on the predicted
    structure, size every (bucket × shard[× panel]) unit, and lay out the
    per-shard row tables; with panels, fold the panel axis onto the shard
    axis (device ``d = s·P + p``) and build the panel gather."""
    shards = int(num_shards if num_shards else mesh.shape[axis])
    n_panels = plan.n_panels
    row_shards = shards // n_panels if n_panels else shards
    partn = part_mod.balanced_contiguous(plan.structure, row_shards)
    caps_mat, static_caps = predictor_mod.shard_bucket_capacities(
        plan.binning, plan.structure, plan.flopr, partn.bounds,
        safety=plan.safety, pow2=plan.pop_quant,
        panel_structure=structure_p, panel_flopr=flopr_p)
    rows_pb_list = slices = None
    if template is not None:
        # member per-bucket rows_pb (pow2) → grow the family profile, then
        # pad every table to the grown profile (the shard slices are
        # computed once and reused for the table fill)
        slices = [part_mod.shard_slices(bucket.rows, partn.bounds)
                  for bucket in plan.binning.buckets]
        member_pb = []
        for lo, hi in slices:
            counts = hi - lo
            member_pb.append(binning_mod.ceil_pow2(
                int(max(1, counts.max())) if counts.size else 1))
        rows_pb_list, static_caps = template.grow_dist(
            row_shards, member_pb, static_caps)
    plan.num_shards = shards
    plan.axis = axis
    plan.partition = partn
    tables = _build_shard_tables(plan.binning, partn, static_caps,
                                 pow2_rows=plan.pop_quant,
                                 rows_pb_list=rows_pb_list, slices=slices)
    if n_panels:
        # fold the panel axis onto the data axis: device d = s·P + p
        # repeats row shard s's table for each of its P panels
        tables = tuple(BucketShardTable(
            table=np.repeat(t.table, n_panels, axis=0),
            valid=np.repeat(t.valid, n_panels, axis=0),
            capacity=t.capacity) for t in tables)
        plan.row_shards = row_shards
        plan.panel_caps = np.tile(
            np.asarray(static_caps, dtype=np.int64)[:, None], (1, n_panels))
        plan._panel_gather = _build_panel_gather(
            a, plan._panel_host, partn.bounds, row_shards, n_panels,
            plan.cap_a, plan.pop_quant)
    plan.shard_tables = tables
    plan.shard_capacities = caps_mat
    plan.mesh = mesh


def _build_shard_tables(binplan: binning_mod.BinningPlan,
                        partn: part_mod.Partition, static_caps,
                        pow2_rows: bool = False, rows_pb_list=None,
                        slices=None) -> tuple[BucketShardTable, ...]:
    bounds = np.asarray(partn.bounds)
    num_shards = partn.num_parts
    tables = []
    for i, (bucket, cap) in enumerate(zip(binplan.buckets, static_caps)):
        lo, hi = (slices[i] if slices is not None
                  else part_mod.shard_slices(bucket.rows, bounds))
        counts = hi - lo
        rows_pb = int(max(1, counts.max())) if counts.size else 1
        if pow2_rows:
            # population quantization: pad rows_pb so same-family
            # different-seed plans share the shard executor's key
            rows_pb = binning_mod.ceil_pow2(rows_pb)
        if rows_pb_list is not None:
            # template profile: the family's grown rows_pb dominates
            rows_pb = max(rows_pb, int(rows_pb_list[i]))
        table = np.empty((num_shards, rows_pb), dtype=np.int32)
        valid = np.zeros((num_shards, rows_pb), dtype=bool)
        for s in range(num_shards):
            ids = bucket.rows[lo[s]:hi[s]]
            n = ids.size
            if n:
                table[s, :n] = ids
                table[s, n:] = ids[-1]
            else:
                # shard owns no rows of this bucket: pad with any bucket row
                # (stays inside the bucket's degree envelope; discarded) —
                # row 0 for a bucket emptied under a template
                table[s, :] = bucket.rows[0] if bucket.n_rows else 0
            valid[s, :n] = True
        tables.append(BucketShardTable(table=table, valid=valid,
                                       capacity=int(cap)))
    return tuple(tables)


@dataclasses.dataclass(frozen=True)
class PanelGather:
    """Structure-only half of the panel-gathered numeric operands.

    Built ONCE at plan time from the bucket row tables (host): device
    ``d = s·P + p`` (row shard ``s``, panel ``p``) receives ONLY the
    panel-``p`` entries of the B rows shard ``s``'s A-rows actually
    reference, as a compact CSR of ``nref`` rows.  A's column indices are
    remapped per row shard into the compact row space, so the unmodified
    numeric kernels run against the gathered operand unchanged.

    Index arrays are seed-structure only and upload once per plan and
    device; the value payload (``g_idx`` → ``b.val``) is gathered on the
    device each execute, which is what lets a revalued serving pair reuse
    every executor.
    """

    nref: int               # compact referenced-row count (padded, pow2 opt)
    ecap: int               # gathered entries per (shard, panel) (padded)
    row_shards: int
    n_panels: int
    a_col: np.ndarray       # (row_shards, cap_a) int32 remapped A columns
                            # (a shard's panels share one row)
    g_rpt: np.ndarray       # (D, nref+1) int32 compact panel row pointers
    g_col: np.ndarray       # (D, ecap) int32 absolute columns, sentinel pad
    g_idx: np.ndarray       # (D, ecap) int64 → b.val entry index, -1 pad
    ref_nnz: np.ndarray     # (D,) int64 true gathered entries (payload)


def _build_panel_gather(a: CSR, pslices, bounds, row_shards: int,
                        n_panels: int, cap_a: int,
                        pop_quant: bool) -> PanelGather:
    """Materialize the per-device gathered-B operands (host, launch-time).

    One referenced-row set per row shard (union over its buckets — shared by
    every bucket, every panel and the retry loop), one entry gather per
    (shard, panel)."""
    bounds = np.asarray(bounds, dtype=np.int64)
    nrows_b = pslices[0][0].size - 1
    a_rpt = np.asarray(a.rpt, dtype=np.int64)
    a_col_host = np.asarray(a.col, dtype=np.int64)
    nnz_a = int(a_rpt[-1])
    refs = []
    for s in range(row_shards):
        seg = a_col_host[a_rpt[bounds[s]]:a_rpt[bounds[s + 1]]]
        refs.append(np.unique(seg))
    nref = max(1, max((r.size for r in refs), default=1))
    if pop_quant:
        nref = binning_mod.ceil_pow2(nref)
    d_total = row_shards * n_panels
    # one remapped-A row per ROW SHARD — a shard's panels share it
    a_col = np.zeros((row_shards, cap_a), dtype=np.int32)
    panel_rows = [np.repeat(np.arange(nrows_b, dtype=np.int64),
                            np.diff(prpt)) for prpt, _, _ in pslices]
    sel_cols, sel_idx, sel_cnt = [], [], []
    for s in range(row_shards):
        remap = np.zeros(max(1, nrows_b), dtype=np.int64)
        remap[refs[s]] = np.arange(refs[s].size)
        in_ref = np.zeros(max(1, nrows_b), dtype=bool)
        in_ref[refs[s]] = True
        if nnz_a:
            a_col[s, :nnz_a] = remap[a_col_host].astype(np.int32)
        for p in range(n_panels):
            prpt, pcol, pidx = pslices[p]
            sel = np.flatnonzero(in_ref[panel_rows[p]])
            sel_cols.append(pcol[sel])
            sel_idx.append(pidx[sel])
            # compact row pointers: panel entries are CSR-ordered, refs are
            # ascending, so selected entries sort by compact row already
            sel_cnt.append(np.bincount(remap[panel_rows[p][sel]],
                                       minlength=nref))
    ecap = max(8, max((c.size for c in sel_cols), default=0))
    if pop_quant:
        ecap = binning_mod.ceil_pow2(ecap)
    # fault-injection hook (core.faults): no-op unless a test armed gather
    # starvation — an under-sized entry cap is DETECTED below, never written
    # past
    ecap = faults_mod.scale_gather_cap(ecap)
    g_rpt = np.zeros((d_total, nref + 1), dtype=np.int32)
    g_col = np.full((d_total, ecap), COL_SENTINEL, dtype=np.int32)
    g_idx = np.full((d_total, ecap), -1, dtype=np.int64)
    ref_nnz = np.zeros(d_total, dtype=np.int64)
    for d in range(d_total):
        e = sel_cols[d].size
        if e > ecap:
            raise ShardFailureError(
                f"panel gather entry capacity {ecap} cannot hold the "
                f"{e} entries device {d} references",
                shard=d // n_panels, panel=d % n_panels,
                observed=int(e), planned=int(ecap))
        np.cumsum(sel_cnt[d], out=g_rpt[d, 1:])
        g_col[d, :e] = sel_cols[d]
        g_idx[d, :e] = sel_idx[d]
        ref_nnz[d] = e
    return PanelGather(nref=nref, ecap=ecap, row_shards=row_shards,
                       n_panels=n_panels, a_col=a_col, g_rpt=g_rpt,
                       g_col=g_col, g_idx=g_idx, ref_nnz=ref_nnz)


# --------------------------------------------------------------------------- #
# Executors (cache-built, build-counted)
# --------------------------------------------------------------------------- #
def _bucket_meta(bucket: binning_mod.RowBucket, cap: int) -> tuple:
    """Hashable static execution metadata for one bucket."""
    return (bucket.deg_a, bucket.deg_b, bucket.block_rows, bucket.route,
            bucket.tile_n, bucket.n_tiles, bucket.span, int(cap))


def _run_bucket(ad: CSRDevice, bd: CSRDevice, rows: torch.Tensor, meta: tuple,
                use_kernel: bool, max_row_flop: int,
                rownnz_b: torch.Tensor) -> SpGEMMOut:
    deg_a, deg_b, block_rows, route, tile_n, n_tiles, span, cap = meta
    return routed_spgemm_rows(
        ad, bd, rows, row_capacity=cap, deg_a=deg_a, deg_b=deg_b,
        block_rows=block_rows, route=route, tile_n=tile_n, n_tiles=n_tiles,
        span=span, use_kernel=use_kernel, max_row_flop=max_row_flop,
        rownnz_b=rownnz_b)


def _real_rows(out: SpGEMMOut, n_valid: int, cap: int) -> SpGEMMOut:
    """A padded table's result cut to its first ``n_valid`` (real) rows,
    its overflow counted over those rows only — the validity mask of the
    JAX package's masked executor, whose pad rows come last."""
    n = out.row_nnz[:n_valid]
    return SpGEMMOut(out.col[:n_valid], out.val[:n_valid], n,
                     torch.clamp(n - cap, min=0).sum(dtype=torch.int32))


def _build_local_executor(metas: tuple, nrows: int, cap_out: int,
                          use_kernel: bool, masked: bool = False):
    """Single-device executor: per-bucket routed passes written in place
    into one ``(nrows, cap_out)`` output — the
    :func:`repro_torch.core.spgemm.spgemm_binned` dataflow, with the row
    tables, their real row counts and the buckets' FLOP bounds passed in so
    one executor serves every same-keyed plan.

    ``masked`` is the ``pop_quant`` variant: tables arrive pow2-padded
    (repeat-last fill, pad rows last); each bucket's result is cut to its
    real rows before it is written (a pad row repeats a real row's id) and
    pad rows never count as overflow."""

    def run(ad, bd, tables, flop_bounds, valid):
        rownnz_b = torch.diff(bd.rpt)

        def parts():
            for meta, rows, bound, n_valid in zip(metas, tables, flop_bounds,
                                                  valid):
                out = _run_bucket(ad, bd, rows, meta, use_kernel, bound,
                                  rownnz_b)
                if masked:
                    out, rows = _real_rows(out, n_valid, meta[-1]), \
                        rows[:n_valid]
                yield rows, out

        return assemble(nrows, cap_out, parts(), ad.device)

    return run


def _panel_meta(bucket: binning_mod.RowBucket, db_p: int, cap: int,
                lane_budget: int = binning_mod.DEFAULT_LANE_BUDGET) -> tuple:
    """Bucket execution metadata at the PANEL deg_b bound.  ``block_rows``
    re-fits the narrower ``deg_a·db_p`` width as the JAX package does, so
    the executor keys match (the port's kernels ignore it).  Route, tile
    and span stay as planned: a panel's product columns are a subset of
    the row's, so the planned column window still covers them."""
    blk = binning_mod._pick_block_rows(bucket.deg_a * db_p, lane_budget,
                                       binning_mod.DEFAULT_MAX_BLOCK_ROWS)
    if bucket.route == binning_mod.ROUTE_SPA and bucket.tile_n:
        blk = int(max(1, min(blk, binning_mod.floor_pow2(
            max(1, lane_budget // bucket.tile_n)))))
    elif bucket.route == binning_mod.ROUTE_BIN and bucket.tile_n:
        blk = int(max(1, min(blk, binning_mod.floor_pow2(max(
            1, lane_budget // (bucket.tile_n * max(1, bucket.n_tiles)))))))
    return (bucket.deg_a, db_p, blk, bucket.route, bucket.tile_n,
            bucket.n_tiles, bucket.span, int(cap))


def _empty_unit(n_rows: int, cap: int, device) -> SpGEMMOut:
    """The block of a unit whose rows have no products in its panel."""
    return SpGEMMOut(
        torch.full((n_rows, cap), COL_SENTINEL, dtype=torch.int32,
                   device=device),
        torch.zeros((n_rows, cap), dtype=torch.float32, device=device),
        torch.zeros(n_rows, dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def _build_local_panel_executor(metas: tuple, use_kernel: bool,
                                masked: bool = False):
    """Single-device panel executor: one routed pass per (bucket × panel),
    each against that panel's operand at its panel deg_b bound, its own
    capacity and its own FLOP bound.  Panels partition the column space,
    so no merge pass follows: the blocks ARE the output
    (:class:`PanelSpgemmOut`).  A unit whose rows have no products in its
    panel (FLOP bound 0) launches nothing and yields an empty block.
    ``masked`` (``pop_quant``) cuts each block to its table's real rows."""

    def run(ad, bps, tables, bounds, valid):
        rownnz = [torch.diff(bp.rpt) for bp in bps]
        cols, vals, nnzs = [], [], []
        overflow = torch.zeros((), dtype=torch.int32, device=ad.device)
        for pmetas, rows, pbounds, n_valid in zip(metas, tables, bounds,
                                                  valid):
            bc, bv, bn = [], [], []
            for bp, rnb, meta, bound in zip(bps, rownnz, pmetas, pbounds):
                if bound:
                    out = _run_bucket(ad, bp, rows, meta, use_kernel, bound,
                                      rnb)
                else:
                    out = _empty_unit(rows.shape[0], meta[-1], ad.device)
                if masked:
                    out = _real_rows(out, n_valid, meta[-1])
                bc.append(out.col)
                bv.append(out.val)
                bn.append(out.row_nnz)
                overflow = overflow + out.overflow
            cols.append(tuple(bc))
            vals.append(tuple(bv))
            nnzs.append(tuple(bn))
        return PanelSpgemmOut(tuple(cols), tuple(vals), tuple(nnzs), overflow)

    return run


def _build_bucket_executor(meta: tuple, use_kernel: bool):
    """One bucket's standalone executor — the unit of re-execution of the
    re-planning loop and of straggler recovery (build-counted like the full
    executors).  A unit whose rows have no products (FLOP bound 0: a
    panel without their columns) launches nothing and yields an empty
    block, as in the panel wave."""

    def run(ad, bd, rows, bound):
        if not bound:
            return _empty_unit(rows.shape[0], meta[-1], ad.device)
        return _run_bucket(ad, bd, rows, meta, use_kernel, bound,
                           torch.diff(bd.rpt))

    return run


def _mesh_key(mesh) -> tuple:
    return () if mesh is None else mesh.key()


def _executor_key(plan: SpgemmPlan, mesh) -> tuple:
    return plan.key + (_mesh_key(mesh),)


def _dist_bucket(meta: tuple, use_kernel: bool, ops, rows, bounds, live,
                 first) -> tuple:
    """One bucket's (bucket × shard) units: shard ``s`` runs the bucket's
    routed pass over its own row table on its own device (``ops[s]``: A,
    B and B's row lengths there), into its own slice of one stacked
    ``(num_shards, rows_pb, cap)`` block on ``first``.  A shard that owns
    no row of the bucket (``live[s]`` false) and a unit without products
    (FLOP bound 0) launch nothing: their pad rows are masked off by
    ``valid`` wherever the block is read."""
    n_sh = len(ops)
    pb = int(rows[0].shape[0])
    cap = int(meta[-1])
    col = torch.full((n_sh, pb, cap), COL_SENTINEL, dtype=torch.int32,
                     device=first)
    val = torch.zeros((n_sh, pb, cap), dtype=torch.float32, device=first)
    nnz = torch.zeros((n_sh, pb), dtype=torch.int32, device=first)
    for s, ((ad, bd, rnb), r, bound, on) in enumerate(zip(ops, rows, bounds,
                                                          live)):
        if not (on and bound):
            continue
        out = _run_bucket(ad, bd, r, meta, use_kernel, bound, rnb)
        col[s].copy_(out.col)
        val[s].copy_(out.val)
        nnz[s].copy_(out.row_nnz)
    return col, val, nnz


def _build_dist_executor(metas: tuple, use_kernel: bool):
    """The distributed wave (JAX ``_build_dist_executor`` /
    ``_build_panel_dist_executor``): every shard runs every bucket's routed
    pass over its own row table, the bucket's shards stacked in one block
    — one process driving the mesh, where JAX's ``shard_map`` runs one
    program a device.  A and B (the gathered panel operand, with panels)
    come in per shard position, so the executor is the same for both
    modes; per-shard overflow is derived on the host from the returned
    true ``row_nnz`` and the tables' ``valid`` masks."""

    def run(ops, tables, bounds, live, first):
        outs = [_dist_bucket(meta, use_kernel, ops, rows, b, on, first)
                for meta, rows, b, on in zip(metas, tables, bounds, live)]
        return (tuple(o[0] for o in outs), tuple(o[1] for o in outs),
                tuple(o[2] for o in outs))

    return run


def _shard_live(plan: SpgemmPlan) -> tuple:
    """Per bucket, per shard: whether the shard owns any row of it."""
    return tuple(tuple(bool(v) for v in t.valid.any(axis=1))
                 for t in plan.shard_tables)


def _shard_args(plan: SpgemmPlan, mesh) -> tuple:
    """Each shard's row table on its device: per bucket, a tuple over shard
    positions of int32 row tensors.  Every distinct device gets the whole
    ``(num_shards, rows_pb)`` table ONCE a plan (its shards read their own
    row of it), cached by the mesh's key."""
    key = mesh.key()
    if key not in plan._shard_dev:
        per_dev = {d: tuple(torch.from_numpy(np.ascontiguousarray(
                       t.table, dtype=np.int32)).to(d)
                       for t in plan.shard_tables)
                   for d in mesh.distinct_devices()}
        plan._shard_dev[key] = tuple(
            tuple(per_dev[d][i][s] for s, d in enumerate(mesh.devices))
            for i in range(len(plan.shard_tables)))
    return plan._shard_dev[key]


def _on_device(m: CSRDevice, device) -> CSRDevice:
    """``m`` on ``device`` (itself when it is there already)."""
    if mesh_mod.same_device(m.device, device):
        return m
    return CSRDevice(rpt=m.rpt.to(device), col=m.col.to(device),
                     val=m.val.to(device), shape=m.shape)


def _dist_operands(plan: SpgemmPlan, ad: CSRDevice, bd: CSRDevice,
                   mesh) -> list:
    """Per shard position ``(A, B, B's row lengths)`` on that shard's
    device: the replicated operands, uploaded once per distinct device
    (JAX's ``P()`` in-specs), never once per shard."""
    per_dev = {}
    for d in mesh.distinct_devices():
        a_d, b_d = _on_device(ad, d), _on_device(bd, d)
        per_dev[d] = (a_d, b_d, torch.diff(b_d.rpt))
    return [per_dev[d] for d in mesh.devices]


def _panel_dist_args(plan: SpgemmPlan, mesh) -> dict:
    """Structure-only device uploads of the panel gather, once a plan and
    device: for each distinct device, its shards' remapped A columns and
    their gathered-panel row pointers, columns, B-entry indices and row
    lengths (only the rows of the devices it serves)."""
    key = mesh.key()
    if plan._panel_dev is None:
        plan._panel_dev = {}
    if key not in plan._panel_dev:
        pg = plan._panel_gather
        out = {}
        for dev in mesh.distinct_devices():
            ds = [d for d, dd in enumerate(mesh.devices) if dd == dev]
            rs = sorted({d // pg.n_panels for d in ds})
            g_rpt = torch.from_numpy(pg.g_rpt[ds]).to(dev)
            out[dev] = dict(
                d_pos={d: k for k, d in enumerate(ds)},
                s_pos={s: k for k, s in enumerate(rs)},
                a_col=torch.from_numpy(pg.a_col[rs]).to(dev),
                g_rpt=g_rpt, g_col=torch.from_numpy(pg.g_col[ds]).to(dev),
                g_idx=torch.from_numpy(pg.g_idx[ds]).to(dev),
                g_rnb=torch.diff(g_rpt, dim=1).contiguous())
        plan._panel_dev[key] = out
    return plan._panel_dev[key]


def _gather_panel_values(g_idx: torch.Tensor,
                         bval: torch.Tensor) -> torch.Tensor:
    """The per-execute half of the gather: each device's gathered panel
    value payload (``ecap`` floats a device), read from ``b.val`` through
    the plan's entry indices on the device (0 on the padding)."""
    if not bval.numel():
        return torch.zeros(g_idx.shape, dtype=torch.float32,
                           device=g_idx.device)
    return torch.where(g_idx >= 0, bval[g_idx.clamp(min=0)],
                       torch.zeros((), dtype=torch.float32,
                                   device=g_idx.device))


def _panel_dist_operands(plan: SpgemmPlan, ad: CSRDevice, b: CSR,
                         mesh) -> list:
    """Per device position ``d = s·P + p``: A with row shard ``s``'s
    remapped columns, the gathered panel operand (a compact CSR of
    ``nref`` rows, its values gathered from ``b`` on the device this
    execute) and its row lengths.  A's row pointers and values and B's
    values are uploaded once per distinct device."""
    pg = plan._panel_gather
    args = _panel_dist_args(plan, mesh)
    bval_host = torch.from_numpy(np.ascontiguousarray(b.val,
                                                      dtype=np.float32))
    per_dev = {}
    for dev, st in args.items():
        a_d = _on_device(ad, dev)
        per_dev[dev] = (a_d, _gather_panel_values(st["g_idx"],
                                                  bval_host.to(dev)))
    ops = []
    for d, dev in enumerate(mesh.devices):
        st = args[dev]
        a_d, g_val = per_dev[dev]
        k, ks = st["d_pos"][d], st["s_pos"][d // pg.n_panels]
        ops.append((
            CSRDevice(rpt=a_d.rpt, col=st["a_col"][ks], val=a_d.val,
                      shape=plan.shape_a),
            CSRDevice(rpt=st["g_rpt"][k], col=st["g_col"][k],
                      val=g_val[k], shape=(pg.nref, plan.shape_b[1])),
            st["g_rnb"][k]))
    return ops


def _panel_operands_local(plan: SpgemmPlan, b: CSR) -> list:
    """Per-panel device CSRs at the plan's padded panel capacities.

    The structure (row pointers, padded columns, each entry's index into
    ``b.val``) is uploaded ONCE per plan (``_panel_dev``); each execute
    uploads ``b``'s values once and gathers every panel's on the device —
    a revalued serving pair reuses the executors and the index uploads."""
    dev = plan.device
    if plan._panel_dev is None:
        structs = []
        for p, ((prpt, pcol, pidx), cap) in enumerate(
                zip(plan._panel_host, plan._panel_caps_dev)):
            if pcol.size > cap:
                raise CapacityExhaustedError(
                    f"panel {p} operand capacity {cap} cannot hold its "
                    f"{pcol.size} entries", panel=p,
                    observed=int(pcol.size), planned=int(cap),
                    plan_key=_plan_key_id(plan))
            col = np.full(cap, COL_SENTINEL, dtype=np.int32)
            col[:pcol.size] = pcol
            structs.append((
                torch.from_numpy(prpt.astype(np.int32)).to(dev),
                torch.from_numpy(col).to(dev),
                torch.from_numpy(pidx.astype(np.int64)).to(dev)))
        plan._panel_dev = tuple(structs)
    bval = torch.from_numpy(np.ascontiguousarray(b.val, dtype=np.float32)
                            ).to(dev)
    out = []
    for (rpt_d, col_d, idx_d), cap in zip(plan._panel_dev,
                                          plan._panel_caps_dev):
        val = torch.zeros(cap, dtype=torch.float32, device=dev)
        val[:idx_d.shape[0]] = bval[idx_d]
        out.append(CSRDevice(rpt=rpt_d, col=col_d, val=val,
                             shape=plan.shape_b))
    return out


def _check_panel_operand(plan: SpgemmPlan, m, which: str = "b") -> CSR:
    """Panel plans bake operand B's STRUCTURE into the panel slices (and a
    distributed panel plan A's too, in its remapped columns), so a
    same-shape different-structure operand would silently produce a wrong
    matrix.  Require the host CSR, match its (nnz, col-sum) fingerprint
    against the planned operand's (the JAX package's check, and its error),
    then its row pointers and columns exactly: entries moved between rows
    keep the fingerprint."""
    shape = plan.shape_b if which == "b" else plan.shape_a
    fp = plan._panel_b_fp if which == "b" else plan._panel_a_fp
    plan.validation["fingerprint_checks"] += 1
    if not isinstance(m, CSR):
        raise PlanMismatchError(
            f"panel plans bake operand {which}'s structure into the gather "
            "maps — pass the host CSR operand, not a CSRDevice",
            operand=which, plan_key=_plan_key_id(plan))
    m_fp = (int(m.nnz), int(np.asarray(m.col, dtype=np.int64).sum()))
    if m.shape != shape or m_fp != fp:
        raise PlanMismatchError(
            f"operand {which} shape/structure {m.shape}/nnz={m.nnz} does "
            f"not match the planned operand ({shape}/nnz={fp[0]}) — the "
            "panel gather map is structure-specific; re-plan for a new "
            "sparsity pattern", operand=which, observed=list(m_fp),
            planned=list(fp), plan_key=_plan_key_id(plan))
    rpt0, col0 = (plan._panel_b_structure if which == "b"
                  else plan._panel_a_structure)
    rpt, col = np.asarray(m.rpt), np.asarray(m.col)
    if not (np.array_equal(rpt, rpt0) and np.array_equal(col, col0)):
        k = np.flatnonzero(rpt != rpt0)
        row = (int(k[0]) - 1 if k.size else int(np.searchsorted(
            rpt0, np.flatnonzero(col != col0)[0], side="right")) - 1)
        raise PlanMismatchError(
            f"operand {which} has the planned nnz and column sum but not "
            f"the planned structure (row {row} differs) — the panel gather "
            "map is structure-specific; re-plan for a new sparsity pattern",
            operand=which, row=row, plan_key=_plan_key_id(plan))
    return m


def _unit_priced_seconds(meta: tuple, rows: int) -> float:
    """Expected seconds of one (bucket[×panel]) unit dispatch, priced from
    its execution metadata: ``width = deg_a·deg_b`` products per row over
    ``rows`` dispatched rows (pads included — they cost real lanes)."""
    deg_a, deg_b = int(meta[0]), int(meta[1])
    return profiles_mod.unit_seconds(meta[3], deg_a * max(1, deg_b),
                                     int(meta[6]), int(rows))


def _plan_priced_seconds(plan: SpgemmPlan) -> float:
    """Expected seconds of one full execute() wave — the sum over every
    (bucket × panel[× shard]) unit the wave dispatches.  Feeds
    :class:`DispatchBudget` for the wave; recovery prices each unit
    individually with :func:`_unit_priced_seconds`."""
    total = 0.0
    if plan.distributed:
        for i, (bk, t) in enumerate(zip(plan.binning.buckets,
                                        plan.shard_tables)):
            if plan.n_panels:
                meta = _panel_meta(bk, plan.panel_deg_b[i], t.capacity)
            else:
                meta = _bucket_meta(bk, t.capacity)
            # the JAX package's SPMD pricing: every device runs its rows_pb
            # slice at once, so the wave's critical path is ONE shard's
            # unit per bucket
            total += _unit_priced_seconds(meta, t.rows_pb)
        return total
    pops = plan.local_populations()
    for i, (bk, pop) in enumerate(zip(plan.binning.buckets, pops)):
        if plan.n_panels:
            for p in range(plan.n_panels):
                meta = _panel_meta(bk, plan.panel_deg_b[i],
                                   int(plan.panel_caps[i, p]))
                total += _unit_priced_seconds(meta, pop)
        else:
            meta = _bucket_meta(bk, int(plan.alloc.bucket_capacities[i]))
            total += _unit_priced_seconds(meta, pop)
    return total


def _wave_budget(plan: SpgemmPlan, mesh=None) -> dict:
    """The watchdog arguments of a plan's wave dispatch (none unarmed); a
    distributed wave synchronizes every device of its mesh."""
    if plan.dispatch_budget is None:
        return {}
    return dict(budget=plan.dispatch_budget,
                priced_s=_plan_priced_seconds(plan),
                device=(plan.device if mesh is None
                        else mesh.distinct_devices()))


def _invoke_executor(run, info: dict, *args,
                     budget: DispatchBudget | None = None,
                     priced_s: float = 0.0, device=None):
    """Every executor dispatch funnels here: the fault-injection hook
    (``core.faults.check_executor``) fires before the dispatch, and any
    exception out of the executor — injected or real, a kernel that failed
    to launch included — surfaces as a typed :class:`ShardFailureError`
    naming the dispatch unit, chained to its cause.  Typed pipeline errors
    pass through as they are.  Nothing is retried here.

    When ``budget`` is armed (``plan.dispatch_budget``), the dispatch is
    timed between two synchronizes of ``device``, or of each device of a
    list (the kernels run asynchronously: without them only the launches
    would be timed) against
    ``budget.limit(priced_s)``; exceeding it raises a typed
    :class:`StragglerError` carrying observed vs planned seconds.  Real
    wall time does not count for an executor's first dispatch, nor for a
    dispatch during which a kernel library was loaded or built
    (``kernels._build.loads``): neither is a straggler.  Injected
    ``delay_executor`` seconds always count."""
    try:
        faults_mod.check_executor(info)
        if budget is None:
            out = run(*args)
            run.dispatched = True
            return out
        devices = (list(device) if isinstance(device, (list, tuple))
                   else [] if device is None else [device])
        cuda = [d for d in devices if torch.device(d).type == "cuda"]
        first = not getattr(run, "dispatched", False)
        loads0 = build_mod.loads
        for d in cuda:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        out = run(*args)
        for d in cuda:
            torch.cuda.synchronize(d)
        elapsed = time.perf_counter() - t0
        run.dispatched = True
        if first or build_mod.loads != loads0:
            elapsed = 0.0              # first dispatch or a library load
        elapsed += faults_mod.executor_delay(info)
        limit = budget.limit(priced_s)
        if elapsed > limit:
            raise StragglerError(
                f"dispatch exceeded its budget: {elapsed:.4f}s > "
                f"{limit:.4f}s", observed=round(elapsed, 6),
                planned=round(limit, 6), **info)
        return out
    except SpgemmError:
        raise
    except Exception as e:
        raise ShardFailureError(f"executor failed: {e}", **info) from e


def _coerce_one(plan: SpgemmPlan, m, which: str, idx: int) -> CSRDevice:
    cap = plan.cap_a if which == "a" else plan.cap_b
    shape = plan.shape_a if which == "a" else plan.shape_b
    if isinstance(m, CSRDevice):
        # a pre-converted operand must sit at the plan's padded capacity on
        # the plan's device, or it would key a different executor — or
        # compute a different matrix without complaint
        if (m.shape != shape or m.capacity != cap
                or m.device.type != plan.device.type):
            raise PlanMismatchError(
                f"operand {which}: CSRDevice shape/capacity/device "
                f"{m.shape}/{m.capacity}/{m.device} does not match the "
                f"plan's {shape}/{cap}/{plan.device} — convert with "
                "plan.to_device()",
                operand=which, observed=[list(m.shape), int(m.capacity)],
                planned=[list(shape), int(cap)],
                plan_key=_plan_key_id(plan))
        return m
    if plan._planned_pair is not None and m is plan._planned_pair[0][idx]:
        return plan._planned_pair[1][idx]
    return plan.to_device(m, which)


# --------------------------------------------------------------------------- #
# Overflow re-planning (DESIGN.md §7) + retry escalation (§9): bump ONLY the
# overflowing buckets' capacities and re-execute them — the realloc half of
# the paper's story; when the ladder runs out, escalate once to an exact
# symbolic count of the offending buckets.
# --------------------------------------------------------------------------- #
def _bumped_capacity(cap: int, need: int, retry_safety: float,
                     attempt: int) -> int:
    """Safety-factor schedule ``×retry_safety^attempt``, floored at the
    observed need (``row_nnz`` is exact, so one round converges) and
    pow2-rounded so retry capacities stay cache-quantized."""
    sched = int(np.ceil(cap * (retry_safety ** attempt)))
    return binning_mod.ceil_pow2(max(need, sched, cap + 1))


def _policy_of(retry_policy: RetryPolicy | None, retry_safety: float,
               max_retries: int) -> RetryPolicy | None:
    """The plan's escalation policy: ``retry_policy`` when given, else the
    legacy ``retry_safety``/``max_retries`` pair as a ladder-only policy
    that surfaces what overflow is left, as before the policy existed
    (None, re-planning off, when neither is set)."""
    if retry_policy is not None or retry_safety <= 0:
        return retry_policy
    return RetryPolicy(rounds=int(max_retries), growth=float(retry_safety),
                       exact_fallback=False, on_exhausted="surface")


def _exact_capacity(need: int, cap: int) -> int:
    """Guaranteed-sufficient pow2 capacity for the exact-symbolic fallback
    (never below the current cap — splicing only widens buffers)."""
    return binning_mod.ceil_pow2(max(8, int(need), int(cap)))


def _escalate(plan: SpgemmPlan, units: list, row_nnz: dict, caps,
              overflow: int, rerun, exact_need, commit,
              widen=lambda new_caps: None, exhausted=None) -> int | None:
    """The re-planning ladder over a finished wave's units — buckets (ints)
    or (bucket, panel) pairs — shared by the whole-B and panel paths.

    ``row_nnz[u]`` holds each unit's true per-row counts (host) and
    ``caps[u]`` its capacity (a list by bucket, or a (bucket, panel)
    array), updated in place.  Each round bumps only the
    units whose need passed their capacity (``rerun(u, new_cap, kind)``
    re-runs one unit and splices it back; ``widen`` sees each group of new
    capacities first); when the ladder runs out, each unit still short is
    counted exactly (``exact_need(u)``) and re-run once.  Events and
    degradations name the unit's bucket, and its panel when it has one.
    ``commit(caps)`` stores the final capacities.  Returns the overflow
    left against them, or None when nothing was re-run (the fast path);
    raises :class:`CapacityExhaustedError` when the policy says so
    (``exhausted(bad_units, dropped)``, when given, raises instead: the
    distributed paths raise JAX's :class:`ShardFailureError` naming the
    shards)."""
    policy = plan.retry_policy
    need = {u: int(row_nnz[u].max(initial=0)) for u in units}
    panels = bool(units) and isinstance(units[0], tuple)
    plan.retries = 0
    plan.retry_events = []             # observability covers the LAST execute
    plan.degradations = []

    def tag(u) -> dict:
        return dict(bucket=u[0], panel=u[1]) if panels else dict(bucket=u)

    def default_exhausted(bad, dropped):
        what = "bucket×panel units" if panels else "buckets"
        ctx = dict(buckets=[tag(u)["bucket"] for u in bad],
                   observed=int(dropped), plan_key=_plan_key_id(plan))
        if not panels:
            ctx["planned"] = [int(caps[u]) for u in bad]
        raise CapacityExhaustedError(
            f"retry escalation exhausted with {int(dropped)} entries still "
            f"dropped ({what} {bad})", **ctx)

    exhausted = exhausted or default_exhausted
    changed = False
    for attempt in range(1, policy.rounds + 1):
        bumps = []
        for u in units:
            if need[u] <= caps[u]:
                continue
            new_cap = policy.clamp(
                int(caps[u]), _bumped_capacity(int(caps[u]), need[u],
                                               policy.growth, attempt))
            if new_cap > caps[u]:      # ceiling-clamped units wait for
                bumps.append((u, new_cap))   # the exact fallback instead
        if not bumps:
            break
        plan.retries = attempt
        changed = True
        widen([c for _, c in bumps])
        for u, new_cap in bumps:
            rerun(u, new_cap, "bucket-retry")
            tracing.count("replan.rows", len(row_nnz[u]))
            plan.retry_events.append(dict(
                round=attempt, **tag(u), old_cap=int(caps[u]),
                new_cap=new_cap, need=need[u]))
            caps[u] = new_cap
    # ladder exhausted (no rounds left, or every bump ceiling-clamped):
    # escalate ONCE to an exact symbolic count of the offending units
    over = [u for u in units if need[u] > caps[u]]
    if over and policy.exact_fallback:
        changed = True
        exact = []
        for u in over:
            n_ex = exact_need(u)
            exact.append((u, n_ex, _exact_capacity(n_ex, int(caps[u]) + 1)))
        widen([c for _, _, c in exact])
        for u, n_ex, new_cap in exact:
            rerun(u, new_cap, "exact-fallback")
            tracing.count("replan.rows", len(row_nnz[u]))
            plan.degradations.append(dict(
                kind="exact_symbolic", **tag(u), old_cap=int(caps[u]),
                new_cap=int(new_cap), need=int(n_ex)))
            caps[u] = new_cap
    if not changed:
        if over and policy.on_exhausted == "raise":
            exhausted(over, overflow)
        return None                    # fast path: nothing overflowed
    # the overflow left against the bumped plan
    left = sum(int(np.maximum(row_nnz[u] - caps[u], 0).sum()) for u in units)
    commit(caps)
    if left and policy.on_exhausted == "raise":
        exhausted([u for u in units if need[u] > caps[u]], left)
    return left


def _replan_local(plan: SpgemmPlan, ad, bd, out: SpGEMMOut,
                  cache: PlanCache) -> SpGEMMOut:
    """The re-planning loop over a finished wave, on the device.  The true
    ``row_nnz`` is read back once (the fast path's only cost); each round
    widens the output once, to its widest new capacity, and each re-run
    bucket's real rows are written into it in place."""
    buckets = plan.binning.buckets
    with tracing.span("execute.readback"):
        n = out.row_nnz.cpu().numpy().astype(np.int64)
    tables = plan.device_args()
    bounds = plan.flop_bounds()
    col, val = out.col, out.val

    def widen(new_caps) -> None:
        nonlocal col, val
        width = max(new_caps)
        if width > col.shape[1]:
            grown = torch.full((col.shape[0], width), COL_SENTINEL,
                               dtype=col.dtype, device=col.device)
            grown[:, :col.shape[1]] = col
            col = grown
            grown = torch.zeros((val.shape[0], width), dtype=val.dtype,
                                device=val.device)
            grown[:, :val.shape[1]] = val
            val = grown

    def rerun(i, new_cap, unit) -> None:
        bk = buckets[i]
        meta = _bucket_meta(bk, new_cap)
        pop = int(tables[i].shape[0])
        run = cache.executor(
            ("bucket-retry", plan.shape_a, plan.shape_b, plan.cap_a,
             plan.cap_b, plan.use_kernel, meta, pop),
            lambda m=meta: _build_bucket_executor(m, plan.use_kernel))
        c2, v2, _, _ = _invoke_executor(run, dict(unit=unit, bucket=i),
                                        ad, bd, tables[i], bounds[i])
        rows = tables[i][:bk.n_rows].long()
        col[rows, :new_cap] = c2[:bk.n_rows]
        val[rows, :new_cap] = v2[:bk.n_rows]

    def exact_need(i) -> int:
        bk = buckets[i]
        return int(predictor_mod.exact_row_counts(
            ad, bd, bk.rows, max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
            route=bk.route, span=bk.span, use_kernel=plan.use_kernel,
            row_flop=plan.flopr[bk.rows]).max(initial=1))

    def commit(caps) -> None:
        plan.alloc = predictor_mod.BinnedAllocationPlan(
            bucket_capacities=tuple(caps), row_capacity=max(caps),
            total_capacity=sum(bk.n_rows * c for bk, c in zip(buckets,
                                                             caps)),
            safety=plan.alloc.safety)
        if plan._template is not None:
            plan._template.grow_caps(caps)   # the family learns from the miss

    with tracing.span("execute.replan"):
        overflow = _escalate(
            plan, [i for i, bk in enumerate(buckets) if bk.n_rows],
            {i: n[bk.rows] for i, bk in enumerate(buckets)},
            list(plan.alloc.bucket_capacities), int(out.overflow),
            rerun, exact_need, commit, widen)
    if overflow is None:
        return out
    return SpGEMMOut(col, val, out.row_nnz,
                     torch.tensor(overflow, dtype=torch.int32,
                                  device=col.device))


def _replan_local_panels(plan: SpgemmPlan, ad, bps, out: PanelSpgemmOut,
                         cache: PlanCache) -> PanelSpgemmOut:
    """Single-device panel re-planning: the unit is (bucket × panel).  The
    blocks' true ``row_nnz`` are read back once; an overflow in one panel
    of one bucket re-runs ONLY that unit, whose new block replaces the old
    one whole (the other panels' blocks are kept as they are).  The exact
    fallback counts each offending unit's rows against its panel operand
    (kernel 2 or 4 in per-row count mode on the card)."""
    buckets = plan.binning.buckets
    npan = plan.n_panels
    keys = [(i, p) for i in range(len(buckets)) for p in range(npan)]
    flat = [out.row_nnz[i][p] for i, p in keys]
    with tracing.span("execute.readback"):
        host = dict(zip(keys, np.split(
            torch.cat(flat).cpu().numpy().astype(np.int64),
            np.cumsum([n.shape[0] for n in flat])[:-1]))) if flat else {}
    cols = [list(bc) for bc in out.cols]
    vals = [list(bv) for bv in out.vals]
    tables = plan.device_args()
    bounds = plan.panel_flop_bounds()

    def rerun(u, new_cap, unit):
        i, p = u
        bk = buckets[i]
        meta = _panel_meta(bk, plan.panel_deg_b[i], new_cap)
        pop = int(tables[i].shape[0])
        run = cache.executor(
            ("bucket-retry-panel", plan.shape_a, plan.shape_b,
             plan.cap_a, plan._panel_caps_dev[p], plan.use_kernel, meta,
             pop),
            lambda m=meta: _build_bucket_executor(m, plan.use_kernel))
        c2, v2, _, _ = _invoke_executor(
            run, dict(unit=unit, bucket=i, panel=p), ad, bps[p], tables[i],
            bounds[i][p])
        cols[i][p] = c2[:bk.n_rows]
        vals[i][p] = v2[:bk.n_rows]

    def exact_need(u) -> int:
        i, p = u
        bk = buckets[i]
        return int(predictor_mod.exact_row_counts(
            ad, bps[p], bk.rows, max_deg_a=bk.deg_a,
            max_deg_b=plan.panel_deg_b[i], route=bk.route, span=bk.span,
            use_kernel=plan.use_kernel,
            row_flop=plan._panel_flopr[p][bk.rows]).max(initial=1))

    def commit(caps) -> None:
        plan.panel_caps = caps

    with tracing.span("execute.replan"):
        overflow = _escalate(
            plan, [(i, p) for i, bk in enumerate(buckets) if bk.n_rows
                   for p in range(npan)],
            host, np.asarray(plan.panel_caps, dtype=np.int64).copy(),
            int(out.overflow), rerun, exact_need, commit)
    if overflow is None:
        return out
    return PanelSpgemmOut(tuple(tuple(bc) for bc in cols),
                          tuple(tuple(bv) for bv in vals), out.row_nnz,
                          torch.tensor(overflow, dtype=torch.int32,
                                       device=ad.device))


def _shard_overflow(tables, nnz_host, widths) -> np.ndarray:
    """Entries each shard position's VALID rows dropped: ``nnz_host[i]``
    is bucket ``i``'s ``(num_shards, rows_pb)`` true counts (host) and
    ``widths[i]`` the slots per position (an int, or one a position)."""
    n_sh = tables[0].table.shape[0] if tables else 0
    over = np.zeros(n_sh, dtype=np.int64)
    for t, n, w in zip(tables, nnz_host, widths):
        w = np.broadcast_to(np.asarray(w, dtype=np.int64), (n_sh,))
        over += np.where(t.valid, np.maximum(n - w[:, None], 0),
                         0).sum(axis=1)
    return over


def _nnz_to_host(nnzs) -> list:
    """Every bucket's ``(num_shards, rows_pb)`` true counts, read back in
    ONE copy."""
    if not nnzs:
        return []
    flat = torch.cat([n.reshape(-1) for n in nnzs]).cpu().numpy()
    parts = np.split(flat.astype(np.int64),
                     np.cumsum([n.numel() for n in nnzs])[:-1])
    return [p.reshape(tuple(n.shape)) for p, n in zip(parts, nnzs)]


def _replan_dist(plan: SpgemmPlan, ops, out: DistSpgemmOut, nnz_host,
                 cache: PlanCache, mesh) -> DistSpgemmOut:
    """Distributed re-planning: the unit is a bucket, re-run over every
    shard at its bumped capacity (a ``("bucket-retry-dist", …)``
    executor); the ladder and the exact fallback are the local paths'
    (:func:`_escalate`), the residual raises JAX's
    :class:`ShardFailureError` naming the shards."""
    buckets = plan.binning.buckets
    tables = list(plan.shard_tables)
    cols, vals = list(out.cols), list(out.vals)
    args = _shard_args(plan, mesh)
    bounds = plan.shard_flop_bounds()
    live = _shard_live(plan)
    first = mesh.devices[0]

    def rerun(i, new_cap, unit) -> None:
        t = tables[i]
        meta = _bucket_meta(buckets[i], new_cap)
        run = cache.executor(
            ("bucket-retry-dist", plan.shape_a, plan.shape_b, plan.cap_a,
             plan.cap_b, plan.use_kernel, meta, t.rows_pb, plan.axis,
             _mesh_key(mesh)),
            lambda m=meta: _build_dist_executor((m,), plan.use_kernel))
        (c2,), (v2,), _ = _invoke_executor(
            run, dict(unit=unit, bucket=i), ops, (args[i],), (bounds[i],),
            (live[i],), first)
        cols[i], vals[i] = c2, v2
        tables[i] = dataclasses.replace(t, capacity=new_cap)

    def exact_need(i) -> int:
        bk = buckets[i]
        ad, bd, _ = ops[0]
        return int(predictor_mod.exact_row_counts(
            ad, bd, bk.rows, max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
            route=bk.route, span=bk.span, use_kernel=plan.use_kernel,
            row_flop=plan.flopr[bk.rows]).max(initial=1))

    def overflow_now() -> np.ndarray:
        return _shard_overflow(tables, nnz_host,
                               [t.capacity for t in tables])

    def exhausted(bad, dropped):
        shards = [int(s) for s in np.flatnonzero(overflow_now())]
        raise ShardFailureError(
            f"retry escalation exhausted with {int(dropped)} entries still "
            f"dropped on shards {shards}", shards=shards, buckets=list(bad),
            observed=int(dropped), plan_key=_plan_key_id(plan))

    def commit(caps) -> None:
        plan.shard_tables = tuple(tables)   # reassemble reads the widths
        if plan._template is not None:
            plan._template.grow_dist(plan.num_shards,
                                     [t.rows_pb for t in tables],
                                     [t.capacity for t in tables])

    left = _escalate(
        plan, list(range(len(buckets))),
        {i: np.where(t.valid, nnz_host[i], 0).ravel()
         for i, t in enumerate(tables)},
        [t.capacity for t in tables], int(out.shard_overflow.sum()),
        rerun, exact_need, commit, exhausted=exhausted)
    if left is None:
        return out
    return DistSpgemmOut(tuple(cols), tuple(vals), out.row_nnz,
                         overflow_now())


def _replan_dist_panels(plan: SpgemmPlan, ops, out: DistSpgemmOut,
                        nnz_host, cache: PlanCache, mesh) -> DistSpgemmOut:
    """Distributed panel re-planning: overflow is found per (bucket ×
    panel) across that panel's devices, and ONLY the offending unit
    re-runs — one cached per-bucket executor dispatch per row shard,
    against the SAME gathered operands the wave used.  A unit's threshold
    is the width it ran at (every panel of a bucket runs at the bucket's
    shard capacity)."""
    pg = plan._panel_gather
    npan = plan.n_panels
    buckets = plan.binning.buckets
    tables = list(plan.shard_tables)
    cols, vals = list(out.cols), list(out.vals)
    args = _shard_args(plan, mesh)
    bounds = plan.shard_flop_bounds()
    alloc0 = np.array([[int(t.capacity)] * npan for t in tables],
                      dtype=np.int64).reshape(len(tables), npan)
    caps = alloc0.copy()

    def rerun(u, new_cap, unit) -> None:
        i, p = u
        t = tables[i]
        meta = _panel_meta(buckets[i], plan.panel_deg_b[i], new_cap)
        run = cache.executor(
            ("bucket-retry-panel-dist", plan.shape_a, plan.shape_b,
             plan.cap_a, pg.nref, pg.ecap, plan.use_kernel, meta, t.rows_pb),
            lambda m=meta: _build_bucket_executor(m, plan.use_kernel))
        if new_cap > cols[i].shape[2]:
            cols[i] = _widen_block(cols[i], new_cap, COL_SENTINEL)
            vals[i] = _widen_block(vals[i], new_cap, 0.0)
        for s in range(plan.row_shards):
            d = s * npan + p
            ad_d, gd_d, _ = ops[d]
            c2, v2, _, _ = _invoke_executor(
                run, dict(unit=unit, bucket=i, panel=p, shard=s), ad_d, gd_d,
                args[i][d], bounds[i][d])
            cols[i][d, :, :new_cap].copy_(c2)
            vals[i][d, :, :new_cap].copy_(v2)

    def exact_need(u) -> int:
        i, p = u
        bk, t = buckets[i], tables[i]
        need = 1
        for s in range(plan.row_shards):
            d = s * npan + p
            rows = t.table[d][t.valid[d]]
            if not rows.size:
                continue
            ad_d, gd_d, _ = ops[d]
            need = max(need, int(predictor_mod.exact_row_counts(
                ad_d, gd_d, rows, max_deg_a=bk.deg_a,
                max_deg_b=plan.panel_deg_b[i], route=bk.route, span=bk.span,
                use_kernel=plan.use_kernel,
                row_flop=plan._panel_flopr[p][rows]).max(initial=1)))
        return need

    def overflow_now() -> np.ndarray:
        dev_panel = np.arange(plan.num_shards) % npan
        return _shard_overflow(tables, nnz_host,
                               [caps[i, dev_panel] for i in range(len(caps))])

    def exhausted(bad, dropped):
        devs = np.flatnonzero(overflow_now())
        raise ShardFailureError(
            f"retry escalation exhausted with {int(dropped)} entries still "
            f"dropped (bucket×panel units {bad})",
            shards=[int(d) // npan for d in devs], observed=int(dropped),
            plan_key=_plan_key_id(plan))

    def commit(final) -> None:
        plan.panel_caps = np.where(final != alloc0, final, plan.panel_caps)
        plan.shard_tables = tuple(
            dataclasses.replace(t, capacity=int(cols[i].shape[2]))
            for i, t in enumerate(tables))

    left = _escalate(
        plan, [(i, p) for i in range(len(tables)) for p in range(npan)],
        {(i, p): np.where(t.valid[p::npan], nnz_host[i][p::npan], 0).ravel()
         for i, t in enumerate(tables) for p in range(npan)},
        caps, int(out.shard_overflow.sum()), rerun, exact_need, commit,
        exhausted=exhausted)
    if left is None:
        return out
    return DistSpgemmOut(tuple(cols), tuple(vals), out.row_nnz,
                         overflow_now())


def _widen_block(block: torch.Tensor, width: int, fill) -> torch.Tensor:
    """A stacked ``(num_shards, rows_pb, w)`` block widened to ``width``
    slots (sentinel or 0 fill) — splicing only ever widens buffers."""
    if block.shape[-1] >= width:
        return block
    grown = torch.full(block.shape[:-1] + (width,), fill, dtype=block.dtype,
                       device=block.device)
    grown[..., :block.shape[-1]] = block
    return grown


def _execute_dist(plan: SpgemmPlan, a, b, mesh, cache: PlanCache
                  ) -> DistSpgemmOut:
    """The mesh branch of :func:`execute`."""
    mesh = mesh if mesh is not None else plan.mesh
    if mesh is None:
        raise PlanMismatchError(
            "distributed plan needs a mesh (plan_spgemm(mesh=...)"
            " or execute(..., mesh=...))", plan_key=_plan_key_id(plan))
    if not isinstance(mesh, mesh_mod.Mesh):
        raise PlanMismatchError(
            f"mesh must be a repro_torch.core.mesh.Mesh, got "
            f"{type(mesh).__name__}", field="mesh")
    if int(mesh.shape.get(plan.axis, 0)) != plan.num_shards:
        raise PlanMismatchError(
            f"plan was built for {plan.num_shards} shards but mesh axis "
            f"{plan.axis!r} has {int(mesh.shape.get(plan.axis, 0))} devices "
            "— re-plan with this mesh",
            observed=int(mesh.shape.get(plan.axis, 0)),
            planned=plan.num_shards, plan_key=_plan_key_id(plan))
    first = mesh.devices[0]
    if plan.n_panels:
        # the structure checks are O(nnz) host passes — the PLANNED operands
        # (the common serving identity) skip them
        planned = (plan._planned_pair[0] if plan._planned_pair is not None
                   else (None, None))
        if b is not planned[1]:
            b = _check_panel_operand(plan, b, "b")
        if a is not planned[0]:
            # the gather baked A's remapped columns too
            a = _check_panel_operand(plan, a, "a")
        ad = _coerce_one(plan, a, "a", 0)
        ops = _panel_dist_operands(plan, ad, b, mesh)
        metas = tuple(_panel_meta(bk, db, t.capacity)
                      for bk, db, t in zip(plan.binning.buckets,
                                           plan.panel_deg_b,
                                           plan.shard_tables))
        unit = "dist-panels"
    else:
        ops = _dist_operands(plan, _coerce_one(plan, a, "a", 0),
                             _coerce_one(plan, b, "b", 1), mesh)
        metas = tuple(_bucket_meta(bk, t.capacity)
                      for bk, t in zip(plan.binning.buckets,
                                       plan.shard_tables))
        unit = "dist"
    if not plan.binning.buckets:
        return DistSpgemmOut((), (), (), np.zeros(plan.num_shards,
                                                  dtype=np.int64))
    run = cache.executor(_executor_key(plan, mesh),
                         lambda: _build_dist_executor(metas,
                                                      plan.use_kernel))
    try:
        cols, vals, nnzs = _invoke_executor(
            run, dict(unit=unit), ops, _shard_args(plan, mesh),
            plan.shard_flop_bounds(), _shard_live(plan), first,
            **_wave_budget(plan, mesh))
    except ShardFailureError as e:
        # the wave is all-or-nothing; recovery re-executes it as (bucket ×
        # shard) units, checkpointing each as it lands, and re-homes a lost
        # shard's rows on the survivors (DESIGN.md §12)
        from . import recovery as recovery_mod
        if plan.n_panels:
            return recovery_mod.recover_dist_panels(plan, ops, mesh, cache,
                                                    e)
        return recovery_mod.recover_dist(plan, ops, mesh, cache, e)
    nnz_host = _nnz_to_host(nnzs)
    out = DistSpgemmOut(cols, vals, nnzs, _shard_overflow(
        plan.shard_tables, nnz_host,
        [t.capacity for t in plan.shard_tables]))
    if plan.retry_policy is not None:
        replan = _replan_dist_panels if plan.n_panels else _replan_dist
        out = replan(plan, ops, out, nnz_host, cache, mesh)
    return out


def _execute_panels(plan: SpgemmPlan, a, b, cache: PlanCache
                    ) -> PanelSpgemmOut:
    """The panel branch of :func:`execute`."""
    # the structure check is an O(nnz) host pass — the PLANNED operand
    # (the common serving identity) skips it
    planned = (plan._planned_pair[0] if plan._planned_pair is not None
               else (None, None))
    with tracing.span("execute.operands"):
        if b is not planned[1]:
            b = _check_panel_operand(plan, b)
        ad = _coerce_one(plan, a, "a", 0)
        bps = _panel_operands_local(plan, b)
    metas = tuple(
        tuple(_panel_meta(bk, plan.panel_deg_b[i],
                          int(plan.panel_caps[i, p]))
              for p in range(plan.n_panels))
        for i, bk in enumerate(plan.binning.buckets))
    with tracing.span("execute.dispatch"):
        run = cache.executor(plan.key, lambda: _build_local_panel_executor(
            metas, plan.use_kernel, masked=plan.pop_quant))
        try:
            out = _invoke_executor(run, dict(unit="local-panels"), ad, bps,
                                   plan.device_args(),
                                   plan.panel_flop_bounds(),
                                   plan.valid_rows(), **_wave_budget(plan))
        except StragglerError as e:
            # a straggling wave replays per (bucket × panel) unit — completed
            # units checkpoint in the recovery ledger
            from . import recovery as recovery_mod
            out = recovery_mod.recover_local_panels(plan, ad, bps, cache, e)
    if plan.retry_policy is not None:
        out = _replan_local_panels(plan, ad, bps, out, cache)
    return out


@tracing.spanned("execute")
def execute(plan: SpgemmPlan, a, b, *, mesh=None,
            cache: PlanCache | None = None):
    """Run the planned numeric phase on the plan's device.

    ``a``/``b`` may be host ``CSR`` (converted at the plan's padded
    capacities) or pre-converted ``CSRDevice``.  Executors are served from
    ``cache`` (default: the session cache) keyed on the plan's static
    signature — a second same-keyed plan reuses the executor.

    Plans armed with ``retry_safety`` or ``retry_policy`` run the overflow
    re-planning loop: a bucket whose true ``row_nnz`` passed its capacity is
    re-executed at a bumped (pow2-rounded) capacity and spliced back — the
    plan's capacities are updated in place, so a second :func:`execute` of
    the same plan allocates right the first time.

    Panel plans (``n_panels``) return a :class:`PanelSpgemmOut`: ``b`` must
    then be the host ``CSR`` of the planned structure (the panel slices
    bake it in; checked by structure unless it is the planned object),
    and re-planning runs per (bucket × panel) unit.

    Plans armed with a :class:`DispatchBudget` time the wave; a straggling
    wave (:class:`StragglerError`) replays unit by unit through
    ``core.recovery`` (ledger in ``plan.recoveries``), then re-planning
    runs on the replayed result as on the wave's.

    Distributed plans run on ``mesh`` (default: the plan's) and return a
    :class:`DistSpgemmOut`; a wave that fails — an executor error, a lost
    shard or a straggler — re-executes unit by unit and re-homes a lost
    shard's rows on the survivors (``core.recovery``)."""
    cache = cache if cache is not None else _DEFAULT_CACHE
    plan.recoveries = []               # observability covers the LAST execute
    if plan.distributed:
        return _execute_dist(plan, a, b, mesh, cache)
    if plan.n_panels:
        return _execute_panels(plan, a, b, cache)
    with tracing.span("execute.operands"):
        ad = _coerce_one(plan, a, "a", 0)
        bd = _coerce_one(plan, b, "b", 1)
    metas = tuple(_bucket_meta(bk, cap)
                  for bk, cap in zip(plan.binning.buckets,
                                     plan.alloc.bucket_capacities))
    with tracing.span("execute.dispatch"):
        run = cache.executor(
            plan.key, lambda: _build_local_executor(
                metas, plan.shape_a[0], plan.alloc.row_capacity,
                plan.use_kernel, masked=plan.pop_quant))
        try:
            out = _invoke_executor(run, dict(unit="local"), ad, bd,
                                   plan.device_args(), plan.flop_bounds(),
                                   plan.valid_rows(), **_wave_budget(plan))
        except StragglerError as e:
            from . import recovery as recovery_mod
            out = recovery_mod.recover_local(plan, ad, bd, cache, e)
    if plan.retry_policy is not None:
        out = _replan_local(plan, ad, bd, out, cache)
    return out


def _gather_runs(kept_n: torch.Tensor, src: torch.Tensor, flat_c: list,
                 flat_v: list, nrows: int, ncols: int) -> tuple[CSR, int]:
    """One host CSR from runs of kept slots, without a sort.

    ``kept_n[r, p]`` is the number of slots row ``r`` keeps in its run of
    group ``p`` (a panel; one group without panels) and ``src[r, p]`` that
    run's offset in the concatenation of ``flat_c``/``flat_v``.  A row's
    entries are its runs in group order.  The row pointers (the only
    read-back) are the running sum of the kept counts, and one gather
    compacts every run.  Returns the CSR and the number of sentinel slots
    the gather picked up (0 unless a count was wrong; a device scalar, so
    the caller reads it back with its own checks)."""
    dev = kept_n.device
    rpt_d = torch.zeros(nrows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(kept_n.sum(dim=1), dim=0, out=rpt_d[1:])
    rpt = rpt_d.cpu().numpy()
    total = int(rpt[-1])
    col = torch.empty(0, dtype=torch.int32, device=dev)
    val = torch.empty(0, dtype=torch.float32, device=dev)
    holes = torch.zeros((), dtype=torch.int64, device=dev)
    if flat_c:
        # the runs tile [0, total) in (row, group) order: output slot t
        # reads flat slot t + (src - start) of the run it falls in
        start = rpt_d[:-1, None] + torch.cumsum(kept_n, dim=1) - kept_n
        idx = torch.arange(total, dtype=torch.int64, device=dev) \
            + torch.repeat_interleave((src - start).reshape(-1),
                                      kept_n.reshape(-1), output_size=total)
        col = torch.cat(flat_c)[idx]
        val = torch.cat(flat_v)[idx]
        holes = (col == COL_SENTINEL).sum()
    return CSR(rpt=rpt, col=col.cpu().numpy(), val=val.cpu().numpy(),
               shape=(nrows, ncols)), holes


def _reassemble_panels(plan: SpgemmPlan, out: PanelSpgemmOut, nrows: int,
                       ncols: int) -> CSR:
    """One host CSR from the (bucket × panel) blocks, without a sort.

    A row's entries are its bucket's panel blocks read in panel order, each
    block's first ``min(row_nnz, cap)`` slots (columns ascending inside a
    panel, panels ascending): the JAX package's stable ``from_coo`` order.
    All of it is built on the device, with no read-back per unit: an
    ``(M, n_panels)`` table of clamped counts gives the row pointers (read
    back once), and each (row, panel) run's offset in the flattened blocks
    against its offset in the output gives one gather that compacts every
    block."""
    buckets = plan.binning.buckets
    dev = plan.device
    tables = plan.device_args()
    keys = [(i, p) for i, bk in enumerate(buckets) if bk.n_rows
            for p in range(plan.n_panels)]
    kept_n = torch.zeros((nrows, plan.n_panels), dtype=torch.int64,
                         device=dev)
    src = torch.zeros_like(kept_n)     # each block row's flat offset
    off = 0
    for i, p in keys:
        c = out.cols[i][p]
        rows = tables[i][:buckets[i].n_rows].long()
        kept_n[rows, p] = torch.clamp(out.row_nnz[i][p].long(),
                                      max=int(plan.panel_caps[i, p]))
        src[rows, p] = off + c.shape[1] * torch.arange(
            c.shape[0], dtype=torch.int64, device=dev)
        off += c.numel()
    flat_c = [out.cols[i][p].reshape(-1) for i, p in keys]
    c, holes = _gather_runs(kept_n, src, flat_c,
                            [out.vals[i][p].reshape(-1) for i, p in keys],
                            nrows, ncols)
    if keys:
        kept, holes = torch.stack([
            sum((f != COL_SENTINEL).sum() for f in flat_c), holes]).tolist()
        if kept != c.nnz or holes:
            raise RuntimeError(
                f"reassemble: {kept} entries kept in the panel blocks but "
                f"their row counts clamped to the plan's capacities sum to "
                f"{c.nnz}")
    return c


def _reassemble_dist(plan: SpgemmPlan, out: DistSpgemmOut, nrows: int,
                     ncols: int) -> CSR:
    """One host CSR from the stacked shard blocks, on the device.

    Each VALID block row is one row's run (one per panel with panels,
    device ``d`` holding panel ``d % P``); pad rows — a shard's repeats of
    its last row, or any bucket row where it owns none — are never read.
    A run keeps its slots up to the first sentinel (the columns of a block
    row ascend, and the sentinel is the largest int32), found by one
    ``searchsorted`` a block, whatever width each unit ran at; the runs
    are then compacted by one gather, as the panel blocks are."""
    npan = max(1, plan.n_panels)
    dev = out.cols[0].device if out.cols else plan.device
    kept_n = torch.zeros((nrows, npan), dtype=torch.int64, device=dev)
    src = torch.zeros_like(kept_n)
    flat_c, flat_v = [], []
    off = 0
    for t, c, v in zip(plan.shard_tables, out.cols, out.vals):
        n_sh, pb, width = c.shape
        flat = c.reshape(n_sh * pb, width)
        keep = np.flatnonzero(t.valid.reshape(-1))
        if keep.size:
            cnt = torch.searchsorted(
                flat, torch.full((n_sh * pb, 1), COL_SENTINEL,
                                 dtype=torch.int32, device=dev)).squeeze(1)
            sel = torch.from_numpy(keep).to(dev)
            rows = torch.from_numpy(
                t.table.reshape(-1)[keep].astype(np.int64)).to(dev)
            grp = (sel // pb) % npan
            kept_n[rows, grp] = cnt[sel]
            src[rows, grp] = off + sel * width
        flat_c.append(c.reshape(-1))
        flat_v.append(v.reshape(-1))
        off += c.numel()
    csr, holes = _gather_runs(kept_n, src, flat_c, flat_v, nrows, ncols)
    holes = int(holes)
    if holes:
        raise RuntimeError(f"reassemble: {holes} sentinel slots inside the "
                           "shard blocks' kept runs")
    return csr


def _check_overflow(total: int, per_shard, on_overflow: str) -> None:
    if on_overflow not in ("raise", "ignore"):
        raise PlanMismatchError(f"on_overflow must be 'raise' or 'ignore', "
                                f"got {on_overflow!r}")
    if total and on_overflow == "raise":
        shards = [int(s) for s in np.asarray(per_shard)]
        raise CapacityExhaustedError(
            f"SpGEMM overflow: {total} entries dropped "
            f"(per shard: {shards}); re-plan with a higher safety factor "
            "or pass on_overflow='ignore'",
            observed=int(total), shards=shards)


def reassemble(plan: SpgemmPlan, out, ncols: int | None = None, *,
               on_overflow: str = "raise") -> CSR:
    """Stitch an :func:`execute` result (a ``SpGEMMOut``, a panel plan's
    ``PanelSpgemmOut`` or a distributed plan's ``DistSpgemmOut``) back into
    one host CSR.

    Overflow (entries dropped for capacity) RAISES by default instead of
    silently truncating the result — pass ``on_overflow="ignore"`` to get
    the truncated matrix anyway.
    """
    ncols = int(ncols if ncols is not None else plan.shape_b[1])
    nrows = plan.shape_a[0]
    if isinstance(out, DistSpgemmOut):
        shard_overflow = np.asarray(out.shard_overflow)
        _check_overflow(int(shard_overflow.sum()), shard_overflow,
                        on_overflow)
        return _reassemble_dist(plan, out, nrows, ncols)
    overflow = int(out.overflow)
    _check_overflow(overflow, [overflow], on_overflow)
    if isinstance(out, PanelSpgemmOut):
        return _reassemble_panels(plan, out, nrows, ncols)
    # each row keeps its first min(row_nnz, its bucket's capacity) slots,
    # columns ascending (every route writes them so), so the kept entries,
    # read row by row, are already in CSR order: the row pointers are the
    # clamped counts' running sum and nothing is sorted.  One flat gather
    # compacts them on the device (a row sum of the whole (M, W) mask would
    # take 8 bytes a slot)
    caps = torch.tensor(plan.alloc.bucket_capacities, dtype=torch.int32)
    counts = torch.minimum(
        out.row_nnz.cpu(),
        caps[torch.from_numpy(plan.binning.row_bucket).long()])
    rpt = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(counts.numpy(), out=rpt[1:])
    col = out.col.reshape(-1)
    kept = torch.nonzero(col != COL_SENTINEL).squeeze(1)
    if kept.numel() != rpt[-1]:
        raise RuntimeError(
            f"reassemble: {kept.numel()} entries kept in the output but its "
            f"row counts clamped to the plan's capacities sum to {rpt[-1]}")
    # the copies back are int32 and float32 already: no second host copy
    return CSR(rpt=rpt, col=col[kept].cpu().numpy().astype(np.int32,
                                                            copy=False),
               val=out.val.reshape(-1)[kept].cpu().numpy().astype(
                   np.float32, copy=False),
               shape=(nrows, ncols))
