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
     SPA or BIN; with ``use_kernel`` through that route's CUDA kernel).

Executors are built once per *plan key* — matrix shapes, padded device-CSR
capacities and the ordered per-bucket ``(signature, population, capacity)``
tuples — so repeated same-structure SpGEMMs reuse one executor;
``PlanCache.stats()["traces"]`` counts executor builds.

Not ported yet, and refused with :class:`PlanMismatchError` when asked for:
distributed plans (``mesh``/``num_shards``), column panels (``n_panels``),
plan templates, population quantization, overflow re-planning
(``retry_safety``/``retry_policy``) and the straggler watchdog
(``dispatch_budget``).

Public API::

    plan = plan_spgemm(a, b, use_kernel=True)   # route="auto"
    out  = execute(plan, a, b)                  # SpGEMMOut
    c    = reassemble(plan, out, ncols=b.ncols) # host CSR
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.formats import CSR
from . import binning as binning_mod
from . import csr as csr_mod
from . import oracle
from . import predictor as predictor_mod
from . import validate as validate_mod
from .csr import COL_SENTINEL, CSRDevice
from .errors import (CapacityExhaustedError, OperandValidationError,
                     PlanMismatchError)
from .spgemm import SpGEMMOut, assemble, routed_spgemm_rows


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


def _plan_key_id(plan) -> str:
    """Short stable fingerprint of ``plan.key`` for error context."""
    return format(hash(plan.key) & 0xFFFFFFFF, "08x")


@dataclasses.dataclass(eq=False)   # identity compare; plans match via .key
class SpgemmPlan:
    """The plan: prediction + capacities + executor key, on one device."""

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
    validation: dict = dataclasses.field(
        default_factory=lambda: dict(operands_validated=0))
    _device_args: tuple | None = dataclasses.field(default=None, repr=False)
    _flop_bounds: tuple | None = dataclasses.field(default=None, repr=False)
    # ((host_a, host_b), (ad, bd)) from planning — execute() on the planned
    # operands reuses the prediction pass's upload instead of a second copy
    _planned_pair: tuple | None = dataclasses.field(default=None, repr=False)

    def device_args(self) -> tuple:
        """Executor row tables (one row-id tensor per bucket), uploaded once
        per plan."""
        if self._device_args is None:
            self._device_args = tuple(
                torch.from_numpy(bk.rows).to(self.device)
                for bk in self.binning.buckets)
        return self._device_args

    def flop_bounds(self) -> tuple:
        """Each bucket's largest row FLOP (``flopr``), the bound the numeric
        kernels size their workspaces by.  It travels with every call,
        beside :meth:`device_args`, and never enters :attr:`key`: a cached
        executor serves same-keyed plans whose rows carry other FLOP."""
        if self._flop_bounds is None:
            self._flop_bounds = tuple(
                int(self.flopr[bk.rows].max()) if bk.n_rows else 0
                for bk in self.binning.buckets)
        return self._flop_bounds

    @property
    def key(self) -> tuple:
        """The static half of the executor contract, laid out as the JAX
        package's single-device key (no shards, no quantization)."""
        buckets = tuple(
            (bk.signature, bk.n_rows, int(cap))
            for bk, cap in zip(self.binning.buckets,
                               self.alloc.bucket_capacities))
        return ("spgemm-plan", 0, "data", self.use_kernel, False,
                self.shape_a, self.shape_b, self.cap_a, self.cap_b,
                self.alloc.row_capacity, buckets)

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
        return dict(
            predicted_nnz=round(float(self.predicted_nnz), 1),
            compression_ratio=round(float(self.compression_ratio), 4),
            num_buckets=len(self.binning.buckets),
            lane_reduction=round(self.binning.lane_reduction, 3),
            route_rows=self.binning.route_rows(),
            bucket_capacities=list(self.alloc.bucket_capacities),
            total_capacity=int(self.alloc.total_capacity),
            device=str(self.device),
            validation=dict(self.validation),
        )


def _device_capacity(nnz: int) -> int:
    """pow2-padded device-CSR capacity: same-family matrices land on the
    same padded capacity and so on the same executor key."""
    return binning_mod.ceil_pow2(max(8, int(nnz)))


# The JAX planner's options this port does not carry yet, with the value
# that leaves each one off.
_UNPORTED = dict(mesh=None, num_shards=None, n_panels=0, template=None,
                 pop_quant=False, retry_safety=0.0, retry_policy=None,
                 dispatch_budget=None)


def plan_spgemm(a: CSR, b: CSR, *, seed: int = 0, safety: float = 1.3,
                route: str = "auto", use_kernel: bool = False,
                sample_rows: np.ndarray | None = None,
                min_rows: int = binning_mod.DEFAULT_MIN_ROWS,
                deg_align: int = 1, validate: bool = True, device=None,
                **unported) -> SpgemmPlan:
    """Plan ``C = A·B``: sample → predict (binned) → per-bucket capacities.

    ``a``/``b`` are host ``CSR``; planning is a launch-time host step, and
    the prediction pass runs on ``device`` (default: the CUDA card; with
    none present this raises unless ``device="cpu"`` is given).  ``route``
    picks each bucket's accumulator: ``"auto"`` by the analytic cost model,
    or ``"esc"``/``"spa"``/``"bin"`` for every bucket; the plan's buckets,
    prediction and capacities do not depend on it.  Any of the JAX
    planner's distributed, panel, template, quantization, retry or watchdog
    options raises :class:`PlanMismatchError` (not ported yet).
    """
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"plan_spgemm() got an unexpected keyword "
                            f"argument {name!r}")
        if value != _UNPORTED[name]:
            raise PlanMismatchError(
                f"plan_spgemm({name}=...) is not ported yet: the port plans "
                "single-device execution only", field=name)
    dev = csr_mod.resolve_device(device)
    operands_validated = 0
    if validate:
        validate_mod.validate_pair(a, b)
        operands_validated = 2
    elif a.ncols != b.nrows:
        raise OperandValidationError(
            f"operand shapes {a.shape} and {b.shape} are incompatible "
            f"for A·B", observed=int(b.nrows), planned=int(a.ncols))
    binplan = binning_mod.build_plan(a, b, route=route, min_rows=min_rows,
                                     deg_align=deg_align)
    flopr, total_flop = oracle.flop_per_row(a, b)
    if sample_rows is None:
        sample_rows = (oracle.sample_rows(a.nrows, seed) if a.nrows
                       else np.zeros(0, dtype=np.int64))
    sample_rows = np.asarray(sample_rows, dtype=np.int64)

    cap_a = _device_capacity(a.nnz)
    cap_b = _device_capacity(b.nnz)
    devpair = None
    if total_flop > 0 and sample_rows.size:
        ad = csr_mod.to_device(a, capacity=cap_a, device=dev)
        bd = csr_mod.to_device(b, capacity=cap_b, device=dev)
        devpair = (ad, bd)
        pred = predictor_mod.proposed_predict_binned(
            ad, bd, torch.from_numpy(sample_rows.astype(np.int32)).to(dev),
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
    else:
        structure = np.zeros(a.nrows, dtype=np.float64)
        predicted_nnz = 0.0
        cr = 1.0

    alloc = predictor_mod.BinnedAllocationPlan.from_prediction(
        binplan, structure, flopr, safety=safety)
    plan = SpgemmPlan(
        binning=binplan, alloc=alloc, structure=structure, flopr=flopr,
        predicted_nnz=predicted_nnz, compression_ratio=cr,
        sample_rows=sample_rows, shape_a=a.shape, shape_b=b.shape,
        cap_a=cap_a, cap_b=cap_b, safety=safety, use_kernel=use_kernel,
        device=dev)
    plan.validation["operands_validated"] = operands_validated
    if devpair is not None:
        plan._planned_pair = ((a, b), devpair)
    return plan


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


def _build_local_executor(metas: tuple, nrows: int, cap_out: int,
                          use_kernel: bool):
    """Single-device executor: per-bucket routed passes written in place
    into one ``(nrows, cap_out)`` output — the
    :func:`repro_torch.core.spgemm.spgemm_binned` dataflow, with the row
    tables and the buckets' FLOP bounds passed in so one executor serves
    every same-keyed plan."""

    def run(ad, bd, tables, flop_bounds):
        rownnz_b = torch.diff(bd.rpt)
        return assemble(nrows, cap_out, (
            (rows, _run_bucket(ad, bd, rows, meta, use_kernel, bound,
                               rownnz_b))
            for meta, rows, bound in zip(metas, tables, flop_bounds)),
            ad.device)

    return run


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


def execute(plan: SpgemmPlan, a, b, *, cache: PlanCache | None = None
            ) -> SpGEMMOut:
    """Run the planned numeric phase on the plan's device.

    ``a``/``b`` may be host ``CSR`` (converted at the plan's padded
    capacities) or pre-converted ``CSRDevice``.  Executors are served from
    ``cache`` (default: the session cache) keyed on the plan's static
    signature — a second same-keyed plan reuses the executor."""
    cache = cache if cache is not None else _DEFAULT_CACHE
    ad = _coerce_one(plan, a, "a", 0)
    bd = _coerce_one(plan, b, "b", 1)
    metas = tuple(_bucket_meta(bk, cap)
                  for bk, cap in zip(plan.binning.buckets,
                                     plan.alloc.bucket_capacities))
    run = cache.executor(
        plan.key, lambda: _build_local_executor(
            metas, plan.shape_a[0], plan.alloc.row_capacity,
            plan.use_kernel))
    return run(ad, bd, plan.device_args(), plan.flop_bounds())


def reassemble(plan: SpgemmPlan, out: SpGEMMOut, ncols: int | None = None, *,
               on_overflow: str = "raise") -> CSR:
    """Stitch an :func:`execute` result back into one host CSR.

    Overflow (entries dropped for capacity) RAISES by default instead of
    silently truncating the result — pass ``on_overflow="ignore"`` to get
    the truncated matrix anyway.
    """
    if on_overflow not in ("raise", "ignore"):
        raise PlanMismatchError(f"on_overflow must be 'raise' or 'ignore', "
                                f"got {on_overflow!r}")
    ncols = int(ncols if ncols is not None else plan.shape_b[1])
    nrows = plan.shape_a[0]
    overflow = int(out.overflow)
    if overflow and on_overflow == "raise":
        raise CapacityExhaustedError(
            f"SpGEMM overflow: {overflow} entries dropped; re-plan with a "
            "higher safety factor or pass on_overflow='ignore'",
            observed=overflow)
    keep = out.col != COL_SENTINEL          # compacted on the device
    rpt = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(keep.sum(dim=1).cpu().numpy(), out=rpt[1:])
    # every route writes a row's columns ascending into its first slots, so
    # the kept entries, read row by row, are already in CSR order: the row
    # pointers are the counts' running sum and nothing is sorted
    return CSR(rpt=rpt, col=out.col[keep].cpu().numpy().astype(np.int32),
               val=out.val[keep].cpu().numpy().astype(np.float32),
               shape=(nrows, ncols))
