"""Measured per-route microbenchmark profiles (DESIGN.md §11).

Two of the planner's cost models are analytic: ``choose_route`` compares
lane-op formulas and the admission controller prices requests from
hard-coded throughput constants.  This module is the measured substrate
replacing both: an offline profiling pass times every accumulator route
(esc / spa / bin, symbolic + numeric phases) on synthetic single-regime
operands over a small grid of ``(width, span)`` cells, and the result — a
versioned JSON profile keyed on the device kind — feeds

  * :func:`repro_torch.core.binning.choose_route` — measured per-row
    seconds replace the analytic :func:`~repro_torch.core.binning.
    route_costs` numbers (structural gates still apply);
  * :func:`repro_torch.serve.admission.estimate` — :func:`throughput`
    supplies the effective FLOP/s and bytes/s used to price
    ``est_seconds``; and
  * :class:`repro_torch.core.plan.DispatchBudget` — :func:`unit_seconds`
    prices each dispatch the straggler watchdog times.

Cold-start contract: with no active profile (or a corrupt / stale one) all
consumers fall back to the analytic model.  A failed :func:`load` emits a
:class:`ProfileLoadWarning` AND records it so ``plan.stats()`` surfaces the
degraded state (``route_profile.warning``).

The active profile is ONLY ever set explicitly (:func:`set_active` /
``load(path, activate=True)``) — never auto-discovered from disk at import —
so planners and tests are deterministic unless a caller opts in.

The file format is the JAX package's, byte for byte in its keys: a profile
written by either package parses in the other.  The device kind is
``torch.cuda.get_device_name`` on the card and ``"cpu"`` on the host, so a
profile measured on another device (a TPU, or the host) never loads on the
card: it degrades to the analytic model with a warning.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
import warnings

import numpy as np
import torch

from . import binning as binning_mod

PROFILE_VERSION = 1

# the analytic cold-start device model: serving needs *relative* prices for
# deadline triage before any profile has been measured, not a calibrated
# roofline
ANALYTIC_FLOPS = 5e9       # effective sparse FLOP/s
ANALYTIC_BYTES_PER_S = 8e9
ENTRY_BYTES = 8            # int32 col + float32 val — one moved slot

# relative weight of the symbolic phase in route comparisons: symbolic runs
# on the sampled rows only (paper: 0.003·M; retries re-run it exactly on the
# overflowing bucket), numeric on every row — 0.01 is a conservative ceiling
# on the sampled share
SYM_WEIGHT = 0.01


class ProfileLoadWarning(UserWarning):
    """A route profile could not be used (corrupt, stale version, or wrong
    device); the planner and admission controller fall back to analytic."""


@dataclasses.dataclass(frozen=True)
class RouteProfile:
    """One device's measured route costs.

    ``cells`` is a tuple of dicts, one per measured ``(route, width, span)``
    cell: ``numeric_s`` / ``symbolic_s`` are per-row seconds of the two
    phases on the production executors.  ``flops`` / ``bytes_per_s`` are
    the effective throughputs derived from the ESC numeric cells — the
    admission controller's replacement for the analytic constants.
    """

    version: int
    device_kind: str
    flops: float
    bytes_per_s: float
    cells: tuple

    def route_seconds(self, route: str, width: int, span: int,
                      sym_weight: float = SYM_WEIGHT) -> float | None:
        """Measured per-row seconds for a bucket with gather width ``width``
        and column-extent bound ``span`` — nearest measured cell in log2
        distance, or ``None`` if the route has no cells (callers then fall
        the whole comparison back to analytic).

        The numeric phase runs on EVERY bucket row while the symbolic phase
        runs on the paper's ~0.003·M sample, so the symbolic term enters at
        ``sym_weight`` (:data:`SYM_WEIGHT`)."""
        cand = [c for c in self.cells if c["route"] == route]
        if not cand:
            return None
        w = max(1, int(width))
        s = max(1, int(span))

        def dist(c):
            return (math.log2(w / max(1, int(c["width"]))) ** 2
                    + math.log2(s / max(1, int(c["span"]))) ** 2)

        best = min(cand, key=dist)
        return (float(best["numeric_s"])
                + sym_weight * float(best["symbolic_s"]))

    def to_json(self) -> dict:
        return dict(version=int(self.version),
                    device_kind=str(self.device_kind),
                    flops=float(self.flops),
                    bytes_per_s=float(self.bytes_per_s),
                    cells=[dict(c) for c in self.cells])

    @staticmethod
    def from_json(doc: dict) -> "RouteProfile":
        cells = tuple(
            dict(route=str(c["route"]), width=int(c["width"]),
                 span=int(c["span"]), rows=int(c["rows"]),
                 numeric_s=float(c["numeric_s"]),
                 symbolic_s=float(c["symbolic_s"]))
            for c in doc["cells"])
        return RouteProfile(version=int(doc["version"]),
                            device_kind=str(doc["device_kind"]),
                            flops=float(doc["flops"]),
                            bytes_per_s=float(doc["bytes_per_s"]),
                            cells=cells)


# ------------------------------------------------------------------ #
# module state: the explicitly-activated profile + last load warning
# ------------------------------------------------------------------ #
_ACTIVE: RouteProfile | None = None
_WARNING: str | None = None


def device_kind(device=None) -> str:
    """The kind a profile is keyed on: the card's name
    (``torch.cuda.get_device_name``) for a CUDA device, ``"cpu"`` for the
    host.  ``device`` defaults to the card."""
    from .csr import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return str(torch.cuda.get_device_name(dev))
    return "cpu"


def active() -> RouteProfile | None:
    return _ACTIVE


def set_active(profile: RouteProfile | None) -> None:
    global _ACTIVE, _WARNING
    _ACTIVE = profile
    if profile is not None:
        _WARNING = None


def clear() -> None:
    global _ACTIVE, _WARNING
    _ACTIVE = None
    _WARNING = None


def save(profile: RouteProfile, path) -> None:
    with open(path, "w") as fh:
        json.dump(profile.to_json(), fh, indent=1, sort_keys=True)


def _degrade(msg: str, activate: bool) -> None:
    global _WARNING
    _WARNING = msg
    if activate:
        set_active(None)
        _WARNING = msg
    warnings.warn(msg, ProfileLoadWarning)


def load(path, *, activate: bool = True, device=None) -> RouteProfile | None:
    """Load a profile; corrupt / stale-version / wrong-device files return
    ``None`` with a :class:`ProfileLoadWarning` (recorded for
    :func:`status`) — the analytic fallback rule of DESIGN.md §11.  The
    profile must have been measured on the kind of ``device`` (default: the
    card)."""
    try:
        with open(path) as fh:
            prof = RouteProfile.from_json(json.load(fh))
    except (OSError, ValueError, KeyError, TypeError) as e:
        _degrade(f"route profile {path!r} unreadable ({e!r}): analytic "
                 "fallback", activate)
        return None
    reason = None
    kind = device_kind(device)
    if prof.version != PROFILE_VERSION:
        reason = f"version {prof.version} != {PROFILE_VERSION}"
    elif prof.device_kind != kind:
        reason = f"device kind {prof.device_kind!r} != {kind!r}"
    elif not prof.cells:
        reason = "no measured cells"
    if reason is not None:
        _degrade(f"route profile {path!r} stale ({reason}): analytic "
                 "fallback", activate)
        return None
    if activate:
        set_active(prof)
    return prof


def throughput() -> tuple[float, float]:
    """``(flops, bytes_per_s)`` pricing admission's ``est_seconds`` — the
    active profile's measured throughputs, or the analytic constants."""
    if _ACTIVE is not None:
        return float(_ACTIVE.flops), float(_ACTIVE.bytes_per_s)
    return ANALYTIC_FLOPS, ANALYTIC_BYTES_PER_S


def unit_seconds(route: str, width: int, span: int, rows: int) -> float:
    """Expected wall seconds for ONE dispatch unit: ``rows`` bucket rows of
    gather width ``width`` over column extent ``span``.

    Prices the straggler watchdog's :class:`~repro_torch.core.plan.
    DispatchBudget`: measured per-row seconds (:meth:`RouteProfile.
    route_seconds`, nearest log2 cell) when a profile is active, otherwise
    the analytic roofline — per-row FLOP time + moved-bytes time on the
    cold-start constants, the same both-terms-summed ceiling admission
    uses."""
    rows = max(1, int(rows))
    if _ACTIVE is not None:
        per_row = _ACTIVE.route_seconds(route, width, span)
        if per_row is not None:
            return per_row * rows
    w = max(1, int(width))
    flop = 2.0 * rows * w
    moved = 2.0 * rows * w * ENTRY_BYTES
    return flop / ANALYTIC_FLOPS + moved / ANALYTIC_BYTES_PER_S


def status() -> dict:
    """Cost-model provenance for ``plan.stats()`` / service stats."""
    if _ACTIVE is not None:
        return dict(source="measured", device_kind=_ACTIVE.device_kind,
                    version=_ACTIVE.version, n_cells=len(_ACTIVE.cells),
                    flops=float(_ACTIVE.flops),
                    bytes_per_s=float(_ACTIVE.bytes_per_s),
                    warning=_WARNING)
    return dict(source="analytic", device_kind=None, version=None,
                n_cells=0, flops=ANALYTIC_FLOPS,
                bytes_per_s=ANALYTIC_BYTES_PER_S, warning=_WARNING)


# ------------------------------------------------------------------ #
# the offline profiling pass
# ------------------------------------------------------------------ #
# the (width_a, width_b, span) grid covers the three regimes the router
# must separate: narrow gathers (esc), compact extents w ≫ span ≈ 10²
# (spa: banded/FEM), and wide extents with w ≫ span (bin: power-law hubs)
QUICK_GRID = ((2, 2, 64), (16, 32, 128), (32, 32, 1024), (64, 128, 1024))
FULL_GRID = ((2, 2, 64), (4, 4, 64), (8, 8, 128), (16, 32, 128),
             (32, 40, 128), (8, 8, 512), (16, 16, 1024), (32, 32, 4096),
             (64, 64, 4096), (128, 128, 4096))


def _synthetic_pair(width_a: int, width_b: int, span: int, m: int, seed: int):
    """One single-regime operand pair: every A row has ``width_a`` entries
    over ``m//2`` B rows, every B row ``width_b`` entries confined to a
    ``span``-wide column space — so the plan is (near-)single-bucket with
    gather width ≈ ``width_a·width_b`` and extent ≤ ``span``."""
    from repro_torch.sparse.formats import CSR
    rng = np.random.default_rng(seed)
    k = max(8, m // 2)
    ra = np.repeat(np.arange(m), width_a)
    ca = rng.integers(0, k, size=ra.size)
    a = CSR.from_coo(ra, ca, rng.random(ra.size).astype(np.float32) + 0.5,
                     (m, k))
    rb = np.repeat(np.arange(k), width_b)
    cb = rng.integers(0, span, size=rb.size)
    b = CSR.from_coo(rb, cb, rng.random(rb.size).astype(np.float32) + 0.5,
                     (k, span))
    return a, b


def _time(fn, reps: int, device) -> float:
    """Best of ``reps`` wall-clock runs of ``fn`` after one warm run; on a
    CUDA device each timed run is bracketed by a synchronize, so the time
    is the kernels' and not only their launches'."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    fn()                                 # build / load / warm
    sync()
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def microbenchmark(*, quick: bool = False, seed: int = 0,
                   device=None) -> RouteProfile:
    """Measure every route over a ``(width, span)`` grid on ``device``
    (default: the card).

    Times the PRODUCTION executors per forced-route plan, normalized to
    per-row seconds: the numeric phase (``spgemm.spgemm_binned``) and the
    exact symbolic pass (``predictor.exact_row_counts``), through their
    CUDA kernels on the card (numeric kernels 3, 5 and 6; the count modes
    2c and 4c) and their plain versions on the host.  A kernel that fails
    to build or launch raises.  Effective throughputs for admission derive
    from the ESC numeric cells (flop / seconds and moved-bytes / seconds
    summed over cells), so ``est_seconds`` stays an intentionally
    conservative ceiling: each term alone would explain the measured time.
    """
    from .csr import resolve_device, to_device
    from . import predictor as predictor_mod
    from . import spgemm as spgemm_mod

    dev = resolve_device(device)
    use_kernel = dev.type == "cuda"
    grid = QUICK_GRID if quick else FULL_GRID
    m, reps = (192, 1) if quick else (512, 3)
    cells = []
    flop_sum = bytes_sum = esc_sec = 0.0
    for ci, (wa, wb, span) in enumerate(grid):
        rows_m = max(32, min(m, (1 << 22) // max(1, wa * wb)))
        a, b = _synthetic_pair(wa, wb, span, rows_m, seed + ci)
        ad, bd = to_device(a, device=dev), to_device(b, device=dev)
        da = int(np.diff(a.rpt).max())
        db = int(np.diff(b.rpt).max())
        cap = binning_mod.ceil_pow2(min(span, max(1, da * db)))
        rows_all = np.arange(rows_m, dtype=np.int32)
        for route in binning_mod.ROUTES:
            plan = binning_mod.build_plan(a, b, route=route)
            t_num = _time(lambda p=plan: spgemm_mod.spgemm_binned(
                ad, bd, p, alloc=cap, use_kernel=use_kernel), reps, dev)
            sym_route = "" if route == binning_mod.ROUTE_ESC else route
            t_sym = _time(lambda r=sym_route: predictor_mod.exact_row_counts(
                ad, bd, rows_all, max_deg_a=da, max_deg_b=db, route=r,
                span=binning_mod.ceil_pow2(span), use_kernel=use_kernel),
                reps, dev)
            cells.append(dict(route=route, width=wa * wb, span=span,
                              rows=rows_m,
                              numeric_s=t_num / rows_m,
                              symbolic_s=t_sym / rows_m))
            if route == binning_mod.ROUTE_ESC:
                flop = 2.0 * rows_m * da * db        # multiply-add bound
                moved = 2.0 * rows_m * da * db * ENTRY_BYTES
                flop_sum += flop
                bytes_sum += moved
                esc_sec += t_num
    flops = flop_sum / esc_sec if esc_sec > 0 else ANALYTIC_FLOPS
    bps = bytes_sum / esc_sec if esc_sec > 0 else ANALYTIC_BYTES_PER_S
    return RouteProfile(version=PROFILE_VERSION, device_kind=device_kind(dev),
                        flops=float(flops), bytes_per_s=float(bps),
                        cells=tuple(cells))
