"""Deterministic, seedable fault injection for the plan/execute pipeline
(DESIGN.md §9).

The containment contract — under any injected fault, ``execute()`` /
``reassemble()`` either produce a result bitwise-equal to the dense oracle
or raise the matching typed :mod:`repro_torch.core.errors` subclass, never a
silently corrupted matrix — is only provable if faults can be injected on
demand.  This module provides the hooks, all plumbed through plan-time /
execute-time host code (never inside traced executors, so the no-fault path
costs nothing and the executors stay fault-free):

    with faults.inject(capacity_scale=0.25):
        plan = plan_spgemm(a, b, retry_policy=RetryPolicy())   # starved caps

Fault classes (one keyword each, composable):

* ``capacity_scale`` — scale every predicted output capacity down at
  allocation time (``predictor.AllocationPlan.from_prediction``), modeling
  a predictor that under-shoots uniformly.
* ``sketch_scale`` — corrupt the sampled sketch after prediction: the
  per-row structure is scaled by ``sketch_scale`` with seeded multiplicative
  jitter, the compression ratio inflated to match — the paper's "sampled
  rows were unlucky" failure, end to end.
* ``gather_scale`` — starve the panel-gather entry capacities
  (``PanelGather.ecap`` / the single-device per-panel operand caps) below
  the real payload.
* ``fail_executor`` / ``on_call`` — raise :class:`InjectedFault` on the
  Nth invocation of any executor whose dispatch info matches the given
  key/value filter (e.g. ``{"bucket": 2}`` or ``{"unit": "local"}``).
* ``delay_executor`` / ``delay_s`` — simulated per-dispatch latency:
  every dispatch matching the filter reports ``delay_s`` extra seconds to
  the straggler watchdog (``plan.DispatchBudget``), which turns a blown
  budget into a typed :class:`~repro_torch.core.errors.StragglerError` and
  hands the wave to per-unit recovery (``core.recovery``).  Nothing
  sleeps: the delay is added to the measured time.
* ``lose_shard`` — a PERSISTENT failure pinned to one shard id: every
  dispatch attributed to that shard (``info["shard"] == lose_shard``), and
  every fused distributed wave that includes it (``unit`` of ``"dist"`` /
  ``"dist-panels"`` with no shard attribution), raises
  :class:`InjectedFault` — unlike ``fail_executor`` this never clears, so
  recovery (``core.recovery``) must re-home the shard's rows onto the
  survivors.

Everything is deterministic given ``seed``; nesting ``inject`` contexts
stacks (innermost wins per fault class).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np


class InjectedFault(RuntimeError):
    """Raised by an armed ``fail_executor`` hook; the pipeline wraps it into
    :class:`repro_torch.core.errors.ShardFailureError` naming the unit."""


@dataclasses.dataclass(eq=False)   # identity compare: the inject() unwind
class FaultState:                  # must never pop a LOOK-ALIKE sibling
    capacity_scale: float | None = None
    sketch_scale: float | None = None
    gather_scale: float | None = None
    fail_executor: dict | None = None
    delay_executor: dict | None = None
    delay_s: float = 1.0
    lose_shard: int | None = None
    on_call: int = 1
    seed: int = 0
    executor_calls: int = 0      # matching-dispatch counter (mutable)


_STACK: list[FaultState] = []


def _active(field: str) -> FaultState | None:
    """Innermost injected state that arms ``field`` (None = no fault)."""
    for st in reversed(_STACK):
        if getattr(st, field) is not None:
            return st
    return None


@contextlib.contextmanager
def inject(*, capacity_scale: float | None = None,
           sketch_scale: float | None = None,
           gather_scale: float | None = None,
           fail_executor: dict | None = None,
           delay_executor: dict | None = None,
           delay_s: float = 1.0,
           lose_shard: int | None = None,
           on_call: int = 1, seed: int = 0):
    """Arm the selected fault classes for the dynamic extent of the block."""
    st = FaultState(capacity_scale=capacity_scale, sketch_scale=sketch_scale,
                    gather_scale=gather_scale, fail_executor=fail_executor,
                    delay_executor=delay_executor, delay_s=float(delay_s),
                    lose_shard=lose_shard,
                    on_call=int(on_call), seed=int(seed))
    _STACK.append(st)
    try:
        yield st
    finally:
        # Re-entrancy guard: unwind by IDENTITY, tolerating double exit and
        # a stack perturbed by the guarded block raising — the hooks are
        # restored no matter how the block leaves, so a service worker loop
        # can never leak an armed fault from one request into the next.
        for i in range(len(_STACK) - 1, -1, -1):
            if _STACK[i] is st:
                del _STACK[i]
                break


def armed() -> bool:
    """True while any ``inject`` context is active (observability hook —
    the serving layer stamps it into per-request stats)."""
    return bool(_STACK)


# --------------------------------------------------------------------------- #
# Hooks (called from plan/predictor host code; no-ops when nothing is armed)
# --------------------------------------------------------------------------- #
def scale_capacity(cap: int) -> int:
    st = _active("capacity_scale")
    if st is None:
        return cap
    return max(1, int(cap * st.capacity_scale))


def scale_gather_cap(cap: int) -> int:
    st = _active("gather_scale")
    if st is None:
        return cap
    return max(1, int(cap * st.gather_scale))


def corrupt_sketch(structure: np.ndarray, predicted_nnz: float,
                   cr: float) -> tuple[np.ndarray, float, float]:
    """Scale the predicted per-row structure by ``sketch_scale`` with seeded
    per-row jitter, keeping (structure, nnz, cr) self-consistent."""
    st = _active("sketch_scale")
    if st is None:
        return structure, predicted_nnz, cr
    rng = np.random.default_rng(st.seed)
    jitter = rng.uniform(0.5, 1.0, size=structure.shape)
    corrupted = structure * st.sketch_scale * jitter
    return corrupted, float(corrupted.sum()), cr / max(st.sketch_scale, 1e-9)


def check_executor(info: dict) -> None:
    """Dispatch-time hook: raise :class:`InjectedFault` when this dispatch
    matches the armed filter and the matching-call counter hits ``on_call``,
    or (persistently) when it touches a lost shard."""
    ls = _active("lose_shard")
    if ls is not None and _touches_lost_shard(info, ls.lose_shard):
        raise InjectedFault(
            f"injected shard loss (shard {ls.lose_shard}) at {info}")
    st = _active("fail_executor")
    if st is None:
        return
    if all(info.get(k) == v for k, v in st.fail_executor.items()):
        st.executor_calls += 1
        if st.executor_calls == st.on_call:
            raise InjectedFault(
                f"injected executor fault (call {st.on_call}) at {info}")


def executor_delay(info: dict) -> float:
    """Dispatch-time hook: simulated extra seconds this dispatch took.
    Returns 0.0 unless a ``delay_executor`` filter matches — the delay is
    ADDED to the measured wall time by ``plan._invoke_executor`` (never a
    real sleep, so chaos tests stay fast and deterministic)."""
    st = _active("delay_executor")
    if st is None:
        return 0.0
    if all(info.get(k) == v for k, v in st.delay_executor.items()):
        return st.delay_s
    return 0.0


def _touches_lost_shard(info: dict, sid: int) -> bool:
    """A dispatch touches the lost shard when it is attributed to it, or
    when it is a fused distributed wave (no per-shard attribution — the lost
    device takes part in the wave, so the whole wave dies).  A recovery
    dispatch attributed to a SURVIVOR escapes, which is exactly the
    contract re-homing relies on."""
    if "shard" in info:
        return info["shard"] == sid
    return info.get("unit") in ("dist", "dist-panels")
