"""SpGEMM-as-a-service: a fault-contained request scheduler (DESIGN.md §10).

The plan cache + :class:`~repro_torch.core.plan.TemplateRegistry` make
repeated multiplies build no executor; this module is the front end that turns them into
a service: a stream of multiply requests (mixed families, mixed shapes)
moves through an explicit lifecycle and *no path hangs or silently
corrupts* —

::

    SUBMITTED ─ validate ──► ADMITTED ─ plan+price ──► PLANNED ──► EXECUTING
        │ queue full             │ deadline passed         │ breaker open /
        ▼                        ▼                         │ over budget
      SHED                    EXPIRED                      ▼
                                              DONE | DEGRADED | FAILED
                                              (requeue once on
                                               CapacityExhaustedError)

Admission uses the paper's sampled predictor as the cost model
(:mod:`repro_torch.serve.admission`): the plan's predicted FLOP + nnz price the
request in bytes/seconds BEFORE any executor allocates, requests that
would overflow the device budget wait in a bounded queue (backpressure),
the queue sheds with a typed
:class:`~repro_torch.core.errors.AdmissionRejectedError` when full, and
a deadline that passes while queued expires the request with
:class:`~repro_torch.core.errors.DeadlineExceededError`.  Scheduling is
deadline-AWARE (DESIGN.md §12): a non-positive deadline is rejected at
submit, a request whose priced ``est_seconds`` already exceeds its
remaining deadline is rejected typed at planning time
(``reason="deadline_unreachable"``), and each wave dispatches the
shortest-deadline request first.

Same-template requests batch into one dispatch wave through one cached
executor (no executor build in steady state — pinned by
``tests/test_torch_service.py``).  Executor failures surface as typed
errors and drive a per-template circuit breaker (consecutive
:class:`~repro_torch.core.errors.ShardFailureError` → OPEN → cooldown →
HALF_OPEN probe → reset);
:class:`~repro_torch.core.errors.CapacityExhaustedError` requeues the
request ONCE at an escalated :class:`~repro_torch.core.plan.RetryPolicy`
before failing it with its
degradation ledger attached (``plan.stats()["degradations"]`` →
``request.stats["degradations"]``).  A failure that per-unit recovery
(:mod:`repro_torch.core.recovery`) repaired never reaches the breaker: the
request terminates DEGRADED — correct result, recovery ledger in
``request.stats["recoveries"]`` — and only UNRECOVERED failures count
toward tripping.

The service is a synchronous event loop (``submit`` / ``step`` /
``drain``) — every scheduling decision happens at a visible program point,
which is what makes the chaos soak (the ``core.faults`` classes armed over
mixed traffic) deterministic.

This is the JAX package's service.  ``ServiceConfig.device`` (default:
the CUDA card, or the mesh's first device) is passed to ``plan_spgemm``; a
``mesh`` (:class:`~repro_torch.core.mesh.Mesh`) routes every plan through
the distributed executors, and a request whose wave lost a shard ends
DEGRADED with the recovery ledger attached.  On a CUDA plan admission
reserves the larger of JAX's estimate and the port's price of its real
device allocation (``admission.device_price``), so ``device_budget_bytes``
bounds the card's memory.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np

from repro_torch.core import faults as faults_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core import validate as validate_mod
from repro_torch.core.errors import (AdmissionRejectedError,
                                     CapacityExhaustedError,
                                     DeadlineExceededError, PlanMismatchError,
                                     ShardFailureError, SpgemmError)
from repro_torch.serve import admission, queueing


# --------------------------------------------------------------------------- #
# Request lifecycle
# --------------------------------------------------------------------------- #
class RequestState:
    SUBMITTED = "SUBMITTED"
    ADMITTED = "ADMITTED"      # holds a bounded queue slot
    PLANNED = "PLANNED"        # plan built, cost estimate priced
    EXECUTING = "EXECUTING"
    DONE = "DONE"              # clean result
    DEGRADED = "DEGRADED"      # correct result via exact fallback OR
                               # degraded-mesh recovery (ledger attached)
    SHED = "SHED"              # queue full at submit
    FAILED = "FAILED"          # typed SpgemmError attached
    EXPIRED = "EXPIRED"        # deadline passed

    TERMINAL = frozenset({DONE, DEGRADED, SHED, FAILED, EXPIRED})


@dataclasses.dataclass(eq=False)
class Request:
    """The ticket ``submit`` returns; terminal state carries the result OR a
    typed error — never neither, never both silently wrong."""

    id: int
    a: object
    b: object
    deadline: float | None              # absolute service-clock time
    state: str = RequestState.SUBMITTED
    result: object = None               # host CSR on DONE/DEGRADED
    error: SpgemmError | None = None    # typed, on SHED/FAILED/EXPIRED
    estimate: admission.CostEstimate | None = None
    plan: object = None
    retry_policy: object = None         # escalated after 1st capacity failure
    attempts: int = 0
    submitted_at: float = 0.0
    finished_at: float | None = None
    history: list = dataclasses.field(default_factory=list)
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> bool:
        return self.state in RequestState.TERMINAL

    @property
    def latency(self) -> float | None:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def result_or_raise(self):
        """The service never raises mid-loop; callers collect here."""
        if not self.done:
            raise PlanMismatchError(
                f"request {self.id} is not terminal (state {self.state})",
                request=self.id)
        if self.error is not None:
            raise self.error
        return self.result


# --------------------------------------------------------------------------- #
# Per-template circuit breaker
# --------------------------------------------------------------------------- #
class CircuitBreaker:
    """CLOSED → (``threshold`` consecutive ShardFailureError) → OPEN →
    (``cooldown`` seconds) → HALF_OPEN probe → CLOSED on success, OPEN on
    failure.  One breaker per template: a family whose executor keeps dying
    fails fast instead of burning the queue, without touching other
    families' traffic."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: int, cooldown: float) -> None:
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at: float | None = None
        self.last_error: SpgemmError | None = None
        self.trips = 0
        # observability ledger: every edge of the state machine is counted
        # and every state's occupancy is clocked, so the chaos soak can
        # gate on breaker BEHAVIOR — "tripped twice,
        # spent 11s open" — not just its final state
        self.transitions: dict = {}
        self.time_in_state = {self.CLOSED: 0.0, self.OPEN: 0.0,
                              self.HALF_OPEN: 0.0}
        self._state_since: float | None = None

    def _transition(self, new_state: str, now: float | None) -> None:
        if new_state == self.state:
            return
        if now is not None:
            if self._state_since is not None:
                self.time_in_state[self.state] += max(
                    0.0, now - self._state_since)
            self._state_since = now
        edge = f"{self.state}->{new_state}"
        self.transitions[edge] = self.transitions.get(edge, 0) + 1
        self.state = new_state

    def allow(self, now: float) -> bool:
        if self.state == self.OPEN:
            if now - self.opened_at >= self.cooldown:
                self._transition(self.HALF_OPEN, now)   # admit ONE probe
                return True
            return False
        return True

    def record_success(self, now: float | None = None) -> None:
        self._transition(self.CLOSED, now)
        self.failures = 0
        self.last_error = None

    def record_failure(self, now: float, err: SpgemmError) -> None:
        self.failures += 1
        self.last_error = err
        if self.state == self.HALF_OPEN or self.failures >= self.threshold:
            self._transition(self.OPEN, now)
            self.opened_at = now
            self.trips += 1

    def record_expired_probe(self, now: float | None = None) -> None:
        """A HALF_OPEN probe whose deadline passed before dispatch is a
        NEUTRAL outcome — the executor was never exercised, so it neither
        closes nor re-trips the breaker.  Return to OPEN keeping the
        original ``opened_at`` (the cooldown already elapsed, so the next
        pop is admitted as a fresh probe); without this the breaker sits in
        HALF_OPEN forever and every subsequent pop becomes an unmetered
        probe that bypasses the cooldown."""
        if self.state == self.HALF_OPEN:
            self._transition(self.OPEN, now)

    def stats(self) -> dict:
        return dict(state=self.state, failures=self.failures,
                    trips=self.trips,
                    transitions=dict(self.transitions),
                    time_in_state={k: round(v, 6)
                                   for k, v in self.time_in_state.items()})


# --------------------------------------------------------------------------- #
# Service configuration
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    queue_capacity: int = 64
    # admission reserves CostEstimate.reserve_bytes: on a CUDA plan the
    # larger of JAX's bucket-slot estimate and the port's device price
    device_budget_bytes: int = 256 << 20
    default_deadline: float | None = None   # seconds from submit
    max_batch: int = 8
    safety: float = 1.3
    seed: int = 0
    pop_quant: bool = True
    template: str | None = "auto"           # "auto" | None
    n_panels: int = 0
    use_kernel: bool = False
    validate: bool = True
    breaker_threshold: int = 3
    breaker_cooldown: float = 1.0
    # degraded-mesh knobs: a mesh (core.mesh.Mesh) routes plans through the
    # distributed executors (shard-loss recovery territory); a
    # DispatchBudget arms the straggler watchdog on every wave the service
    # issues
    mesh: object = None
    dispatch_budget: object = None
    # where plans run: None → the mesh's first device or the CUDA card,
    # "cpu" → the plain versions
    device: object = None
    # base policy keeps the ladder short and surfaces exhaustion as a typed
    # CapacityExhaustedError; the escalated policy (one requeue later) turns
    # on the exact-symbolic fallback — guaranteed termination, DEGRADED
    retry_policy: plan_mod.RetryPolicy = plan_mod.RetryPolicy(
        rounds=1, exact_fallback=False, on_exhausted="raise")
    escalated_policy: plan_mod.RetryPolicy = plan_mod.RetryPolicy(
        rounds=2, growth=2.0, exact_fallback=True, on_exhausted="raise")


class SpgemmService:
    """The scheduler.  Owns its own :class:`~repro_torch.core.plan.
    PlanCache` and :class:`~repro_torch.core.plan.TemplateRegistry` so one
    service's executors never alias another's (or the session globals')."""

    def __init__(self, config: ServiceConfig | None = None, *,
                 clock=time.monotonic,
                 cache: plan_mod.PlanCache | None = None,
                 registry: plan_mod.TemplateRegistry | None = None) -> None:
        self.config = config if config is not None else ServiceConfig()
        self._clock = clock
        self._cache = cache if cache is not None else plan_mod.PlanCache()
        self._registry = (registry if registry is not None
                          else plan_mod.TemplateRegistry())
        self._queue = queueing.BoundedQueue(self.config.queue_capacity)
        self._budget = admission.MemoryBudget(self.config.device_budget_bytes)
        self._breakers: dict = {}
        self._ids = itertools.count()
        self.requests: list[Request] = []      # every ticket ever submitted
        self._counts = {s: 0 for s in RequestState.TERMINAL}
        self._requeues = 0
        self._waves = 0
        self._batched = 0

    # ---------------------------------------------------------------- state
    def _set_state(self, req: Request, state: str, now: float) -> None:
        req.state = state
        req.history.append((state, now))

    def _finish(self, req: Request, state: str, *,
                error: SpgemmError | None = None, result=None) -> None:
        now = self._clock()
        req.error = error
        req.result = result
        req.finished_at = now
        self._set_state(req, state, now)
        self._counts[state] += 1
        if req.plan is not None:
            # the degradation ledger + retry trail flow into the response
            # whether the request succeeded, degraded, or failed
            req.stats.setdefault("degradations",
                                 [dict(e) for e in req.plan.degradations])
            req.stats.setdefault("recoveries",
                                 [dict(e) for e in req.plan.recoveries])
            req.stats.setdefault("retries", int(req.plan.retries))
            # the reservation is released at terminal, so is the device
            # memory the plan still caches (its record stays)
            req.plan.release_device()
        if req.estimate is not None:
            req.stats.setdefault("estimate", req.estimate.stats())

    # --------------------------------------------------------------- submit
    def submit(self, a, b, *, deadline: float | None = None) -> Request:
        """Admit one request; never raises — the returned ticket is either
        queued (ADMITTED) or already terminal (SHED / FAILED)."""
        now = self._clock()
        rel = deadline if deadline is not None else self.config.default_deadline
        req = Request(id=next(self._ids), a=a, b=b,
                      deadline=(now + rel) if rel is not None else None,
                      submitted_at=now)
        req.history.append((RequestState.SUBMITTED, now))
        self.requests.append(req)
        if rel is not None and rel <= 0:
            # a non-positive deadline can never be met — reject at the
            # front door instead of spending a queue slot on a request
            # whose only possible terminal state is EXPIRED
            self._finish(req, RequestState.FAILED,
                         error=AdmissionRejectedError(
                             f"request {req.id} submitted with non-positive "
                             f"deadline {rel}", reason="nonpositive_deadline",
                             request=req.id, observed=float(rel)))
            return req
        if self.config.validate:
            # malformed operands are contained at the front door — a NaN
            # smuggled into values never reaches planning or the queue
            try:
                validate_mod.validate_pair(a, b)
            except SpgemmError as e:
                self._finish(req, RequestState.FAILED, error=e)
                return req
        try:
            self._queue.push(req)
        except AdmissionRejectedError as e:
            self._finish(req, RequestState.SHED, error=e)
            return req
        self._set_state(req, RequestState.ADMITTED, now)
        return req

    # ----------------------------------------------------------------- plan
    def _ensure_planned(self, req: Request, now: float) -> bool:
        if req.plan is not None:
            return True
        try:
            req.plan = plan_mod.plan_spgemm(
                req.a, req.b, safety=self.config.safety,
                seed=self.config.seed, pop_quant=self.config.pop_quant,
                template=self.config.template, registry=self._registry,
                n_panels=self.config.n_panels,
                use_kernel=self.config.use_kernel,
                retry_policy=(req.retry_policy if req.retry_policy is not None
                              else self.config.retry_policy),
                mesh=self.config.mesh,
                dispatch_budget=self.config.dispatch_budget,
                device=self.config.device,
                validate=False)            # validated at submit
        except SpgemmError as e:
            self._finish(req, RequestState.FAILED, error=e)
            return False
        req.estimate = admission.estimate_cost(req.plan)
        if not admission.deadline_feasible(req.estimate, req.deadline, now):
            # priced-out: the estimate alone exceeds the time remaining,
            # so dispatching could only produce a result past its deadline
            self._finish(req, RequestState.FAILED,
                         error=AdmissionRejectedError(
                             f"request {req.id} cannot meet its deadline: "
                             f"estimated {req.estimate.est_seconds:.6f}s "
                             f"exceeds the {max(0.0, req.deadline - now):.6f}s "
                             "remaining", reason="deadline_unreachable",
                             request=req.id,
                             observed=float(req.estimate.est_seconds),
                             planned=round(max(0.0, req.deadline - now), 6)))
            return False
        self._set_state(req, RequestState.PLANNED, now)
        return True

    def _breaker_for(self, req: Request) -> CircuitBreaker:
        tpl = getattr(req.plan, "_template", None)
        key = tpl if tpl is not None else req.plan.key
        if key not in self._breakers:
            self._breakers[key] = CircuitBreaker(
                self.config.breaker_threshold, self.config.breaker_cooldown)
        return self._breakers[key]

    # ----------------------------------------------------------------- step
    def _expire_queued(self, now: float) -> list[Request]:
        out = []
        for req in self._queue.expire(now):
            waited = now - req.submitted_at
            self._finish(req, RequestState.EXPIRED,
                         error=DeadlineExceededError(
                             f"request {req.id} deadline passed after "
                             f"{waited:.3f}s in queue", request=req.id,
                             deadline=req.deadline, observed=round(waited, 6)))
            out.append(req)
        return out

    def _gather_batch(self, head: Request, now: float,
                      finished: list[Request]) -> list[Request]:
        """Same-plan-key mates of ``head`` ride the same dispatch wave —
        one cached executor serves the whole batch with no build.
        The memory budget bounds the wave (backpressure: non-fitting mates
        simply stay queued); non-matching requests keep their queue order."""
        batch = [head]
        self._budget.reserve(head.estimate)
        keep = []
        # stop scanning the moment the wave is full — the old form kept
        # popping (and restoring) the ENTIRE queue after max_batch, turning
        # every wave into an O(queue) scan for zero extra batching
        while len(self._queue) and len(batch) < self.config.max_batch:
            cand = self._queue.pop()
            if (cand.a.shape != head.a.shape
                    or cand.b.shape != head.b.shape):
                keep.append(cand)
                continue
            if not self._ensure_planned(cand, now):
                finished.append(cand)          # typed plan-time failure
                continue
            if (cand.plan.key != head.plan.key
                    or not self._budget.fits_now(cand.estimate)):
                keep.append(cand)
                continue
            self._budget.reserve(cand.estimate)
            batch.append(cand)
        # passed-over mates go back to the FRONT: they were popped from
        # ahead of everything still queued, so a tail restore would rotate
        # the queue whenever the scan stops early.  They hold no
        # reservation, so they hold no device memory either (their plans
        # upload again when they run)
        for cand in keep:
            if cand.plan is not None:
                cand.plan.release_device()
        self._queue.restore_front(keep)
        return batch

    def _execute_one(self, req: Request, breaker: CircuitBreaker) -> None:
        now = self._clock()
        if req.deadline is not None and req.deadline <= now:
            # a probe that expires before dispatch must hand its HALF_OPEN
            # slot back (neutral outcome) or the breaker is stuck half-open
            breaker.record_expired_probe(now)
            self._finish(req, RequestState.EXPIRED,
                         error=DeadlineExceededError(
                             f"request {req.id} deadline passed before "
                             "dispatch", request=req.id,
                             deadline=req.deadline))
            return
        self._set_state(req, RequestState.EXECUTING, now)
        try:
            out = plan_mod.execute(req.plan, req.a, req.b, cache=self._cache)
            c = plan_mod.reassemble(req.plan, out)
        except CapacityExhaustedError as e:
            if req.attempts == 0:
                # one requeue at the escalated policy (exact fallback on):
                # the retry is re-planned from scratch so the escalation is
                # visible in the plan's own ledger
                req.attempts = 1
                req.retry_policy = self.config.escalated_policy
                req.stats["first_error"] = str(e)
                req.plan = None
                req.estimate = None
                self._requeues += 1
                self._set_state(req, RequestState.ADMITTED, self._clock())
                self._queue.push_front(req)
            else:
                self._finish(req, RequestState.FAILED, error=e)
            return
        except ShardFailureError as e:
            breaker.record_failure(self._clock(), e)
            self._finish(req, RequestState.FAILED, error=e)
            return
        except SpgemmError as e:
            self._finish(req, RequestState.FAILED, error=e)
            return
        # a RECOVERED request is a success to the breaker — its executor
        # family produced a correct result; only unrecovered failures (the
        # typed raises above) count toward tripping
        breaker.record_success(now)
        degraded = bool(req.plan.degradations) or bool(req.plan.recoveries)
        self._finish(req,
                     RequestState.DEGRADED if degraded else RequestState.DONE,
                     result=c)

    def step(self) -> list[Request]:
        """One scheduling wave: expire, pop, plan, admit, batch, execute.
        Returns the requests that reached a terminal state this wave."""
        now = self._clock()
        finished = self._expire_queued(now)
        # shortest-deadline-first: the most urgent live request heads the
        # wave (its same-template mates still batch behind it)
        self._queue.promote_earliest()
        head = self._queue.pop()
        if head is None:
            return finished
        if not self._ensure_planned(head, now):
            finished.append(head)
            return finished
        if not self._budget.fits_ever(head.estimate):
            # can NEVER be scheduled — terminal now, not an infinite requeue
            self._finish(head, RequestState.FAILED,
                         error=AdmissionRejectedError(
                             f"request {head.id} estimate "
                             f"{head.estimate.reserve_bytes} bytes exceeds "
                             f"the device budget {self._budget.total}",
                             reason="over_budget", request=head.id,
                             observed=int(head.estimate.reserve_bytes),
                             planned=int(self._budget.total)))
            finished.append(head)
            return finished
        breaker = self._breaker_for(head)
        if not breaker.allow(now):
            err = AdmissionRejectedError(
                f"circuit open for request {head.id}'s template "
                f"({breaker.failures} consecutive executor failures)",
                reason="circuit_open", request=head.id,
                observed=breaker.failures, planned=self.config.breaker_threshold)
            err.__cause__ = breaker.last_error
            self._finish(head, RequestState.FAILED, error=err)
            finished.append(head)
            return finished
        if breaker.state == CircuitBreaker.HALF_OPEN:
            batch = [head]                     # the probe rides alone
            self._budget.reserve(head.estimate)
        else:
            batch = self._gather_batch(head, now, finished)
        self._waves += 1
        self._batched += len(batch)
        for req in batch:
            est = req.estimate          # snapshot: the requeue path re-prices
            try:
                self._execute_one(req, breaker)
            finally:
                self._budget.release(est)
            if req.done:
                finished.append(req)
        return finished

    def drain(self, max_waves: int | None = None) -> list[Request]:
        """Run waves until the queue is empty.  Termination is structural —
        every pop either finishes or consumes the request's single escalated
        requeue — but a hard wave cap backstops 'no path hangs': exceeding
        it is a scheduler bug surfaced as a typed error, not a livelock."""
        if max_waves is None:
            max_waves = 4 * len(self.requests) + 16
        finished = []
        for _ in range(max_waves):
            if not len(self._queue):
                break
            finished.extend(self.step())
        if len(self._queue):
            raise PlanMismatchError(
                f"drain did not converge in {max_waves} waves "
                f"({len(self._queue)} requests still queued)",
                observed=len(self._queue))
        return finished

    # ---------------------------------------------------------------- stats
    @staticmethod
    def _latency_stats(lats: list) -> dict:
        if not lats:
            return {}
        arr = np.asarray(lats, dtype=np.float64)
        return dict(
            mean_s=round(float(arr.mean()), 6),
            p50_s=round(float(np.percentile(arr, 50)), 6),
            p99_s=round(float(np.percentile(arr, 99)), 6),
            max_s=round(float(arr.max()), 6))

    def stats(self) -> dict:
        # service latency = time-to-RESULT.  SHED/EXPIRED/FAILED tickets
        # finish fast by design (typed rejection), so mixing them into the
        # percentiles drags p50/p99 DOWN under overload — the worse the
        # shedding, the better the number looked.  ``latency`` covers only
        # requests that produced a result (DONE/DEGRADED);
        # ``terminal_latency`` keeps the everything-terminal view for
        # rejection-path triage.
        served = (RequestState.DONE, RequestState.DEGRADED)
        lat_served = [r.latency for r in self.requests
                      if r.state in served and r.latency is not None]
        lat_terminal = [r.latency for r in self.requests
                        if r.latency is not None]
        return dict(
            submitted=len(self.requests),
            terminal={s: self._counts[s]
                      for s in sorted(RequestState.TERMINAL)},
            in_flight=len(self.requests) - sum(self._counts.values()),
            requeues=self._requeues,
            waves=self._waves,
            batched_requests=self._batched,
            faults_armed=faults_mod.armed(),
            queue=self._queue.stats(),
            budget=self._budget.stats(),
            breakers=[b.stats() for b in self._breakers.values()],
            plan_cache=self._cache.stats(),
            templates=self._registry.stats(),
            latency=self._latency_stats(lat_served),
            terminal_latency=self._latency_stats(lat_terminal),
        )
