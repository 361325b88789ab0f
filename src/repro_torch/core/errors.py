"""Typed SpGEMM error taxonomy (DESIGN.md §9).

Every failure of the plan/execute pipeline raises a subclass of
:class:`SpgemmError` carrying a structured ``context`` (operand, field,
observed vs planned values), so a caller can route and log failures without
parsing message strings.  ``SpgemmError`` subclasses :class:`ValueError`, so
``except ValueError`` callers keep working.

Taxonomy::

    SpgemmError                  base; .context dict, JSON-serializable
    ├── OperandValidationError   malformed operand (CSR invariant broken)
    ├── PlanMismatchError        operand/route/option doesn't fit the plan
    ├── CapacityExhaustedError   output slots exhausted (overflow)
    ├── ShardFailureError        an execution unit (shard/panel/bucket) died
    │   └── StragglerError       a unit blew its priced dispatch budget
    ├── AdmissionRejectedError   serving front end refused/shed the request
    └── DeadlineExceededError    request deadline passed before completion

The last three are raised by parts of the JAX package the port does not
carry yet (the dispatch watchdog, the service); they are defined here so
the taxonomy is whole.
"""
from __future__ import annotations


class SpgemmError(ValueError):
    """Base class: message plus a structured, JSON-serializable ``context``.

    ``context`` keys are free-form but the pipeline uses a stable
    vocabulary: ``plan_key``, ``operand``, ``field``, ``row``, ``index``,
    ``bucket``/``buckets``, ``panel``, ``shard``/``shards``, ``unit``,
    ``observed``, ``planned``.
    """

    def __init__(self, message: str, **context):
        self.context = {k: v for k, v in context.items() if v is not None}
        super().__init__(message)

    def __str__(self) -> str:
        base = super().__str__()
        if not self.context:
            return base
        ctx = ", ".join(f"{k}={v!r}" for k, v in sorted(self.context.items()))
        return f"{base} [{ctx}]"


class OperandValidationError(SpgemmError):
    """An operand violates a CSR invariant (``core.validate.validate_csr``):
    non-monotone/mis-sized ``rpt``, out-of-range or unsorted ``col``,
    non-finite ``val``, or a broken dtype contract.  ``context`` pinpoints
    the field and the first offending row/entry."""


class PlanMismatchError(SpgemmError):
    """An operand, route or option does not match the plan it is used with:
    wrong shape/capacity/device at ``to_device``, an unknown accumulator
    route, or a route or planning option this port does not carry yet."""


class CapacityExhaustedError(SpgemmError):
    """Output capacity was exhausted and could not (or was not allowed to)
    be recovered: the retry ladder ran out with the exact-symbolic fallback
    off, a panel operand's capacity could not hold its entries, or a
    truncated result reached ``reassemble``.  ``context`` names the
    offending buckets/panels with observed need vs planned capacity."""


class ShardFailureError(SpgemmError):
    """One execution unit failed: a bucket or (bucket × panel) executor
    raised mid-flight (a kernel that did not launch, an injected fault).
    ``context`` names the unit (``unit``/``bucket``/``panel``, and
    ``shard`` on distributed plans) and chains the original failure as
    ``__cause__``."""


class StragglerError(ShardFailureError):
    """An execution unit exceeded its dispatch budget (the priced per-unit
    seconds of the JAX package's ``DispatchBudget``).  A straggler is
    treated exactly like a dead unit, so it subclasses
    :class:`ShardFailureError`.  ``context`` carries the unit info plus
    ``observed`` (elapsed seconds) and ``planned`` (the budget)."""


class AdmissionRejectedError(SpgemmError):
    """A serving front end refused a request instead of letting it hang or
    starve the fleet: the bounded queue was full, the request's cost
    estimate exceeds the whole device budget, or a circuit breaker is open
    for its template.  ``context`` carries ``request``, the decision
    (``reason``) and the observed vs planned quantity."""


class DeadlineExceededError(SpgemmError):
    """A request's deadline passed before it reached execution or before
    its result was produced.  ``context`` carries ``request``,
    ``deadline`` and ``waited`` (seconds on the service clock)."""
