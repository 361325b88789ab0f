"""Typed SpGEMM error taxonomy (DESIGN.md §9), the part this port raises.

Every failure of the plan/execute pipeline raises a subclass of
:class:`SpgemmError` carrying a structured ``context`` (operand, field,
observed vs planned values), so a caller can route and log failures without
parsing message strings.  ``SpgemmError`` subclasses :class:`ValueError`, so
``except ValueError`` callers keep working.

Taxonomy::

    SpgemmError                  base; .context dict, JSON-serializable
    ├── OperandValidationError   malformed operand (CSR invariant broken)
    ├── PlanMismatchError        operand/route/option doesn't fit the plan
    └── CapacityExhaustedError   output slots exhausted (overflow)
"""
from __future__ import annotations


class SpgemmError(ValueError):
    """Base class: message plus a structured, JSON-serializable ``context``.

    ``context`` keys are free-form but the pipeline uses a stable
    vocabulary: ``plan_key``, ``operand``, ``field``, ``row``, ``index``,
    ``bucket``, ``observed``, ``planned``.
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
    """Output capacity was exhausted: a truncated result (``overflow`` > 0)
    reached ``reassemble``.  ``context`` carries the dropped-entry count."""
