"""The paper's system on PyTorch: planner, predictors, executors.

The unified planner/executor surface (DESIGN.md §6) is re-exported lazily,
so ``from repro_torch.core import oracle`` does not import the planner.
"""

_PLAN_EXPORTS = ("plan_spgemm", "execute", "reassemble", "plan_cache",
                 "SpgemmPlan", "PlanCache", "DistSpgemmOut", "PlanTemplate",
                 "TemplateRegistry", "template_registry", "RetryPolicy")


def __getattr__(name):
    if name in _PLAN_EXPORTS:
        from . import plan as _plan
        return getattr(_plan, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
