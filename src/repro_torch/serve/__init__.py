# Serving layer: the SpGEMM request scheduler (DESIGN.md §10) on one device.
# Lazy imports keep `from repro_torch.serve import queueing` from loading
# the planner.


def __getattr__(name):
    if name in ("SpgemmService", "ServiceConfig", "Request", "RequestState",
                "CircuitBreaker"):
        from . import spgemm_service as _svc
        return getattr(_svc, name)
    if name in ("CostEstimate", "MemoryBudget", "estimate", "estimate_cost",
                "planned_bytes", "capacity_bound_rows"):
        from . import admission as _adm
        return getattr(_adm, name)
    if name == "BoundedQueue":
        from . import queueing as _q
        return _q.BoundedQueue
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
