"""The calls' roofline bound over the time the device was busy inside them
(%): how near the numeric kernels, together, come to the least time the
product's own work needs (``chipbench.work``)."""
from chipbench import trace as tr


def read(ctx):
    calls = tr.spans_named(ctx.trace, "call") if ctx.trace else []
    if not calls or len(calls) != len(ctx.call_bounds):
        return None
    busy = sum(tr.busy(ctx.trace, s, e) for s, e in calls)
    return 100.0 * sum(ctx.call_bounds) / busy if busy > 0 else None
