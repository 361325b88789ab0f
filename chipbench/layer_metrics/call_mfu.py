"""The calls' roofline bound over their wall time (%): the whole call's
share of the device's peak, host dispatch and idle time included.  It
bounds any kernel's gain: a kernel taken off the path leaves it standing."""
from chipbench import trace as tr


def read(ctx):
    calls = tr.spans_named(ctx.trace, "call") if ctx.trace else []
    if not calls or len(calls) != len(ctx.call_bounds):
        return None
    wall = sum(e - s for s, e in calls)
    return 100.0 * sum(ctx.call_bounds) / wall if wall > 0 else None
