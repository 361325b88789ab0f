"""Device kernels, copies and fills a call of the window issued (mean over
the traced calls): the host dispatch layer's count of work it hands the
card."""
from chipbench import trace as tr


def read(ctx):
    calls = tr.spans_named(ctx.trace, "call") if ctx.trace else []
    if not calls or not ctx.trace.device_ops:
        return None
    return sum(len(tr.ops_within(ctx.trace, s, e)) for s, e in calls) / len(
        calls)
