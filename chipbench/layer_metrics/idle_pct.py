"""Share of the traced window in which no kernel, copy or fill ran on the
device (%)."""
from chipbench import trace as tr


def read(ctx):
    if not ctx.trace or not ctx.trace.window or not ctx.trace.device_ops:
        return None
    lo, hi = ctx.trace.window
    return 100.0 * (1.0 - tr.busy(ctx.trace, lo, hi) / (hi - lo))
