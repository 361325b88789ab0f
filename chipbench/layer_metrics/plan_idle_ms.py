"""Host time of a plan that the device spent idle (ms, median over the
window's plans): each of the program's outermost ``plan`` spans less the
device's busy time inside it."""
import statistics

from chipbench import program_spans as ps


def read(ctx):
    spans = ps.load() if ctx.trace else None
    plans = ps.top(spans, "plan") if spans else []
    return statistics.median(ps.idle_ms(ctx.trace, plans)) if plans else None
