"""Host time of a call that the device spent idle (ms, mean over the
window's calls): each of the program's ``execute`` spans less the device's
busy time inside it.  It reads the program's own spans, so it holds the
operand checks and uploads, the dispatch of the launches, the read-back
and re-planning, and nothing of the benchmark's."""
from chipbench import program_spans as ps


def read(ctx):
    spans = ps.load() if ctx.trace else None
    calls = ps.top(spans, "execute") if spans else []
    if not calls:
        return None
    idle = ps.idle_ms(ctx.trace, calls)
    return sum(idle) / len(idle)
