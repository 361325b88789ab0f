"""Device time of the predictor a plan (ms, mean over the window's
plans): the operations that started inside the program's
``plan.predict`` spans (the sample's and FLOP table's uploads, the
predictor's kernels, the structure's read-back, which waits for them),
found by the span and not by the kernels' names."""
from chipbench import program_spans as ps


def read(ctx):
    spans = ps.load() if ctx.trace else None
    if not spans:
        return None
    plans = {i for i, s in enumerate(spans)
             if s[0] == "plan" and s[3] == -1 and s[2] is not None}
    predicts = [(ps.root_of(spans, i), s[1], s[2])
                for i, s in enumerate(spans)
                if s[0] == "plan.predict" and s[2] is not None]
    if not plans or not predicts:
        return None
    dev = sum(e - s for _, s, e in ps.ops_starting_in(
        ctx.trace, [(s, e) for r, s, e in predicts if r in plans]))
    return 1e3 * dev / len(plans)
