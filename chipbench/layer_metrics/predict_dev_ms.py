"""Device time of the predictor's kernels a product (ms, mean over the
window's plans): the launches of kernels 1, 2 and 4 (``flop_rows.cu``,
``esc_symbolic.cu``, ``bitmask_symbolic.cu``) that start inside the
benchmark's span around ``plan_spgemm``, found by their CUDA names."""
from chipbench import trace as tr

KERNELS = ("flop_rows_kernel", "flop_all_rows_kernel", "esc_symbolic_kernel",
           "bitmask_symbolic_kernel")


def read(ctx):
    plans = tr.spans_named(ctx.trace, "plan") if ctx.trace else []
    per = []
    for s, e in plans:
        ops = [o for o in tr.ops_within(ctx.trace, s, e)
               if any(k in o[0] for k in KERNELS)]
        per.append(sum(oe - os for _, os, oe in ops))
    if not plans or not any(per):
        return None
    return 1e3 * sum(per) / len(per)
