"""Median host time of ``plan_spgemm`` over the window's products (ms):
validation, bucketing, the host FLOP count, uploads, the predictor and the
capacities."""
import statistics


def read(ctx):
    return statistics.median(ctx.plan_ms) if ctx.plan_ms else None
