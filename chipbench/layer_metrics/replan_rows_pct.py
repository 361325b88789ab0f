"""Rows whose exact output count (the reference's) passes the capacity
that the plan first gave their unit, per 100 rows, over the window's
products: the share of rows that re-planning has to rescue."""


def read(ctx):
    if not ctx.replan or not ctx.replan[1]:
        return None
    return 100.0 * ctx.replan[0] / ctx.replan[1]
