"""Rows that re-planning re-ran, per 100 rows planned (%): the program's
counters ``replan.rows`` (the rows of each unit re-run, once a re-run:
a unit re-run in two rounds, or in each of its panels, counts each time)
over ``plan.rows``, read at the end of the run, so over its plans: the
window's and the set-up's warm calls."""
from chipbench import program_spans as ps


def read(ctx):
    c = ps.counters()
    if not c or not c.get("plan.rows"):
        return None
    return 100.0 * c.get("replan.rows", 0) / c["plan.rows"]
