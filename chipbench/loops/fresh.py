"""A new graph each call (graph analytics: two-hop neighbourhoods, Markov
clustering's expansion): sample, predict, plan, re-plan, multiply.

Call ``i`` makes one of ``members`` fixed structures on the card, under
labels of its own where ``relabel`` is on, with values from (seed, call
index), and hands it to the program as a host CSR with the paper's sample
rows.  The call is ``plan_spgemm`` → ``execute`` → the overflow read.  The
calls cycle through the members, each cycle in an order drawn from the
seed, so every seed does the same work in another order.  Set-up runs
``warm_calls`` such calls on labels and values that no window call draws.
A closed loop with one caller.
"""
from __future__ import annotations

import numpy as np

from chipbench import seeds
from chipbench import trace as tr
from chipbench.cell import host_csr, program, record_plan

KEYS = {"warm_calls": int, "members": int, "relabel": bool}
PLANS = True


def inputs(cell, i: int) -> tuple[int, int | None]:
    k = cell.mix["members"]
    order = np.random.default_rng(
        seeds.derive(cell.seed, "order", i // k)).permutation(k)
    return int(order[i % k]), (i if cell.mix["relabel"] else None)


class Loop:
    def __init__(self, cell):
        self.cell = cell
        self.host = self.rows = None
        with cell.step("warm"):
            for w in range(cell.mix["warm_calls"]):
                # the labels and values of no window call (indices below 0)
                self.make(-1 - w, inputs(cell, w)[0], inputs(cell, -1 - w)[1],
                          "warm-values")
                self.call(None, None)
            cell.sync()

    def make(self, i: int, member: int, labels, stream: str) -> None:
        cell = self.cell
        with tr.span("generate"):
            pat = cell.pattern(member, labels)
            self.host = host_csr(pat, cell.values(int(pat.col.shape[0]),
                                                  stream, i))
            self.rows = cell.sample_rows(member, pat)
            cell.sync()

    def prepare(self, i: int, rec) -> None:
        self.make(i, rec.member, rec.labels, "values")

    def call(self, i, rec):
        p, ms = self.cell.plan(self.host, self.rows)
        if rec is not None:
            record_plan(rec, p, ms, self.cell.trace)
        with tr.span("call"):
            out = program().execute(p, self.host, self.host)
            overflow = int(out.overflow)
        self.host = self.rows = None
        return p, out, overflow

    def release(self) -> None:
        self.host = self.rows = None
