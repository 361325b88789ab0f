"""Numeric reuse: the structure stays, the values change (PETSc's
``MatMatMult`` with ``MAT_REUSE_MATRIX``; AMG re-set-up across time or
Newton steps).

Set-up plans structure member 0 once, under the run's labels, and runs
``warm_calls`` calls.  Each call of the window first draws new values of
A (= B) from (seed, call index) on the card, and in place in the planned
host CSR where a panel plan takes B on the host; then ``execute`` runs and
its overflow count is read.  A closed loop with one caller.
"""
from __future__ import annotations

import torch

from chipbench import trace as tr
from chipbench.cell import host_csr, program

KEYS = {"warm_calls": int}
PLANS = False


def inputs(cell, i: int) -> tuple[int, None]:
    return 0, None


class Loop:
    def __init__(self, cell):
        self.cell = cell
        with cell.step("inputs"):
            pat = cell.pattern(0, None)
            self.nnz = int(pat.col.shape[0])
            self.host = host_csr(pat, cell.values(self.nnz, "warm-values", 0))
            rows = cell.sample_rows(0, pat)
            del pat
            cell.sync()
        with cell.step("plan"):
            self.plan, _ = cell.plan(self.host, rows)
        with cell.step("upload"):
            self.a = self.plan.to_device(self.host, "a")
            cell.sync()
        self.b = self.host if self.plan.n_panels else self.a
        with cell.step("warm"):
            for w in range(cell.mix["warm_calls"]):
                self.revalue("warm-values", w + 1)
                self.call(None, None)
            cell.sync()

    def revalue(self, stream: str, i: int) -> None:
        with tr.span("values"):
            v = self.cell.values(self.nnz, stream, i)
            self.a.val[:self.nnz].copy_(v)
            if self.plan.n_panels:
                torch.from_numpy(self.host.val).copy_(v)
            self.cell.sync()

    def prepare(self, i: int, rec) -> None:
        self.revalue("values", i)

    def call(self, i, rec):
        with tr.span("call"):
            out = program().execute(self.plan, self.a, self.b)
            return self.plan, out, int(out.overflow)

    def release(self) -> None:
        del self.plan, self.a, self.b, self.host
