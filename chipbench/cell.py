"""A cell's inputs, and the benchmark's calls into the program's planner.

:class:`Cell` holds one run's configuration (``configs/<config>.json``),
traffic mix (``traffic/<mix>.json``) and seed, and makes every input from
them: the sparsity pattern of one of the configuration's structure members
under a call's labels (the configuration's generator), each call's values,
the paper's sample rows.  A configuration key that nothing here or in its
generator reads is refused, so a file cannot ask for what the benchmark
does not run.  The helpers below are the only places that call
``plan_spgemm`` or read a plan's fields.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from chipbench import seeds
from chipbench import trace as tr
from chipbench.generators import find as find_generator
from chipbench.reference import predict as ref_predict
from chipbench.reference import spgemm as ref

# read here, or left to the reader (``described_as``, ``published``,
# ``reduced``, ``assumed``, ``closed_forms``: text and checked sizes)
CONFIG_KEYS = {"name", "source", "generator", "dtype", "structure_seed",
               "plan"}
CONFIG_NOTES = {"described_as", "published", "reduced", "assumed",
                "closed_forms"}


@dataclasses.dataclass
class Product:
    """One call of the window, as the check needs it again."""
    member: int
    labels: int | None = None
    plan_ms: float = 0.0
    call_ms: float = 0.0
    predicted_nnz: float = 0.0
    structure: np.ndarray | None = None
    slots: int = 0
    first_caps: tuple | None = None


def program():
    """The program's planner module (imported once a run has a device)."""
    from repro_torch.core import plan
    return plan


class Cell:
    """A run's inputs and the program's plan options, from its files."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 trace: bool = False):
        self.gen = find_generator(cfg["generator"])
        want = CONFIG_KEYS | set(self.gen.KEYS)
        extra, missing = set(cfg) - want - CONFIG_NOTES, want - set(cfg)
        if extra or missing:
            raise ValueError(f"configuration {cfg.get('name')!r}: keys "
                             f"{sorted(extra)} are not read, {sorted(missing)}"
                             " are missing")
        if cfg["dtype"] != "float32":
            raise ValueError(f"dtype {cfg['dtype']!r}: the benchmark draws "
                             "float32 values only")
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.dev = torch.device(device)
        self.trace = bool(trace)
        opts = dict(cfg["plan"])
        opts["use_kernel"] = bool(opts.get("use_kernel")) and \
            self.dev.type == "cuda"
        self.plan_opts = opts
        self.steps: dict = {}

    @contextlib.contextmanager
    def step(self, name: str):
        """Adds the host seconds of the body to set-up step ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.steps[name] = self.steps.get(name, 0.0) + (
                time.perf_counter() - t0)

    def pattern(self, member: int, labels_index: int | None):
        return self.gen.make(self.cfg, self.seed, self.dev, member,
                             labels_index)

    def values(self, nnz: int, stream: str, index: int) -> torch.Tensor:
        """Uniform float32 values in [-1, 1) of call ``index``."""
        g = seeds.generator(self.dev, seeds.derive(self.seed, stream, index))
        return torch.empty(nnz, dtype=torch.float32, device=self.dev
                           ).uniform_(-1.0, 1.0, generator=g)

    def operand(self, i: int, member: int, labels_index: int | None):
        """The reference's A (= B) of call ``i``: ``(Matrix, pattern)``."""
        pat = self.pattern(member, labels_index)
        val = self.values(int(pat.col.shape[0]), "values", i)
        return ref.Matrix(pat.rpt, pat.col.to(torch.int64), val,
                          int(pat.rpt.shape[0] - 1)), pat

    def sample_rows(self, member: int, pat) -> np.ndarray:
        """The paper's sample of ``member``, drawn in its own labels and
        carried through the call's label permutation."""
        m = pat.rpt.shape[0] - 1
        rows = ref_predict.sample_rows(m, seeds.derive(
            int(self.cfg["structure_seed"]), "sample", member))
        if pat.perm is not None:
            rows = pat.perm.cpu().numpy()[rows]
        return rows.astype(np.int64)

    def plan(self, host, rows):
        """``plan_spgemm(host, host)`` with the paper's sample and a
        ``RetryPolicy()``, inside the span ``plan``; ``(plan, host ms)``."""
        plan_mod = program()
        t0 = time.perf_counter()
        with tr.span("plan"):
            p = plan_mod.plan_spgemm(host, host, sample_rows=rows,
                                     retry_policy=plan_mod.RetryPolicy(),
                                     device=self.dev, **self.plan_opts)
        return p, 1e3 * (time.perf_counter() - t0)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


def host_csr(pat, val: torch.Tensor):
    """The program's host CSR of ``pat`` with values ``val``."""
    from repro_torch.sparse.formats import CSR
    m = pat.rpt.shape[0] - 1
    return CSR(rpt=pat.rpt.cpu().numpy().astype(np.int64),
               col=pat.col.cpu().numpy().astype(np.int32),
               val=val.cpu().numpy().astype(np.float32), shape=(m, m))


def record_plan(rec: Product, plan, plan_ms: float, trace: bool) -> None:
    """What the check and the layer metrics read of a plan made in the
    window: its prediction, and its first capacities where traced."""
    rec.plan_ms = plan_ms
    rec.predicted_nnz = float(plan.predicted_nnz)
    rec.structure = np.asarray(plan.structure, dtype=np.float64)
    if trace:
        rec.first_caps = first_caps(plan)


def slots(plan) -> int:
    """Output slots the plan reserves for C: the panel blocks, or the
    ``(M, row_capacity)`` buffer that a whole-B execute assembles into."""
    if plan.n_panels:
        return int(sum(bk.n_rows * int(plan.panel_caps[i].sum())
                       for i, bk in enumerate(plan.binning.buckets)))
    return int(plan.shape_a[0]) * int(plan.alloc.row_capacity)


def first_caps(plan) -> tuple:
    """Each row's capacity per panel as planned, before any re-planning:
    ``(row_bucket, caps (buckets × panels), panel edges or None)``."""
    if plan.n_panels:
        return (plan.binning.row_bucket.copy(),
                np.asarray(plan.panel_caps, dtype=np.int64).copy(),
                np.asarray(plan.panels.edges, dtype=np.int64).copy())
    return (plan.binning.row_bucket.copy(),
            np.asarray(plan.alloc.bucket_capacities,
                       dtype=np.int64)[:, None], None)
