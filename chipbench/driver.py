"""One run of one cell: set-up, the measured window, then the check.

The traffic mix (``traffic/<mix>.json``) names its loop
(``chipbench/loops/<loop>.py``), which makes each call's inputs and calls
the program; the configuration (``configs/<config>.json``) names the
generator of its inputs.  This driver is the same for every cell: it times
the window, keeps what the check needs, and works out every metric that
the run's records allow (``run.py`` reports the cell's own).

A call's latency runs from its first call into the program to the read of
its overflow count, which waits for the device; making its inputs lies
outside that span.  After the window the outputs of the checked calls (one
drawn from the seed among the first ``check_first``, and the last) are
read back through ``reassemble``, the program's state is freed, and the
plain reference judges them.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from chipbench import check, loops, seeds, work
from chipbench import trace as tr
from chipbench.cell import Cell, Product, program, slots
from chipbench.reference import predict as ref_predict
from chipbench.reference import spgemm as ref


@dataclasses.dataclass
class Context:
    """What the layer metrics read (``chipbench.layer_metrics``)."""
    trace: tr.Trace | None = None
    call_bounds: list = dataclasses.field(default_factory=list)
    plan_ms: list = dataclasses.field(default_factory=list)
    replan: tuple | None = None


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, peak: dict | None = None,
        steps: dict | None = None) -> dict:
    """Set up, measure for ``seconds``, check; returns the run's readings:
    ``metrics`` (every end-to-end value this run measured), ``ctx`` (what
    the per-layer readers read), ``readings``, ``attempted``, ``failed``,
    ``memory_peak``, ``setup_steps`` (host seconds of each set-up step,
    ``steps`` first) and ``notes`` (lines for standard error)."""
    plan_mod = program()
    kind = loops.load(mix)
    cell = Cell(cfg, mix, seed, device, trace)
    dev = cell.dev
    cell.steps.update(steps or {})

    # ---- set-up: the device, the cell's inputs and warm calls ----
    if dev.type == "cuda":
        with cell.step("context"):
            torch.empty(1, device=dev)
            torch.cuda.reset_peak_memory_stats(dev)
    loop = kind.Loop(cell)
    cell.sync()

    # ---- the window ----
    rng = np.random.default_rng(seeds.derive(seed, "check"))
    pick = int(rng.integers(0, int(mix["check_first"])))
    products: list[Product] = []
    kept: dict = {}
    failed = overflow_calls = 0
    latencies = []
    ctx = Context()
    setup_s = time.perf_counter() - t_start
    with tr.traced(trace) as holder:
        t0 = time.perf_counter()
        t_end = t0 + seconds
        i = 0
        while True:
            rec = Product(*kind.inputs(cell, i))
            try:
                loop.prepare(i, rec)
                c0 = time.perf_counter()
                p, out, overflow = loop.call(i, rec)
                rec.call_ms = 1e3 * (time.perf_counter() - c0)
                rec.slots = slots(p)
            except Exception as e:          # a failed call counts, and the
                failed += 1                 # run goes on to the next one
                print(f"call {i} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
                out = p = None
                overflow = 0
            overflow_calls += overflow != 0
            if out is not None:
                latencies.append(rec.call_ms)
            products.append(rec)
            done = time.perf_counter() >= t_end
            if out is not None and (i == pick or done):
                kept[i] = (p, out)
            del out, p
            i += 1
            if done:
                break
        window_s = time.perf_counter() - t0
    ctx.trace = holder.trace
    n_calls = len(products)

    # ---- after the window: the peak, the outputs read back, state freed ----
    cell.sync()
    memory_peak = (int(torch.cuda.max_memory_allocated(dev))
                   if dev.type == "cuda" else 0)
    port = {}
    for i in sorted(kept):
        p, out = kept.pop(i)
        try:
            port[i] = plan_mod.reassemble(p, out, on_overflow="ignore")
        except Exception as e:
            print(f"reassemble {i} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
        del p, out
    loop.release()
    del loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference: checked products, exact counts, predictions ----
    readings = check.Readings(overflow_calls=overflow_calls)
    sizes: dict = {}          # member -> (rows, nnz(A), products, nnz(C))

    def size_of(member, a, nnz_c=None):
        if member not in sizes:
            if nnz_c is None:
                nnz_c = int(ref.exact_row_counts(a, a).sum())
            sizes[member] = (a.nrows, int(a.col.shape[0]),
                             int(ref.row_products(a, a).sum()), nnz_c)
        return sizes[member]

    for i, csr in port.items():
        rec = products[i]
        a, _ = cell.operand(i, rec.member, rec.labels)
        nnz_c = check.compare(check.port_blocks(csr, dev), a, a, readings)
        size_of(rec.member, a, nnz_c)
    readings.checked = len(port)
    if n_calls and len(port) < len({min(pick, n_calls - 1), n_calls - 1}):
        failed += 1                        # a kept output never came back

    replan = [0, 0]
    for i, rec in enumerate(products):
        if rec.structure is None:      # not planned in the window, or failed
            continue
        a, pat = cell.operand(i, rec.member, rec.labels)
        rows = cell.sample_rows(rec.member, pat)
        rowprod = ref.row_products(a, a)
        z_star = int(ref.exact_row_counts(ref.take_rows(a, rows), a).sum())
        f_star = int(rowprod[torch.as_tensor(rows, device=dev)].sum())
        want, _ = ref_predict.eq4(rowprod, z_star, f_star)
        check.prediction_gap(rec.structure, want.cpu().numpy(), readings)
        size_of(rec.member, a)
        if rec.first_caps is not None:
            row_bucket, caps, edges = rec.first_caps
            exact = ref.exact_row_counts(a, a, edges).cpu().numpy()
            if exact.ndim == 1:
                exact = exact[:, None]
            replan[0] += int((exact > caps[row_bucket]).any(axis=1).sum())
            replan[1] += exact.shape[0]
    ok = [r for r in products if r.slots]
    for rec in ok:
        if rec.member not in sizes:
            size_of(rec.member, cell.operand(0, rec.member, rec.labels)[0])

    # ---- metrics ----
    metrics = dict(setup_s=setup_s)
    notes = []
    if ok:
        metrics["gprod_per_s"] = sum(sizes[r.member][2] for r in ok
                                     ) / window_s / 1e9
        metrics["out_alloc_x"] = (sum(r.slots for r in ok)
                                  / sum(sizes[r.member][3] for r in ok))
        if peak is not None:
            ctx.call_bounds = [work.bound_seconds(work.product_work(
                m, m, nnz, nnz, prods, nnz_c), peak)[0]
                for m, nnz, prods, nnz_c in (sizes[r.member] for r in ok)]
    if latencies:
        metrics["p95_ms"] = float(np.percentile(latencies, 95))
    planned = [r for r in products if r.structure is not None]
    if planned:
        errs = {}
        for r in planned:
            exact = sizes[r.member][3]
            errs.setdefault(r.member, []).append(
                abs(r.predicted_nnz - exact) / exact)
        metrics["nnz_err_pct"] = 100.0 * float(np.mean(
            [e for es in errs.values() for e in es]))
        notes += [f"member {k}: {len(es)} products, nnz error "
                  f"{100.0 * float(np.mean(es))!r} %"
                  for k, es in sorted(errs.items())]
    ctx.plan_ms = [r.plan_ms for r in products if r.plan_ms]
    if trace and replan[1]:
        ctx.replan = tuple(replan)
    return dict(metrics=metrics, ctx=ctx, readings=readings,
                attempted=n_calls, failed=failed, window_s=window_s,
                memory_peak=memory_peak, notes=notes,
                setup_steps=dict(cell.steps, total=setup_s))
