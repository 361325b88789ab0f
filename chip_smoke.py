#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc``, at first use), then

1. drives the main path through its two entry points, with every kernel's
   launch count set to 0 just before each call and read just after:
   (a) the paper's predictor, ``predictor.proposed_predict_binned(...,
       use_kernel=True)``, on five suite matrices squared;
   (b) ``plan.plan_spgemm(route="esc", use_kernel=True)`` → ``execute`` →
       ``reassemble`` on the same five and on two paper-scale analogues
       (SuiteSparse cant and webbase-1M sizes);
   (c) the same with the default ``route="auto"``, which puts the banded
       and FEM products on the SPA route and R-MAT's hub rows on BIN;
2. checks what came out: z*, f* and floprC against the plain versions on the
   card and the host oracles, ``row_nnz``/``col``/``val`` against the plain
   numeric phase of each bucket's route on the card and the exact
   structure; (c)'s plan, ``col``, ``row_nnz`` and ``overflow`` against
   (b)'s exactly (routes change no bucket, prediction or capacity); small
   products on every route against the dense oracle;
3. holds each kernel against its plain version at the path's bucket shapes
   (the bitmask symbolic kernel also against the ESC one on the same
   sampled rows) and times both, with CUDA events, beside the bound.

It prints one JSON object per phase, then the ``{"kernels": [...]}`` line,
the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without the last line.  It never falls back to the CPU: with
no CUDA device it exits 2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 off the tensor cores
VAL_RTOL = 1e-5                  # run sums are taken in another order
VAL_ATOL_REL = 1e-6              # × the row's largest |value|
TIMED_RUNS = 5
SAFETY = 1.3
PREDICT_MATRICES = ("er_120k_d3", "pl_100k_d4", "rmat_80k", "band_60k_d16",
                    "fem_30k_d48")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def analogues(sprand):
    """Paper Table II sizes, built with the suite's generators:
    cant (62,451 rows, ~4.0 M nonzeros, FEM band) and webbase-1M
    (1,000,005 rows, ~3.1 M nonzeros, power law).  The power-law
    generator truncates degrees, so a mean of 4 lands on ~3.1 M."""
    return (("cant_like", sprand.banded(62_451, 62_451, 100, 50, seed=602)),
            ("webbase_like", sprand.power_law(1_000_005, 1_000_005, 4, 1.4,
                                              seed=601)))


def cuda_ms(torch, fn, runs: int = TIMED_RUNS) -> float:
    """Median milliseconds of ``fn`` over ``runs`` timed runs after two
    warm-up runs, each bracketed by CUDA events."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def referenced(np, m, rows, deg_a):
    """B rows referenced by ``rows`` (reading ≤ ``deg_a`` entries per row),
    and the A entries read: what one kernel call over ``rows`` must touch."""
    starts = m.rpt[rows]
    deg = np.minimum(m.rpt[rows + 1] - starts, deg_a)
    idx = np.repeat(starts - np.cumsum(deg) + deg, deg) + np.arange(deg.sum())
    return np.unique(m.col[idx]), int(deg.sum())


def bytes_flop_rows(np, m, rows, deg_a) -> int:
    """rows + two row pointers + A's column ids + referenced B row lengths
    read, one int32 FLOP written per row."""
    ks, n_a = referenced(np, m, rows, deg_a)
    return 4 * rows.size + 8 * rows.size + 4 * n_a + 4 * ks.size + 4 * rows.size


def bytes_symbolic(np, m, rows, deg_a, deg_b) -> int:
    """As FLOP, plus each referenced B row's pointer and columns, and z per
    row written."""
    ks, n_a = referenced(np, m, rows, deg_a)
    b_cols = int(np.minimum(np.diff(m.rpt)[ks], deg_b).sum())
    return (12 * rows.size + 4 * n_a + 8 * ks.size + 4 * b_cols
            + 8 * rows.size)


def bytes_numeric(np, m, rows, deg_a, deg_b, cap) -> int:
    """rows + row pointers + A's entries (col, val) + referenced B rows
    (pointer, length, entries) read; the capacity slots (col, val) and the
    row nnz written."""
    ks, n_a = referenced(np, m, rows, deg_a)
    b_ent = int(np.minimum(np.diff(m.rpt)[ks], deg_b).sum())
    return (12 * rows.size + 8 * n_a + 8 * ks.size + 8 * b_ent
            + 8 * rows.size * cap + 4 * rows.size)


def numeric_ops(floprc, rows) -> int:
    """A multiply and an add per intermediate product of ``rows``."""
    return 2 * int(floprc[rows].sum())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.core import binning, csr, oracle, plan, predictor
    from repro_torch.core import flop as flop_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels import accumulator as acc_k
    from repro_torch.kernels import flop_per_row as flop_k
    from repro_torch.kernels import spgemm_numeric as num_k
    from repro_torch.kernels import spgemm_symbolic as sym_k
    from repro_torch.sparse import random as sprand
    from repro_torch.sparse import suite
    from repro_torch.sparse.formats import spgemm_dense_oracle

    # torch.sparse.mm (the numeric kernels' yardstick) warns that CSR
    # support is in beta
    warnings.filterwarnings("ignore", message="Sparse")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda))
    built = _build.build_all()
    emit(dict(phase="build", seconds=built["seconds"], built=built["built"]))

    t0 = time.perf_counter()
    mats = [(n, suite.get_matrix(n)) for n in PREDICT_MATRICES]
    mats += list(analogues(sprand))
    emit(dict(phase="matrices", seconds=time.perf_counter() - t0,
              shapes={n: [m.nrows, m.ncols, m.nnz] for n, m in mats}))
    kernels = (flop_k.flop_rows, sym_k.fused_flop_symbolic,
               num_k.spgemm_numeric, acc_k.fused_flop_symbolic_bitmask,
               acc_k.spa_numeric, acc_k.bin_numeric)
    names = [k.__name__ for k in kernels]
    launches = {path: dict.fromkeys(names, 0)
                for path in ("predict", "plan_esc", "plan_auto")}

    def drive(path, fn):
        """One call of a main path, every launch count set to 0 just before
        it and read just after: (its result, its counts)."""
        for k in kernels:
            k.launches = 0
        out = fn()
        counts = {k.__name__: k.launches for k in kernels}
        for k, n in counts.items():
            launches[path][k] += n
        return out, counts

    def vals_close(got, want):
        vmax = want.abs().amax(dim=1, keepdim=True)
        return not bool(((got - want).abs() > VAL_RTOL * want.abs()
                         + VAL_ATOL_REL * vmax).any())

    def numeric_plain(ad, bk, rows, cap):
        """The plain numeric phase of the bucket's route, on the card."""
        kw = dict(a=ad, b=ad, rows=rows, max_deg_a=bk.deg_a,
                  max_deg_b=bk.deg_b, row_capacity=cap)
        if bk.route == binning.ROUTE_SPA:
            return acc_k.spa_numeric_plain(**kw, tile_n=bk.tile_n,
                                           n_tiles=bk.n_tiles)
        if bk.route == binning.ROUTE_BIN:
            return acc_k.bin_numeric_plain(**kw, tile_n=bk.tile_n,
                                           n_tiles=bk.n_tiles)
        return num_k.spgemm_numeric_plain(**kw)

    # ---- the main path, counted: plain versions and host oracles check
    # ---- each result on the way, and they launch no kernel
    exact = {}
    for name, m in mats[:len(PREDICT_MATRICES)]:
        binplan = binning.build_plan(m, m, route="esc")
        rows = oracle.sample_rows(m.nrows, seed=0)
        ad = csr.to_device(m, device=dev)
        rows_d = torch.from_numpy(rows.astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred, _ = drive("predict", lambda: predictor.proposed_predict_binned(
            ad, ad, rows_d, binplan, use_kernel=True))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        plain = predictor.proposed_predict_binned(ad, ad, rows_d, binplan,
                                                  use_kernel=False)
        for what in ("sampled_nnz", "sampled_flop", "total_flop"):
            if int(getattr(pred, what)) != int(getattr(plain, what)):
                fail(f"predict {name}: {what} kernel "
                     f"{int(getattr(pred, what))} != plain "
                     f"{int(getattr(plain, what))}")
        if not torch.allclose(pred.structure, plain.structure, rtol=0,
                              atol=0, equal_nan=True):
            fail(f"predict {name}: structure (floprC / r*) kernel != plain")
        floprc_host, total_host = oracle.flop_per_row(m, m)
        floprc_plain, _ = flop_mod.flop_per_row(ad, ad)
        if (not np.array_equal(floprc_plain.cpu().numpy(), floprc_host)
                or int(pred.total_flop) != total_host):
            fail(f"predict {name}: floprC != host oracle")
        nnzr_exact, nnz_exact = oracle.exact_structure(m, m)
        exact[name] = nnzr_exact
        emit(dict(phase="predict", matrix=name, rows=m.nrows, nnz=m.nnz,
                  buckets=len(binplan.buckets), samples=int(rows.size),
                  z_star=int(pred.sampled_nnz), f_star=int(pred.sampled_flop),
                  total_flop=int(pred.total_flop),
                  predicted_nnz=float(pred.nnz_total), exact_nnz=nnz_exact,
                  rel_err=(float(pred.nnz_total) - nnz_exact) / nnz_exact,
                  seconds=secs))
        del ad, pred, plain

    def run_plan(m, route):
        """plan → execute → reassemble on the card: the plan, the output,
        the host CSR, host-clock seconds of each step and the peak device
        bytes above what was allocated before."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        p = plan.plan_spgemm(m, m, route=route, use_kernel=True,
                             safety=SAFETY, device=dev)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t
        t = time.perf_counter()
        out = plan.execute(p, m, m)
        torch.cuda.synchronize()
        t_exec = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        t = time.perf_counter()
        c = plan.reassemble(p, out, on_overflow="ignore")
        t_reasm = time.perf_counter() - t
        return p, out, c, dict(plan_s=t_plan, execute_s=t_exec,
                               reassemble_s=t_reasm, peak_bytes=peak)

    num_err = dict.fromkeys(("spgemm_numeric", "spa_numeric",
                             "bin_numeric"), 0.0)
    auto_runs = {}      # matrix -> (rows per route, launch counts) of (c)
    for name, m in mats:
        # (b) every bucket on ESC
        (p, out, c, secs), _ = drive("plan_esc", lambda: run_plan(m, "esc"))
        # each bucket's block of the output against the plain numeric phase
        ad = p.to_device(m, "a")
        for bk, cap in zip(p.binning.buckets, p.alloc.bucket_capacities):
            r = torch.from_numpy(bk.rows).to(dev)
            want = numeric_plain(ad, bk, r, cap)
            rl = r.long()
            got_v = out.val[rl, :cap]
            if not (torch.equal(out.col[rl, :cap], want[0])
                    and torch.equal(out.row_nnz[rl], want[2])
                    and bool((out.col[rl, cap:] == csr.COL_SENTINEL).all())
                    and vals_close(got_v, want[1])):
                fail(f"plan_execute {name}: bucket of width "
                     f"{bk.deg_a}x{bk.deg_b} kernel != plain")
            num_err["spgemm_numeric"] = max(
                num_err["spgemm_numeric"],
                float((got_v - want[1]).abs().max()))
            del want, got_v
        row_nnz = out.row_nnz.cpu().numpy()
        caps = np.asarray(p.alloc.bucket_capacities)[p.binning.row_bucket]
        overflow = int(out.overflow)
        if (overflow != int(np.maximum(row_nnz - caps, 0).sum())
                or not bool(torch.isfinite(out.val).all())):
            fail(f"plan_execute {name}: overflow or values wrong")
        if (c.shape != (m.nrows, m.ncols)
                or c.nnz != int(np.minimum(row_nnz, caps).sum())):
            fail(f"plan_execute {name}: reassembled shape/nnz mismatch")
        if name in exact and not np.array_equal(row_nnz, exact[name]):
            fail(f"plan_execute {name}: row_nnz != exact structure")
        emit(dict(phase="plan_execute", matrix=name, route="esc",
                  rows=m.nrows, nnz=m.nnz, buckets=len(p.binning.buckets),
                  row_capacity=p.alloc.row_capacity,
                  nnz_c=int(row_nnz.sum()), predicted_nnz=p.predicted_nnz,
                  overflow=overflow, safety=SAFETY,
                  row_nnz_equals_plain=True,
                  row_nnz_equals_exact=(True if name in exact else None),
                  **secs))
        del c

        # (c) the default route: same buckets, prediction and capacities,
        # so the same col, row_nnz and overflow as (b)
        (pa, outa, ca, secs), counts = drive("plan_auto",
                                             lambda: run_plan(m, "auto"))
        auto_runs[name] = (pa.binning.route_rows(), counts)
        if (pa.alloc.bucket_capacities != p.alloc.bucket_capacities
                or not np.array_equal(pa.structure, p.structure)
                or pa.predicted_nnz != p.predicted_nnz
                or not all(np.array_equal(x.rows, y.rows) for x, y in
                           zip(pa.binning.buckets, p.binning.buckets))):
            fail(f"plan_auto {name}: plan differs from the ESC plan")
        if not (torch.equal(outa.col, out.col)
                and torch.equal(outa.row_nnz, out.row_nnz)
                and int(outa.overflow) == overflow):
            fail(f"plan_auto {name}: col/row_nnz/overflow != the ESC run")
        for bk, cap in zip(pa.binning.buckets, pa.alloc.bucket_capacities):
            rl = torch.from_numpy(bk.rows).to(dev).long()
            got_v = outa.val[rl, :cap]
            if not vals_close(got_v, out.val[rl, :cap]):
                fail(f"plan_auto {name}: {bk.route} bucket val != ESC run")
            if bk.route != binning.ROUTE_ESC:
                want = numeric_plain(ad, bk, rl.int(), cap)
                if not (torch.equal(outa.col[rl, :cap], want[0])
                        and torch.equal(outa.row_nnz[rl], want[2])
                        and vals_close(got_v, want[1])):
                    fail(f"plan_auto {name}: {bk.route} bucket of width "
                         f"{bk.deg_a}x{bk.deg_b} kernel != plain")
                k = f"{bk.route}_numeric"
                num_err[k] = max(num_err[k],
                                 float((got_v - want[1]).abs().max()))
                del want
            del got_v
        if ca.nnz != int(np.minimum(row_nnz, caps).sum()):
            fail(f"plan_auto {name}: reassembled nnz mismatch")
        emit(dict(phase="plan_auto", matrix=name, route="auto",
                  route_rows=pa.binning.route_rows(),
                  buckets=len(pa.binning.buckets),
                  routes=[(bk.route, bk.n_rows, bk.deg_a, bk.deg_b, bk.span,
                           bk.tile_n, bk.n_tiles)
                          for bk in pa.binning.buckets
                          if bk.route != binning.ROUTE_ESC],
                  overflow=int(outa.overflow), equals_esc_run=True,
                  launches=counts, **secs))
        del p, out, pa, outa, ca, ad
        torch.cuda.empty_cache()
    emit(dict(phase="main_path_launches", **launches))
    # plan_spgemm takes floprC from the host, so the FLOP kernel runs on
    # path (a) only
    for path, kinds in (("predict", names[:2]), ("plan_esc", names[1:3]),
                        ("plan_auto", names[3:])):
        for k in kinds:
            if launches[path][k] <= 0:
                fail(f"kernel {k} was not launched on main path {path}")
    for name, (routes, counts) in auto_runs.items():
        for route, k in ((binning.ROUTE_SPA, "spa_numeric"),
                         (binning.ROUTE_BIN, "bin_numeric")):
            if routes[route] and counts[k] <= 0:
                fail(f"plan_auto {name}: {route} buckets but no {k} launch")

    # ---- small products on every route against the dense oracle -------- #
    minis = suite.mini_suite(scale=200)
    for route in ("esc", "spa", "bin", "auto"):
        for name, m in minis:
            p = plan.plan_spgemm(m, m, route=route, use_kernel=True,
                                 device=dev)
            if route != "auto" and p.binning.route_rows()[route] != m.nrows:
                fail(f"reference {name}: route {route} not forced")
            c = plan.reassemble(p, plan.execute(p, m, m))
            if not np.allclose(c.to_dense(), spgemm_dense_oracle(m, m),
                               rtol=VAL_RTOL, atol=1e-6):
                fail(f"reference {name} on {route}: reassembled product != "
                     "dense oracle")
        emit(dict(phase="reference", route=route,
                  matrices=[n for n, _ in minis], equals_dense_oracle=True))

    # ---- each kernel against its plain version, then timed ----------- #
    # Integer outputs must be equal; the errors are still measured.
    int_err = dict(flop_rows=0, fused_flop_symbolic=0,
                   fused_flop_symbolic_bitmask=0)
    calls = {}          # (kernel, matrix) -> [(kwargs, host rows, ...), ...]
    for name, m in mats[:len(PREDICT_MATRICES)]:
        binplan = binning.build_plan(m, m, route="esc")
        rows = oracle.sample_rows(m.nrows, seed=0)
        ad = csr.to_device(m, device=dev)
        rnb = torch.diff(ad.rpt)
        floprc_host, _ = oracle.flop_per_row(m, m)
        fc, sc = [], []
        for bk, sub in zip(binplan.buckets, binplan.subset(rows)):
            kw = dict(a=ad, rownnz_b=rnb, max_deg_a=bk.deg_a,
                      rows=torch.from_numpy(bk.rows).to(dev))
            got, want = flop_k.flop_rows(**kw), flop_k.flop_rows_plain(**kw)
            if not (torch.equal(got, want) and np.array_equal(
                    got.cpu().numpy(), floprc_host[bk.rows])):
                fail(f"flop_rows {name}: kernel != plain/host")
            int_err["flop_rows"] = max(int_err["flop_rows"],
                                       int((got - want).abs().max()))
            fc.append((kw, bk.rows, bk.deg_a, bk.deg_b))
            if sub.size == 0:
                continue
            kw = dict(a=ad, b=ad, rows=torch.from_numpy(sub).to(dev),
                      max_deg_a=bk.deg_a, max_deg_b=bk.deg_b, rownnz_b=rnb)
            got = sym_k.fused_flop_symbolic(**kw)
            want = sym_k.fused_flop_symbolic_plain(**kw)
            err = max(abs(int(got[0]) - int(want[0])),
                      abs(int(got[1]) - int(want[1])),
                      int((got[2] - want[2]).abs().max()))
            if err:
                fail(f"fused_flop_symbolic {name}: kernel != plain")
            int_err["fused_flop_symbolic"] = max(
                int_err["fused_flop_symbolic"], err)
            sc.append((kw, sub, bk.deg_a, bk.deg_b))
        calls["flop_rows", name] = fc
        calls["fused_flop_symbolic", name] = sc
    floprc = {}
    for name, m in mats:
        floprc[name] = oracle.flop_per_row(m, m)[0]
        # the bitmask symbolic kernel on the auto plan's SPA and BIN
        # buckets' sampled rows: equal to its plain version and to the ESC
        # kernel on the same rows
        binplan = binning.build_plan(m, m)
        rows = oracle.sample_rows(m.nrows, seed=0)
        ad = csr.to_device(m, device=dev)
        rnb = torch.diff(ad.rpt)
        bc = []
        for bk, sub in zip(binplan.buckets, binplan.subset(rows)):
            if bk.route == binning.ROUTE_ESC or sub.size == 0:
                continue
            kw = dict(a=ad, b=ad, rows=torch.from_numpy(sub).to(dev),
                      max_deg_a=bk.deg_a, max_deg_b=bk.deg_b, rownnz_b=rnb)
            got = acc_k.fused_flop_symbolic_bitmask(**kw, span=bk.span)
            for want in (acc_k.fused_flop_symbolic_bitmask_plain(
                             **kw, span=bk.span),
                         sym_k.fused_flop_symbolic(**kw)):
                err = max(abs(int(got[0]) - int(want[0])),
                          abs(int(got[1]) - int(want[1])),
                          int((got[2] - want[2]).abs().max()))
                if err:
                    fail(f"fused_flop_symbolic_bitmask {name}: kernel != "
                         "plain/ESC kernel")
                int_err["fused_flop_symbolic_bitmask"] = max(
                    int_err["fused_flop_symbolic_bitmask"], err)
            bc.append((dict(kw, span=bk.span), sub, bk.deg_a, bk.deg_b))
        if bc:
            calls["fused_flop_symbolic_bitmask", name] = bc
    emit(dict(phase="kernels_checked", bucket_calls={
        k: sum(len(c) for (kk, _), c in calls.items() if kk == k)
        for k in int_err}))
    for name, m in mats:
        # the numeric kernels were held against their plain versions bucket
        # by bucket on the main path above; here their buckets are only
        # timed (an auto plan: its buckets and capacities are the ESC
        # plan's, so the ESC kernel times every bucket)
        p = plan.plan_spgemm(m, m, use_kernel=False, safety=SAFETY,
                             device=dev)
        ad = p.to_device(m, "a")
        for bk, cap in zip(p.binning.buckets, p.alloc.bucket_capacities):
            kw = dict(a=ad, b=ad, rows=torch.from_numpy(bk.rows).to(dev),
                      max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
                      row_capacity=cap)
            call = (kw, bk.rows, bk.deg_a, bk.deg_b, cap)
            calls.setdefault(("spgemm_numeric", name), []).append(call)
            if bk.route != binning.ROUTE_ESC:
                calls.setdefault((f"{bk.route}_numeric", name), []).append(
                    (dict(kw, tile_n=bk.tile_n, n_tiles=bk.n_tiles),
                     *call[1:]))

    kernel_of = {"flop_rows": (flop_k.flop_rows, flop_k.flop_rows_plain,
                               None, "flop_rows.cu", "flop_per_row.py:80"),
                 "fused_flop_symbolic": (
                     sym_k.fused_flop_symbolic,
                     sym_k.fused_flop_symbolic_plain, None,
                     "esc_symbolic.cu", "spgemm_symbolic.py:102"),
                 "spgemm_numeric": (
                     num_k.spgemm_numeric, num_k.spgemm_numeric_plain, None,
                     "esc_numeric.cu", "spgemm_numeric.py:59"),
                 "fused_flop_symbolic_bitmask": (
                     acc_k.fused_flop_symbolic_bitmask,
                     acc_k.fused_flop_symbolic_bitmask_plain,
                     sym_k.fused_flop_symbolic, "bitmask_symbolic.cu",
                     "accumulator.py:242"),
                 "spa_numeric": (
                     acc_k.spa_numeric, acc_k.spa_numeric_plain,
                     num_k.spgemm_numeric, "spa_numeric.cu",
                     "accumulator.py:334"),
                 "bin_numeric": (
                     acc_k.bin_numeric, acc_k.bin_numeric_plain,
                     num_k.spgemm_numeric, "bin_numeric.cu",
                     "accumulator.py:387")}
    library = {}

    def library_ms(name):
        """Yardstick only: one cuSPARSE call for the same product."""
        if name not in library:
            m = dict(mats)[name]
            a_sp = torch.sparse_csr_tensor(
                torch.from_numpy(m.rpt).to(dev),
                torch.from_numpy(m.col.astype(np.int64)).to(dev),
                torch.from_numpy(m.val).to(dev), size=m.shape)
            library[name] = cuda_ms(torch,
                                    lambda: torch.sparse.mm(a_sp, a_sp))
        return library[name]

    def entry(kernel, name):
        fn, plain_fn, esc_fn, source, replaces = kernel_of[kernel]
        cs = calls[kernel, name]
        m = dict(mats)[name]
        ms = cuda_ms(torch, lambda: [fn(**c[0]) for c in cs])
        plain_ms = cuda_ms(torch, lambda: [plain_fn(**c[0]) for c in cs])
        esc_ms = None
        if esc_fn is not None:
            # the ESC kernel on the same rows, at the same bounds
            esc_kw = [{k: v for k, v in c[0].items()
                       if k not in ("span", "tile_n", "n_tiles")} for c in cs]
            esc_ms = cuda_ms(torch, lambda: [esc_fn(**kw) for kw in esc_kw])
        ops = 0
        if kernel == "flop_rows":
            nbytes = sum(bytes_flop_rows(np, m, c[1], c[2]) for c in cs)
        elif kernel.startswith("fused_flop_symbolic"):
            nbytes = sum(bytes_symbolic(np, m, c[1], c[2], c[3]) for c in cs)
        else:
            nbytes = sum(bytes_numeric(np, m, *c[1:]) for c in cs)
            ops = sum(numeric_ops(floprc[name], c[1]) for c in cs)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOP_PER_S * 1e3
        numeric = kernel.endswith("numeric")
        return dict(name=kernel, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=f"src/repro/kernels/{replaces}",
                    launches=sum(launches[p][kernel] for p in launches),
                    max_abs_err=float(int_err.get(kernel,
                                                  num_err.get(kernel))),
                    ms=ms, plain_ms=plain_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=library_ms(name) if numeric else None,
                    esc_ms=esc_ms, timed_on=name, calls=len(cs),
                    bytes=nbytes, operations=ops)

    # every (kernel, matrix) timing gets its own line; the contract line
    # takes one matrix per kernel: the power-law predict input for the ESC
    # predict kernels, the cant-sized FEM product for the ESC numeric, the
    # bitmask symbolic and the SPA kernels, R-MAT's hub rows for BIN
    timings = {key: entry(*key) for key in calls}
    for e in timings.values():
        emit(dict(phase="kernel_time", **e))
    report = [timings["flop_rows", "pl_100k_d4"],
              timings["fused_flop_symbolic", "pl_100k_d4"],
              timings["spgemm_numeric", "cant_like"],
              timings["fused_flop_symbolic_bitmask", "cant_like"],
              timings["spa_numeric", "cant_like"],
              timings["bin_numeric", "rmat_80k"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in report]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
