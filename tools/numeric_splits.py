#!/usr/bin/env python3
"""Time the port's two main-path numeric kernels on one CUDA card, split by
each row's FLOP class: ESC numeric (kernel 3, ``csrc/esc_numeric.cu``) and
BIN numeric (kernel 6, ``csrc/bin_numeric.cu``); or, with ``--predict``, the
binned predictor's two kernels (FLOP per row, kernel 1, and fused ESC
symbolic, kernel 2) split into device and host time.

Run from the repository root::

    python3 tools/numeric_splits.py [--predict] [--bitmask] [--reassemble]
        [--matrices NAMES] [--src DIR] [--out FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so one call on one card can time two trees in
turns.  For each of ``chip_smoke.py``'s seven squared products it plans
``route="esc"`` (and ``"auto"`` for R-MAT's BIN buckets) at safety 1.3,
splits every bucket's rows by their FLOP into classes, and times each
class's per-bucket kernel calls at the bucket's bounds and capacity with
CUDA events (median of 5 after 2 warm-ups); also every bucket at once,
with the kernels' own device time from ``torch.profiler`` beside it,
``torch.sparse.mm`` of the product, the global-pad ESC numeric phase on
``rmat_80k`` and ``cant_like``, one ``plan.execute`` and ``reassemble`` per
product, and whether ``torch.profiler`` sees device time.  Where the kernel
wrappers take ``max_row_flop``, each call gets its rows' largest FLOP, as
the planned path passes it.  With ``--ptxas`` it also prints ``nvcc
-Xptxas -v`` (registers, shared memory, spills) for both sources (with
``--predict``: for ``flop_rows.cu`` and ``esc_symbolic.cu``).  One JSON
object per line on stdout, and the same lines in ``--out``.

``--attention`` times ``ops.flash_attention`` on ``chip_smoke.py``'s
attention cases G1-G5 (CUDA events, the device time ``torch.profiler``
sees, TFLOP/s) beside ``scaled_dot_product_attention`` on the same inputs;
``--global`` times the global-pad predictor's sampled symbolic kernel
(kernel 7) on the five predict products' seed-0 samples at their global
bounds, with the rows' FLOP as its workspace hint, as the predictor calls
it (events, device time, host time to issue a call), and on two products
whose long rows do not fit shared memory (``wide_products``).  Both run on a tree
whose flash attention or kernel 7 has either design.

``--spa`` times the SPA numeric kernel (kernel 5, ``csrc/spa_numeric.cu``)
on every SPA bucket of the ``route="auto"`` plans of ``band_60k_d16``,
``fem_30k_d48`` and ``cant_like`` squared, by FLOP class and whole, as the
executor calls it (the bucket's bounds, tile and capacity): CUDA-event ms,
the kernel's own device ms from ``torch.profiler`` and the host ms to issue
a call, with the ESC numeric kernel (3) on the same rows beside it; then
all SPA buckets of each product in sequence.  ``--flop-all`` times the
all-rows FLOP kernel (kernel 9) on the seven products at each one's largest
row degree, as the global-pad predictor calls it: events, device and host
ms, its bound (bytes over 3.35 TB/s) and whether it equals the host
oracle.  Both run on a tree with either design of the two kernels.

``--bitmask`` times the bitmask symbolic kernels (``csrc/bitmask_symbolic.cu``)
on the seven products, each with its ``route="auto"`` bucket plan and
seed-0 sampled rows: kernel 4 over the SPA and BIN buckets' samples as the
per-bucket sequence (``fused_flop_symbolic_bitmask``, one call a bucket)
and, where the tree has it, as one launch
(``fused_flop_symbolic_bitmask_buckets`` over
``predictor.bitmask_sample_table``), each by CUDA events, the kernel's own
device time from ``torch.profiler`` and the host time to issue a call; the
whole ``binned_symbolic_counts(use_kernel=True)`` and
``proposed_predict_binned(use_kernel=True)`` calls by synchronised host
clock (floprC passed as the planner passes it); and kernel 8
(``bitmask_symbolic``) at the global bounds over the same sampled rows,
with kernel 7's device time on the same rows beside it.  Every count is
held to the host oracle.  It runs on a tree with either design; on one
with the one-launch entry it also splits kernel 8's rows by unit (its
short and long rows by FLOP alone, and every row on a block or first on
a warp through a table), by device time.

``--reassemble`` times ``plan.reassemble`` (host clock, ended by a
synchronise, median of 5 after 2 warm-ups) on the executed
``route="esc"`` and ``route="auto"`` plans of ``rmat_80k`` and
``cant_like`` squared at safety 1.3, with the device memory it peaks at
over the executed output and a checksum of the CSR it builds, so two trees
timed in turns can be held to the same result.  ``--matrices`` (names,
comma-separated) keeps only those products in ``--predict``,
``--bitmask`` and ``--reassemble``.

``--predict`` takes ``chip_smoke.py``'s five predict products instead, each
with its ``route="esc"`` bucket plan and seed-0 sampled rows, and times the
per-bucket calls of kernels 1 and 2 as the binned predictor made them one
bucket at a time (rows already on the card): CUDA-event time of the whole
sequence, the kernels' own device time and every device operation's from
``torch.profiler``, and the host time to issue the sequence (no
synchronisation inside it) per call.  Where the tree has the one-launch
entries (``flop_rows_buckets``, ``fused_flop_symbolic_buckets``) it times
them the same way, tables already on the card, and all-rows kernel 9 on the
same product; and in every tree the whole ``_binned_floprc`` and
``binned_symbolic_counts(use_kernel=True)`` calls by host clock, uploads
included (the latter given floprC where it takes it, as the predictor
gives it).
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# FLOP classes (inclusive upper edges); the last takes the rest
CLASS_EDGES = (0, 32, 256, 2048, 16384)
SAFETY = 1.3
RUNS = 5
MATRICES = ("er_120k_d3", "pl_100k_d4", "rmat_80k", "band_60k_d16",
            "fem_30k_d48", "cant_like", "webbase_like")


def cuda_ms(torch, fn, runs: int = RUNS) -> float:
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


def host_ms(torch, fn, runs: int = RUNS) -> float:
    """Median host milliseconds to issue ``fn`` (after a synchronise, with
    none inside): the host's share of a sequence of launches."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def synced_ms(torch, fn, runs: int = RUNS) -> float:
    """Median host-clock milliseconds of ``fn`` ended by a synchronise."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    times.sort()
    return times[len(times) // 2]


def profiled_ms(torch, fn, pattern: str, reps: int = 1) -> tuple:
    """(device ms of the kernels whose name holds ``pattern``, device ms of
    every device operation) in a run of ``fn``, from torch.profiler, the
    mean over ``reps`` runs; None where it sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    own = every = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        every += t
        if pattern in e.key:
            own += t
    return ((own / 1e3 / reps if own else None),
            (every / 1e3 / reps if every else None))


def device_ms(torch, fn) -> float | None:
    """The numeric kernels' own device time in one run of ``fn`` (ms), from
    torch.profiler: beside ``cuda_ms``'s event time it splits the card's
    work from the gaps a host-bound loop of calls leaves.  None where the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0)
                for e in prof.key_averages()
                if "numeric" in e.key or "Memset" in e.key)
    return total / 1e3 if total else None


def class_name(i: int) -> str:
    lo = 0 if i == 0 else CLASS_EDGES[i - 1] + 1
    hi = CLASS_EDGES[i] if i < len(CLASS_EDGES) else None
    return f"{lo}-{hi}" if hi is not None else f">{lo - 1}"


def ptxas(src_dir: str, names=("esc_numeric", "bin_numeric")) -> list[str]:
    """``nvcc -Xptxas -v`` of the named sources (by default the two numeric
    ones), compiled to cubin."""
    from repro_torch.kernels import _build
    csrc = os.path.join(src_dir, "repro_torch", "kernels", "csrc")
    lines = []
    out_dir = _build.BUILD_ROOT / "ptxas"     # ignored, like every build
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in names:
        out = str(out_dir / f"{name}.cubin")
        flags = [f for f in _build.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC")]
        proc = subprocess.run(
            [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-I", csrc,
             "-o", out, os.path.join(csrc, f"{name}.cu")],
            capture_output=True, text=True, timeout=600)
        lines += [f"{name}: {ln}" for ln in
                  (proc.stdout + proc.stderr).splitlines()
                  if "ptxas" in ln or "error" in ln]
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--attention", action="store_true")
    ap.add_argument("--global", dest="global_pad", action="store_true")
    ap.add_argument("--spa", action="store_true")
    ap.add_argument("--flop-all", dest="flop_all", action="store_true")
    ap.add_argument("--bitmask", action="store_true")
    ap.add_argument("--reassemble", action="store_true")
    ap.add_argument("--matrices", default=None)
    args = ap.parse_args()
    global ONLY
    ONLY = tuple(args.matrices.split(",")) if args.matrices else None
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("numeric_splits: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import binning, oracle, plan, predictor, spgemm
    from repro_torch.kernels import _build
    from repro_torch.kernels import accumulator as acc_k
    from repro_torch.kernels import spgemm_numeric as num_k
    warnings.filterwarnings("ignore", message="Sparse")
    out_f = open(args.out, "a") if args.out else None

    def emit(obj):
        obj = dict(tag=args.tag, **obj)
        line = json.dumps(obj)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    built = _build.build_all()
    emit(dict(phase="setup", src=os.path.abspath(args.src), nvidia_smi=smi,
              torch=torch.__version__, build_s=built["seconds"]))
    if args.ptxas:
        names = (("flop_rows", "esc_symbolic") if args.predict
                 else ("bitmask_symbolic",) if args.bitmask
                 else ("flash_attention", "flash_attention_sm90")
                 if args.attention
                 else ("spa_numeric", "flop_rows") if args.spa or args.flop_all
                 else ("esc_numeric", "bin_numeric"))
        for ln in ptxas(os.path.abspath(args.src), names):
            emit(dict(phase="ptxas", line=ln))
    if (args.predict or args.attention or args.global_pad or args.spa
            or args.flop_all or args.bitmask or args.reassemble):
        if args.reassemble:
            reassemble_splits(torch, np, dev, emit)
        if args.bitmask:
            bitmask_splits(torch, np, dev, emit)
        if args.spa:
            spa_splits(torch, np, dev, emit)
        if args.flop_all:
            flop_all_splits(torch, np, dev, emit)
        if args.predict:
            predict_splits(torch, np, dev, emit)
        if args.global_pad:
            global_splits(torch, np, dev, emit)
        if args.attention:
            attention_splits(torch, dev, emit)
        if out_f:
            out_f.close()
        return 0
    takes_bound = "max_row_flop" in inspect.signature(
        num_k.spgemm_numeric).parameters

    for name, m in products(MATRICES):
        floprc, _ = oracle.flop_per_row(m, m)
        p = plan.plan_spgemm(m, m, route="esc", use_kernel=True,
                             safety=SAFETY, device=dev)
        ad = p.to_device(m, "a")
        rnb = torch.diff(ad.rpt)    # once an execute, as the executor does
        routes = [("esc", p)]
        if name == "rmat_80k":
            routes.append(("bin", plan.plan_spgemm(
                m, m, route="auto", use_kernel=True, safety=SAFETY,
                device=dev)))
        for route, pp in routes:
            # per class: one call per bucket on the bucket's rows in the class
            per_class = {}
            for bk, cap in zip(pp.binning.buckets,
                               pp.alloc.bucket_capacities):
                if route == "bin" and bk.route != binning.ROUTE_BIN:
                    continue
                cls = np.searchsorted(CLASS_EDGES, floprc[bk.rows])
                for c in np.unique(cls):
                    rows = bk.rows[cls == c]
                    kw = dict(a=ad, b=ad,
                              rows=torch.from_numpy(rows).to(dev),
                              max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
                              row_capacity=int(cap), rownnz_b=rnb)
                    if takes_bound:
                        kw["max_row_flop"] = int(floprc[rows].max())
                    per_class.setdefault(int(c), []).append((kw, rows, bk))
            fn = (num_k.spgemm_numeric if route == "esc"
                  else acc_k.bin_numeric)
            extra = ((lambda bk: {}) if route == "esc" else
                     (lambda bk: dict(tile_n=bk.tile_n, n_tiles=bk.n_tiles)))
            for c in sorted(per_class):
                calls = [(dict(kw, **extra(bk)), rows)
                         for kw, rows, bk in per_class[c]]
                ms = cuda_ms(torch, lambda: [fn(**kw) for kw, _ in calls])
                row = dict(phase="split", matrix=name, kernel=route,
                           flop_class=class_name(c),
                           rows=int(sum(r.size for _, r in calls)),
                           products=int(sum(floprc[r].sum()
                                            for _, r in calls)),
                           calls=len(calls), ms=ms)
                if route == "bin":     # the ESC kernel on the same rows
                    esc_calls = [{k: v for k, v in kw.items()
                                  if k not in ("tile_n", "n_tiles")}
                                 for kw, _ in calls]
                    row["esc_ms"] = cuda_ms(
                        torch, lambda: [num_k.spgemm_numeric(**kw)
                                        for kw in esc_calls])
                emit(row)
            # every bucket of the route, one call each, as the main path
            # makes them
            whole = []
            for bk, cap in zip(pp.binning.buckets,
                               pp.alloc.bucket_capacities):
                if route == "bin" and bk.route != binning.ROUTE_BIN:
                    continue
                kw = dict(a=ad, b=ad, rows=torch.from_numpy(bk.rows).to(dev),
                          max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
                          row_capacity=int(cap), rownnz_b=rnb, **extra(bk))
                if takes_bound:
                    kw["max_row_flop"] = int(floprc[bk.rows].max())
                whole.append(kw)
            emit(dict(phase="whole", matrix=name, kernel=route,
                      calls=len(whole),
                      ms=cuda_ms(torch, lambda: [fn(**kw) for kw in whole]),
                      device_ms=device_ms(torch,
                                          lambda: [fn(**kw) for kw in whole])))
        # one execute and one reassemble of the ESC plan, host clock
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = plan.execute(p, ad, ad)
        torch.cuda.synchronize()
        t_exec = time.perf_counter() - t
        t = time.perf_counter()
        plan.reassemble(p, res, on_overflow="ignore")
        t_reasm = time.perf_counter() - t
        a_sp = torch.sparse_csr_tensor(
            torch.from_numpy(m.rpt).to(dev),
            torch.from_numpy(m.col.astype(np.int64)).to(dev),
            torch.from_numpy(m.val).to(dev), size=m.shape)
        emit(dict(phase="product", matrix=name, execute_s=t_exec,
                  reassemble_s=t_reasm,
                  library_ms=cuda_ms(torch,
                                     lambda: torch.sparse.mm(a_sp, a_sp))))
        if name in ("rmat_80k", "cant_like"):
            da = int(m.row_nnz.max())
            kw = dict(row_capacity=predictor.AllocationPlan.from_prediction(
                p.structure, floprc, safety=SAFETY).row_capacity,
                max_deg_a=da, max_deg_b=da)
            emit(dict(phase="global_pad", matrix=name,
                      ms=cuda_ms(torch, lambda: spgemm.spgemm(
                          ad, ad, use_kernel=True, **kw))))
        if name == "rmat_80k":
            # does torch.profiler see the card here?
            try:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    plan.execute(p, ad, ad)
                    torch.cuda.synchronize()
                dev_us = {}
                for e in prof.key_averages():
                    t_dev = getattr(e, "device_time_total",
                                    getattr(e, "cuda_time_total", 0))
                    if t_dev:
                        dev_us[e.key[:60]] = t_dev
                emit(dict(phase="profiler", matrix=name,
                          device_us=dict(sorted(
                              dev_us.items(), key=lambda kv: -kv[1])[:12])))
            except Exception as e:          # report and go on
                emit(dict(phase="profiler", error=repr(e)))
        del p, ad, res
        torch.cuda.empty_cache()
    if out_f:
        out_f.close()
    return 0


PREDICT_MATRICES = MATRICES[:5]
SPA_MATRICES = ("band_60k_d16", "fem_30k_d48", "cant_like")
REASSEMBLE_MATRICES = ("rmat_80k", "cant_like")
ONLY = None                      # --matrices


def chosen(names) -> tuple:
    """``names`` less those that ``--matrices`` leaves out."""
    return tuple(n for n in names if ONLY is None or n in ONLY)
WHOLE_RUNS = 101                 # host-clock runs of a whole prediction
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)


def products(names):
    """``(name, matrix)`` of ``chip_smoke.py``'s products: the suite members
    and the two SuiteSparse-sized analogues, built the same way."""
    from repro_torch.sparse import random as sprand
    from repro_torch.sparse import suite
    for name in names:
        if name == "cant_like":
            yield name, sprand.banded(62_451, 62_451, 100, 50, seed=602)
        elif name == "webbase_like":
            yield name, sprand.power_law(1_000_005, 1_000_005, 4, 1.4,
                                         seed=601)
        else:
            yield name, suite.get_matrix(name)


def reassemble_splits(torch, np, dev, emit) -> None:
    """``--reassemble``: ``plan.reassemble`` of one executed plan a route,
    host clock, with its peak device memory and a checksum of its CSR."""
    import zlib

    from repro_torch.core import plan
    for name, m in products(chosen(REASSEMBLE_MATRICES)):
        for route in ("esc", "auto"):
            p = plan.plan_spgemm(m, m, route=route, use_kernel=True,
                                 safety=SAFETY, device=dev)
            out = plan.execute(p, m, m)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            c = plan.reassemble(p, out)
            peak = torch.cuda.max_memory_allocated() - base
            ms = synced_ms(torch, lambda: plan.reassemble(p, out))
            emit(dict(phase="reassemble", matrix=name, route=route,
                      output_bytes=int(out.col.numel() * 8),
                      nnz=int(c.rpt[-1]), reassemble_ms=ms,
                      peak_bytes_over_output=int(peak),
                      crc=zlib.crc32(np.ascontiguousarray(c.rpt).tobytes()
                                     + c.col.tobytes() + c.val.tobytes())))
            del out, c
            torch.cuda.empty_cache()


def spa_splits(torch, np, dev, emit) -> None:
    """``--spa``: kernel 5 on each SPA bucket of the auto plans, by FLOP
    class and whole, beside the ESC kernel on the same rows; then every SPA
    bucket of a product in sequence, as ``execute`` launches them."""
    from repro_torch.core import binning, oracle, plan
    from repro_torch.kernels import accumulator as acc_k
    from repro_torch.kernels import spgemm_numeric as num_k
    for name, m in products(SPA_MATRICES):
        floprc, _ = oracle.flop_per_row(m, m)
        p = plan.plan_spgemm(m, m, route="auto", use_kernel=True,
                             safety=SAFETY, device=dev)
        ad = p.to_device(m, "a")
        rnb = torch.diff(ad.rpt)
        whole = []
        for bk, cap in zip(p.binning.buckets, p.alloc.bucket_capacities):
            if bk.route != binning.ROUTE_SPA:
                continue
            cls = np.searchsorted(CLASS_EDGES, floprc[bk.rows])
            groups = [(class_name(int(c)), bk.rows[cls == c])
                      for c in np.unique(cls)]
            for label, rows in groups + [("all", bk.rows)]:
                kw = dict(a=ad, b=ad, rows=torch.from_numpy(rows).to(dev),
                          max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
                          row_capacity=int(cap), rownnz_b=rnb)
                spa = dict(kw, tile_n=bk.tile_n, n_tiles=bk.n_tiles)
                esc = dict(kw, max_row_flop=int(floprc[rows].max()))
                fn = lambda: acc_k.spa_numeric(**spa)
                own, every = profiled_ms(torch, fn, "spa_numeric", reps=5)
                esc_fn = lambda: num_k.spgemm_numeric(**esc)
                emit(dict(phase="spa_split", matrix=name,
                          bucket=f"{bk.deg_a}x{bk.deg_b}", tile_n=bk.tile_n,
                          n_tiles=bk.n_tiles, flop_class=label,
                          rows=int(rows.size),
                          products=int(floprc[rows].sum()),
                          row_capacity=int(cap), ms=cuda_ms(torch, fn),
                          device_ms=own, all_device_ms=every,
                          host_ms=host_ms(torch, fn),
                          esc_ms=cuda_ms(torch, esc_fn),
                          esc_device_ms=profiled_ms(torch, esc_fn,
                                                    "esc_numeric",
                                                    reps=5)[0]))
            whole.append(spa)
        fn = lambda: [acc_k.spa_numeric(**kw) for kw in whole]
        own, every = profiled_ms(torch, fn, "spa_numeric", reps=5)
        emit(dict(phase="spa_whole", matrix=name, calls=len(whole),
                  ms=cuda_ms(torch, fn), device_ms=own, all_device_ms=every,
                  host_ms=host_ms(torch, fn)))
        del p, ad, rnb, whole
        torch.cuda.empty_cache()


def flop_all_splits(torch, np, dev, emit) -> None:
    """``--flop-all``: kernel 9 over all rows at the product's largest row
    degree, as the global-pad predictor calls it."""
    from repro_torch.core import csr, oracle
    from repro_torch.kernels import flop_per_row as flop_k
    for name, m in products(MATRICES):
        ad = csr.to_device(m, device=dev)
        rnb = torch.diff(ad.rpt)
        da = int(m.row_nnz.max())
        fn = lambda: flop_k.flop_per_row(ad, rnb, max_deg_a=da)
        agrees = bool(np.array_equal(fn().cpu().numpy(),
                                     oracle.flop_per_row(m, m)[0]))
        # row pointers, A's column ids, the referenced B row lengths read
        # once, one int32 written per row (chip_smoke.py's count)
        n_ref = np.unique(m.col).size
        nbytes = 4 * (m.nrows + 1) + 4 * m.nnz + 4 * n_ref + 4 * m.nrows
        own, every = profiled_ms(torch, fn, "flop_", reps=20)
        emit(dict(phase="flop_all_split", matrix=name, rows=m.nrows,
                  nnz=m.nnz, max_deg=da, mean_deg=m.nnz / m.nrows,
                  agrees=agrees, ms=cuda_ms(torch, fn), device_ms=own,
                  all_device_ms=every, host_ms=host_ms(torch, fn),
                  bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
        del ad, rnb
        torch.cuda.empty_cache()


def host_profile(torch, emit, name, seqs, calls: int = 200) -> None:
    """Where the host time of each one-launch entry goes: cProfile over
    ``calls`` calls, the functions with the most own time, µs a call."""
    import cProfile
    import pstats
    for kernel, how, _, fn, _ in seqs:
        if how != "one_launch":
            continue
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        prof.enable()
        for _ in range(calls):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
        emit(dict(phase="host_profile", matrix=name, kernel=kernel,
                  us_per_call={f"{f[2]} ({os.path.basename(f[0])}:{f[1]})":
                               v[2] / calls * 1e6 for f, v in top}))


def predict_splits(torch, np, dev, emit) -> None:
    """``--predict``: kernels 1 and 2 of the binned predictor, per bucket as
    the parent made them and, where the tree has it, in one launch."""
    from repro_torch.core import binning, csr, oracle, predictor
    from repro_torch.kernels import _build
    from repro_torch.kernels import flop_per_row as flop_k
    from repro_torch.kernels import spgemm_symbolic as sym_k
    from repro_torch.sparse import suite
    one_launch = hasattr(flop_k, "flop_rows_buckets")
    for name in chosen(PREDICT_MATRICES):
        m = suite.get_matrix(name)
        bp = binning.build_plan(m, m, route="esc")
        rows = oracle.sample_rows(m.nrows, seed=0)
        ad = csr.to_device(m, device=dev)
        rnb = torch.diff(ad.rpt)
        rows_d = torch.from_numpy(rows.astype(np.int32)).to(dev)
        k1 = [dict(a=ad, rownnz_b=rnb, max_deg_a=bk.deg_a,
                   rows=torch.from_numpy(bk.rows).to(dev))
              for bk in bp.buckets]
        k2 = [dict(a=ad, b=ad, rows=torch.from_numpy(sub).to(dev),
                   max_deg_a=bk.deg_a, max_deg_b=bk.deg_b, rownnz_b=rnb)
              for bk, sub in zip(bp.buckets, bp.subset(rows)) if sub.size]
        seqs = [("flop_rows", "per_bucket", "flop_rows",
                 lambda: [flop_k.flop_rows(**kw) for kw in k1], len(k1)),
                ("fused_flop_symbolic", "per_bucket", "esc_symbolic",
                 lambda: [sym_k.fused_flop_symbolic(**kw) for kw in k2],
                 len(k2))]
        if one_launch:
            tabs = predictor.plan_tables(bp, dev)
            floprc = flop_k.flop_rows_buckets(ad, rnb, tabs.flop)
            table = predictor.esc_sample_table(
                bp, tabs, rows, floprc.cpu().numpy()[rows], dev)
            da = int(m.row_nnz.max())
            seqs += [("flop_rows", "one_launch", "flop_rows",
                      lambda: flop_k.flop_rows_buckets(ad, rnb, tabs.flop), 1),
                     ("fused_flop_symbolic", "one_launch", "esc_symbolic",
                      lambda: sym_k.fused_flop_symbolic_buckets(
                          ad, ad, table, rownnz_b=rnb), 1)]
        else:
            da = int(m.row_nnz.max())
        seqs.append(("flop_per_row", "all_rows", "flop_",
                     lambda: flop_k.flop_per_row(ad, rnb, max_deg_a=da), 1))
        for kernel, how, pattern, fn, calls in seqs:
            own, every = profiled_ms(torch, fn, pattern)
            host = host_ms(torch, fn)
            emit(dict(phase="predict_split", matrix=name, kernel=kernel,
                      how=how, calls=calls, ms=cuda_ms(torch, fn),
                      device_ms=own, all_device_ms=every, host_ms=host,
                      host_ms_per_call=host / max(1, calls)))
        if one_launch:
            # kernel 2's one launch on its long rows (a block each) and on
            # its short rows (a warp each) apart
            row_flop = floprc.cpu().numpy()[rows]
            bk = bp.row_bucket[rows]
            da_s = np.array([b.deg_a for b in bp.buckets])[bk]
            db_s = np.array([b.deg_b for b in bp.buckets])[bk]
            long = (np.minimum(row_flop, da_s * db_s)
                    > _build.SYM_WARP_MAX)
            for cls, sel in (("long", long), ("short", ~long)):
                if not sel.any():
                    continue
                t = sym_k.sample_table(rows[sel], da_s[sel], db_s[sel],
                                       row_flop[sel], dev)
                fn = lambda: sym_k.fused_flop_symbolic_buckets(
                    ad, ad, t, rownnz_b=rnb)
                own, _ = profiled_ms(torch, fn, "esc_symbolic")
                emit(dict(phase="class_split", matrix=name,
                          kernel="fused_flop_symbolic", rows_class=cls,
                          rows=int(sel.sum()),
                          max_products=int(row_flop[sel].max()),
                          ms=cuda_ms(torch, fn), device_ms=own))
            if name in ("pl_100k_d4", "rmat_80k"):
                host_profile(torch, emit, name, seqs + [
                    ("binned_symbolic_counts", "one_launch", "", lambda:
                     predictor.binned_symbolic_counts(
                         ad, ad, rows_d, bp, use_kernel=True, floprc=floprc),
                     1),
                    ("proposed_predict_binned", "one_launch", "", lambda:
                     predictor.proposed_predict_binned(
                         ad, ad, rows_d, bp, use_kernel=True), 1)])
        # the whole predictor calls, uploads included, host clock; the
        # symbolic count takes floprC where it can, as the predictor
        # passes it
        floprc_d = predictor._binned_floprc(ad, ad, bp)
        kw = (dict(floprc=floprc_d) if "floprc" in inspect.signature(
            predictor.binned_symbolic_counts).parameters else {})
        emit(dict(phase="predict_whole", matrix=name,
                  buckets=len(bp.buckets),
                  sampled_buckets=len(k2), samples=int(rows.size),
                  binned_floprc_ms=synced_ms(
                      torch, lambda: predictor._binned_floprc(ad, ad, bp)),
                  binned_symbolic_counts_ms=synced_ms(
                      torch, lambda: predictor.binned_symbolic_counts(
                          ad, ad, rows_d, bp, use_kernel=True, **kw)),
                  proposed_predict_binned_ms=synced_ms(
                      torch, lambda: predictor.proposed_predict_binned(
                          ad, ad, rows_d, bp, use_kernel=True))))
        del ad, rnb, k1, k2, seqs
        torch.cuda.empty_cache()


def bitmask_splits(torch, np, dev, emit) -> None:
    """``--bitmask``: kernel 4 on each product's SPA and BIN samples, per
    bucket and, where the tree has it, in one launch; the whole binned
    symbolic count and prediction; kernel 8 at the global bounds beside
    kernel 7 on the same rows."""
    from repro_torch.core import binning, csr, oracle, predictor
    from repro_torch.kernels import _build
    from repro_torch.kernels import accumulator as acc_k
    from repro_torch.kernels import flop_per_row as flop_k
    from repro_torch.kernels import spgemm_symbolic as sym_k
    one_launch = hasattr(acc_k, "fused_flop_symbolic_bitmask_buckets")
    for name, m in products(chosen(MATRICES)):
        rows = oracle.sample_rows(m.nrows, seed=0)
        floprc, _ = oracle.flop_per_row(m, m)
        host_z = oracle.exact_sampled_nnz(m, m, rows)
        ad = csr.to_device(m, device=dev)
        rnb = torch.diff(ad.rpt)
        rows_d = torch.from_numpy(rows.astype(np.int32)).to(dev)
        bp = binning.build_plan(m, m)
        calls = [dict(a=ad, b=ad, rows=torch.from_numpy(sub).to(dev),
                      max_deg_a=bk.deg_a, max_deg_b=bk.deg_b, span=bk.span,
                      rownnz_b=rnb)
                 for bk, sub in zip(bp.buckets, bp.subset(rows))
                 if bk.route != binning.ROUTE_ESC and sub.size]
        sel = np.concatenate([sub for bk, sub in zip(bp.buckets,
                                                     bp.subset(rows))
                              if bk.route != binning.ROUTE_ESC]
                             ) if calls else np.zeros(0, np.int64)
        want = (oracle.exact_sampled_nnz(m, m, sel),
                int(floprc[sel].sum())) if calls else (0, 0)
        seqs = []
        if calls:
            seqs.append(("per_bucket", len(calls), lambda: [
                acc_k.fused_flop_symbolic_bitmask(**kw) for kw in calls]))
            got = [acc_k.fused_flop_symbolic_bitmask(**kw) for kw in calls]
            agrees = (sum(int(g[0]) for g in got),
                      sum(int(g[1]) for g in got)) == want
            if one_launch:
                tabs = predictor.plan_tables(bp, dev)
                table = predictor.bitmask_sample_table(
                    bp, tabs, rows, floprc[rows], m.ncols, dev)
                seqs.append(("one_launch", 1, lambda: (
                    acc_k.fused_flop_symbolic_bitmask_buckets(
                        ad, ad, table, rownnz_b=rnb))))
                got = acc_k.fused_flop_symbolic_bitmask_buckets(
                    ad, ad, table, rownnz_b=rnb)
                agrees = agrees and (int(got[0]), int(got[1])) == want
        for how, n_calls, fn in seqs:
            own, every = profiled_ms(torch, fn, "bitmask", reps=5)
            host = host_ms(torch, fn)
            emit(dict(phase="bitmask_split", matrix=name, kernel=4, how=how,
                      calls=n_calls, samples=int(sel.size),
                      products=int(floprc[sel].sum()), agrees=agrees,
                      ms=cuda_ms(torch, fn), device_ms=own,
                      all_device_ms=every, host_ms=host,
                      host_ms_per_call=host / n_calls))
        # the whole count and prediction, floprC passed as the planner
        # passes it
        floprc_d = torch.from_numpy(floprc.astype(np.int32)).to(dev)
        z, f = predictor.binned_symbolic_counts(ad, ad, rows_d, bp,
                                                use_kernel=True,
                                                floprc=floprc_d)
        counts = lambda: predictor.binned_symbolic_counts(
            ad, ad, rows_d, bp, use_kernel=True, floprc=floprc_d)
        emit(dict(phase="bitmask_whole", matrix=name,
                  buckets=len(bp.buckets), bitmask_calls=len(calls),
                  samples=int(rows.size),
                  agrees=(int(z), int(f)) == (host_z,
                                              int(floprc[rows].sum())),
                  runs=WHOLE_RUNS,
                  binned_symbolic_counts_ms=synced_ms(torch, counts,
                                                      WHOLE_RUNS),
                  proposed_predict_binned_ms=synced_ms(
                      torch, lambda: predictor.proposed_predict_binned(
                          ad, ad, rows_d, bp, use_kernel=True,
                          floprc=floprc_d), WHOLE_RUNS)))
        if calls and name in ("band_60k_d16", "cant_like"):
            host_profile(torch, emit, name, [(
                "binned_symbolic_counts", "one_launch", "", counts, 1)])
        # kernel 8 at the global bounds, kernel 7 on the same rows
        da = int(m.row_nnz.max())
        kw = dict(a=ad, b=ad, rows=rows_d, max_deg_a=da, max_deg_b=da,
                  rownnz_b=rnb)
        fn8 = lambda: acc_k.bitmask_symbolic(**kw)
        got = fn8()
        hint = flop_k.flop_per_row(ad, rnb, max_deg_a=da)[rows_d.long()]
        fn7 = lambda: sym_k.sampled_symbolic(**kw, row_flop=hint)
        own, every = profiled_ms(torch, fn8, "bitmask", reps=5)
        emit(dict(phase="bitmask_global", matrix=name, kernel=8,
                  samples=int(rows.size), max_deg=da,
                  agrees=(int(got[0]), int(got[1])) == (
                      host_z, int(floprc[rows].sum())),
                  ms=cuda_ms(torch, fn8), device_ms=own,
                  all_device_ms=every, host_ms=host_ms(torch, fn8),
                  kernel7_ms=cuda_ms(torch, fn7),
                  kernel7_device_ms=profiled_ms(torch, fn7, "esc_symbolic",
                                                reps=5)[0]))
        if one_launch:
            # kernel 8's rows by the unit that takes them: its short rows
            # alone and its long rows alone (at the global bounds a row's
            # products are its FLOP), and every row on a block or on a warp
            # through a table of the same rows
            n_products = floprc[rows]
            warp_max = _build.BMS_WARP_MAX
            units = {}
            for unit, sel in (("short_rows", n_products <= warp_max),
                              ("long_rows", n_products > warp_max)):
                if sel.any():
                    sub = dict(kw, rows=rows_d[torch.from_numpy(sel).to(dev)])
                    units[unit] = profiled_ms(
                        torch, lambda: acc_k.bitmask_symbolic(**sub),
                        "bitmask", reps=5)[0]
            nw = acc_k._n_words(m.ncols, 0)
            short = n_products <= warp_max
            for unit, sel, flop in (
                    ("all_blocks", rows >= 0, np.full(rows.size, 1 << 30)),
                    ("all_warps", rows >= 0, np.ones(rows.size)),
                    ("short_rows_table", short, n_products),
                    ("long_rows_table", ~short, n_products)):
                if not sel.any():
                    continue
                k = int(sel.sum())
                t = acc_k.bitmask_table(rows[sel], np.full(k, da),
                                        np.full(k, da), np.full(k, nw),
                                        flop[sel], dev)
                units[unit] = profiled_ms(
                    torch, lambda: acc_k.fused_flop_symbolic_bitmask_buckets(
                        ad, ad, t, rownnz_b=rnb), "bitmask", reps=5)[0]
            emit(dict(phase="bitmask_units", matrix=name, kernel=8,
                      short_rows=int((n_products <= warp_max).sum()),
                      long_rows=int((n_products > warp_max).sum()),
                      device_ms=units))
        del ad, rnb, rows_d, calls, seqs, floprc_d, hint
        torch.cuda.empty_cache()


# chip_smoke.py's attention cases: (case, q shape, kv shape, dtype, causal)
ATTENTION_CASES = (
    ("G1", (4, 40, 4096, 128), (4, 8, 4096, 128), "bfloat16", True),
    ("G2", (1, 40, 4096, 128), (1, 8, 4096, 128), "float32", True),
    ("G3", (2, 32, 4096, 96), (2, 32, 4096, 96), "bfloat16", True),
    ("G4", (1, 40, 1024, 128), (1, 8, 4096, 128), "bfloat16", True),
    ("G4_full", (1, 40, 1024, 128), (1, 8, 4096, 128), "bfloat16", False),
    ("G5", (2, 32, 4096, 112), (2, 32, 4096, 112), "bfloat16", True))


def attention_splits(torch, dev, emit) -> None:
    """``--attention``: the flash kernel on each case, events and device
    time, beside SDPA; inputs standard normal from the case's seed, as
    chip_smoke.py makes them."""
    from repro_torch.kernels import ops as kops
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed, (case, sq, skv, dtype, causal) in enumerate(ATTENTION_CASES):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(s_, generator=gen, device=dev).to(
            getattr(torch, dtype)) for s_ in (sq, skv, skv))
        b, hq, n_q, d = sq
        n = min(n_q, skv[2])
        pairs = (n * (n + 1) // 2 + (n_q - n) * skv[2] if causal
                 else n_q * skv[2])
        ops = 4 * b * hq * d * pairs
        fn = lambda: kops.flash_attention(q, k, v, causal=causal)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
        ms = cuda_ms(torch, fn)
        _, device = profiled_ms(torch, fn, "")
        emit(dict(phase="attention_split", case=case, dtype=dtype,
                  causal=causal, ms=ms, device_ms=device,
                  tflop_per_s=ops / ms * 1e-9, sdpa_ms=cuda_ms(torch, sdpa),
                  operations=ops))
        del q, k, v
        torch.cuda.empty_cache()


def wide_products(np):
    """Kernel 7's products past the card's shared memory, as ``(name, A, B,
    sampled rows)``: ``pl20k_x_er4m``, a power-law A (20,000 rows, mean 16
    entries) by B of 4,000 rows of about 200 columns spread over 4 M, so a
    long row's bitmask of B's columns (125,000 words) does not fit shared
    memory, sampled at its seed-0 rows and its 32 widest; and
    ``er64_d40k_x_er5k``, 64 rows of about 33,000 entries, whose product
    prefix table alone does not fit, by B of 100,000 rows of about 2
    columns over 5,000, every row sampled."""
    from repro_torch.core import oracle
    from repro_torch.sparse import random as sprand
    a = sprand.power_law(20_000, 4_000, 16, 1.2, seed=1)
    rows = np.union1d(oracle.sample_rows(a.nrows, seed=0),
                      np.argsort(a.row_nnz)[-32:])
    yield ("pl20k_x_er4m", a, sprand.erdos_renyi(4_000, 4_000_000, 200,
                                                 seed=2), rows)
    a = sprand.erdos_renyi(64, 100_000, 40_000, seed=3)
    yield ("er64_d40k_x_er5k", a, sprand.erdos_renyi(100_000, 5_000, 2,
                                                     seed=4),
           np.arange(a.nrows))


def global_splits(torch, np, dev, emit) -> None:
    """``--global``: kernel 7 as the global-pad predictor calls it, on each
    predict product's seed-0 samples at the global bounds, then on the
    products of :func:`wide_products`; ``agrees`` holds its (z*, f*)
    against the plain version's."""
    from repro_torch.core import csr, oracle
    from repro_torch.kernels import flop_per_row as flop_k
    from repro_torch.kernels import spgemm_symbolic as sym_k
    from repro_torch.sparse import suite

    def squared():
        for name in PREDICT_MATRICES:
            m = suite.get_matrix(name)
            yield name, m, m, oracle.sample_rows(m.nrows, seed=0)
    for name, a, b, rows in (*squared(), *wide_products(np)):
        ad = csr.to_device(a, device=dev)
        bd = ad if b is a else csr.to_device(b, device=dev)
        rnb = torch.diff(bd.rpt)
        da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
        rows_d = torch.from_numpy(rows.astype(np.int32)).to(dev)
        hint = flop_k.flop_per_row(ad, rnb, max_deg_a=da)[rows_d.long()]
        fn = lambda: sym_k.sampled_symbolic(ad, bd, rows_d, max_deg_a=da,
                                            max_deg_b=db, rownnz_b=rnb,
                                            row_flop=hint)
        want = sym_k.sampled_symbolic_plain(ad, bd, rows_d, max_deg_a=da,
                                            max_deg_b=db, rownnz_b=rnb)
        agrees = [int(x) for x in fn()] == [int(x) for x in want]
        own, every = profiled_ms(torch, fn, "symbolic")
        emit(dict(phase="global_split", matrix=name, samples=int(rows.size),
                  max_deg=da, max_deg_b=db, agrees=agrees,
                  ms=cuda_ms(torch, fn), device_ms=own, all_device_ms=every,
                  host_ms=host_ms(torch, fn), synced_ms=synced_ms(torch, fn)))
        del ad, bd, rnb, rows_d, hint
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
