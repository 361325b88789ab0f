#!/usr/bin/env python3
"""Time the port's two main-path numeric kernels on one CUDA card, split by
each row's FLOP class: ESC numeric (kernel 3, ``csrc/esc_numeric.cu``) and
BIN numeric (kernel 6, ``csrc/bin_numeric.cu``).

Run from the repository root::

    python3 tools/numeric_splits.py [--src DIR] [--out FILE]

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
-Xptxas -v`` (registers, shared memory, spills) for both sources.  One JSON
object per line on stdout, and the same lines in ``--out``.
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


def ptxas(src_dir: str) -> list[str]:
    """``nvcc -Xptxas -v`` of the two numeric sources, compiled to cubin."""
    from repro_torch.kernels import _build
    csrc = os.path.join(src_dir, "repro_torch", "kernels", "csrc")
    lines = []
    out_dir = _build.BUILD_ROOT / "ptxas"     # ignored, like every build
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in ("esc_numeric", "bin_numeric"):
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
    args = ap.parse_args()
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
    from repro_torch.sparse import random as sprand
    from repro_torch.sparse import suite
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
        for ln in ptxas(os.path.abspath(args.src)):
            emit(dict(phase="ptxas", line=ln))
    takes_bound = "max_row_flop" in inspect.signature(
        num_k.spgemm_numeric).parameters

    mats = [(n, suite.get_matrix(n)) for n in MATRICES[:5]]
    mats += [("cant_like", sprand.banded(62_451, 62_451, 100, 50, seed=602)),
             ("webbase_like", sprand.power_law(1_000_005, 1_000_005, 4, 1.4,
                                               seed=601))]
    for name, m in mats:
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


if __name__ == "__main__":
    sys.exit(main())
