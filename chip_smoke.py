#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc``, at first use), then

1. drives the main path through its entry points, with every kernel's
   launch count set to 0 just before each call and read just after:
   (a) the paper's predictor, ``predictor.proposed_predict_binned(...,
       use_kernel=True)``, on five suite matrices squared: one launch of
       the FLOP kernel and one of the fused ESC symbolic kernel each;
   (b) ``plan.plan_spgemm(route="esc", use_kernel=True)`` → ``execute`` →
       ``reassemble`` on the same five and on two paper-scale analogues
       (SuiteSparse cant and webbase-1M sizes);
   (c) the same with the default ``route="auto"``, which puts the banded
       and FEM products on the SPA route and R-MAT's hub rows on BIN;
   (d) the paper's predictor at global degree bounds,
       ``predictor.proposed_predict`` and ``reference_predict`` with
       ``use_kernel=True``, on all seven products and (a)'s sampled rows,
       and ``ops.bitmask_symbolic`` on the same rows;
   (e) the quickstart flow at full size: ``AllocationPlan`` →
       ``spgemm.spgemm(use_kernel=True)`` on the seven products, and
       ``python -m repro_torch.quickstart`` once;
   (f) the paper's Section VI accuracy experiment,
       ``experiment.run_subset()``, 75 cases with their sampled counts on
       the card, held to the committed baseline's pinned limits;
   (g) blocked GQA flash attention, ``ops.flash_attention``, at
       qwen2.5-32b's and phi3-mini's attention widths over 4096 tokens,
       causal (top-left) and not, in bfloat16 (the tensor-core kernel) and
       float32 (the CUDA-core one), each launch counted under its kernel;
2. checks what came out: z*, f* and floprC against the plain versions on the
   card and the host oracles, ``row_nnz``/``col``/``val`` against the plain
   numeric phase of each bucket's route on the card and the exact
   structure; (g)'s outputs against the plain attention on the card;
   (c)'s plan, ``col``, ``row_nnz`` and ``overflow`` against
   (b)'s exactly (routes change no bucket, prediction or capacity); (d)'s
   counts and predicted nnz against (a)'s bit for bit; (e)'s ``row_nnz``
   against the exact structure and its output against the plain
   ``spgemm`` on the card; small products on every route against the
   dense oracle;
3. holds each kernel against its plain version at the path's shapes (the
   bitmask symbolic kernels also against the ESC ones on the same sampled
   rows; the one-launch FLOP and ESC symbolic entries also against the
   per-bucket kernels and the host oracles) and times both, with CUDA
   events (the SPA and all-rows FLOP kernels also by their profiler device
   time; the latter on ``cant_like``, ``webbase_like`` and ``pl_100k_d4``),
   beside the bound and a PyTorch yardstick (the BIN and symbolic
   kernels': ``torch.sparse.mm`` of their rows of A by B; attention's:
   ``scaled_dot_product_attention``, also through each of its backends);
   kernels 1 and 2 as one launch over a whole prediction, their
   per-bucket sequence beside it;
4. launches each numeric kernel twice on every bucket and holds ``val``
   bit for bit (ESC, SPA and BIN all add each column's products in a fixed
   order), SPA also on the reference phase's forced ``route="spa"`` plans,
   where each bucket is held to its plain version and to the ESC kernel.

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
BF16_FLOP_PER_S = 989e12         # H100 SXM bf16/fp16 tensor cores, dense
VAL_RTOL = 1e-5                  # run sums are taken in another order
VAL_ATOL_REL = 1e-6              # × the row's largest |value|
TIMED_RUNS = 5
SAFETY = 1.3
PREDICT_MATRICES = ("er_120k_d3", "pl_100k_d4", "rmat_80k", "band_60k_d16",
                    "fem_30k_d48")
# (e) holds the kernel's whole global-pad output against the plain spgemm
# where that expands at most this many product lanes on the card; wider
# products (power-law hubs at global bounds) compare their sampled and
# widest rows
PLAIN_GLOBAL_LANES = 1 << 31
WIDEST_ROWS = 64
BASELINE = os.path.join("artifacts", "accuracy_subset_baseline.json")
FLASH_SOURCES = dict(sm90="flash_attention_sm90.cu", simt="flash_attention.cu")
# kernels whose kernel_time lines also carry their profiler device time, by
# a part of their CUDA kernels' names
DEVICE_TIMED = dict(spa_numeric="spa_numeric", flop_per_row="flop_all_rows")
G1_ACCEPT_MS = 2.0     # the tensor-core redesign's acceptance bar on G1


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


def device_ms(torch, fn, pattern: str, reps: int = TIMED_RUNS):
    """Mean device milliseconds a run of ``fn`` spends in the kernels whose
    name holds ``pattern``, from torch.profiler over ``reps`` runs after a
    warm-up (None where the profiler sees no device time): beside the CUDA
    events it leaves out the host's time to issue the launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0)
                for e in prof.key_averages() if pattern in e.key)
    return total / 1e3 / reps if total else None


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


def bytes_flop_all(np, m, deg_a) -> int:
    """Algorithm 1 over all rows: the row pointers, A's column ids and the
    referenced B row lengths read, one int32 FLOP written per row."""
    ks, n_a = referenced(np, m, np.arange(m.nrows), deg_a)
    return 4 * (m.nrows + 1) + 4 * n_a + 4 * ks.size + 4 * m.nrows


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


def attention_work(q, k, causal) -> tuple[int, int]:
    """(operations, bytes) of one attention call: a multiply and an add per
    head-dim element in each of its two products, for every (query, visible
    key) pair of each head (top-left causal mask: query i sees keys j <= i);
    q, k and v read and the output written once."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    n = min(sq, sk)
    pairs = n * (n + 1) // 2 + (sq - n) * sk if causal else sq * sk
    return 4 * b * hq * d * pairs, (2 * q.numel() + 2 * k.numel()) * \
        q.element_size()


def sdpa_backends(torch, q, k, v, want, emit, attn) -> None:
    """Yardstick only: G1 through each SDPA backend that takes it with
    ``enable_gqa=True``, one line each (time, agreement with the plain
    version, its kernels' names from torch.profiler), then which backend
    the default call runs: the one whose kernels it launches.  A backend
    that refuses the shape says so in its line."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)

    def kernel_names():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        found = sorted(((e.device_time_total, e.key)
                        for e in prof.key_averages()
                        if e.device_time_total > 0), reverse=True)
        return [key for _, key in found[:4]]

    default = kernel_names()
    matches = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        line = dict(phase="sdpa_backend", case="G1", backend=backend.name)
        try:
            with sdpa_kernel(backend):
                got = call()
                line.update(accepted=True, ms=cuda_ms(torch, call),
                            max_abs_err=float(
                                (got.float() - want.float()).abs().max()),
                            kernels=kernel_names())
        except RuntimeError as exc:      # the backend does not take G1
            line.update(accepted=False, reason=str(exc).splitlines()[0])
        if default and line.get("kernels", [None])[:1] == default[:1]:
            matches.append(backend.name)
        emit(line)
    emit(dict(phase="sdpa_default", case="G1", kernels=default,
              matches=matches,
              flash_attention_tflop_per_s={c: a[3] for c, a in attn.items()},
              flash_attention_variant={c: a[2] for c, a in attn.items()}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.core import (binning, csr, experiment, oracle, plan,
                                  predictor, spgemm)
    from repro_torch.core import flop as flop_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import accumulator as acc_k
    from repro_torch.kernels import flash_attention as fa_k
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
               acc_k.spa_numeric, acc_k.bin_numeric, sym_k.sampled_symbolic,
               acc_k.bitmask_symbolic, flop_k.flop_per_row,
               fa_k.flash_attention, flop_k.flop_rows_buckets,
               sym_k.fused_flop_symbolic_buckets, fa_k.flash_attention_sm90,
               fa_k.flash_attention_simt)
    names = [k.__name__ for k in kernels]
    launches = {path: dict.fromkeys(names, 0)
                for path in ("predict", "plan_esc", "plan_auto",
                             "global_predict", "global_bitmask",
                             "global_spgemm", "experiment", "attention")}

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
    binned = {}         # matrix -> (a)'s binned prediction
    for name, m in mats[:len(PREDICT_MATRICES)]:
        binplan = binning.build_plan(m, m, route="esc")
        rows = oracle.sample_rows(m.nrows, seed=0)
        ad = csr.to_device(m, device=dev)
        rows_d = torch.from_numpy(rows.astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred, counts = drive("predict",
                             lambda: predictor.proposed_predict_binned(
                                 ad, ad, rows_d, binplan, use_kernel=True))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        # one launch of each kernel a prediction, none per bucket
        if (counts["flop_rows_buckets"], counts["fused_flop_symbolic_buckets"],
                counts["flop_rows"], counts["fused_flop_symbolic"]) \
                != (1, 1, 0, 0):
            fail(f"predict {name}: launches {counts}, not one of each")
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
        if (int(pred.sampled_nnz), int(pred.sampled_flop)) != (
                oracle.exact_sampled_nnz(m, m, rows),
                int(floprc_host[rows].sum())):
            fail(f"predict {name}: (z*, f*) != host oracle")
        nnzr_exact, nnz_exact = oracle.exact_structure(m, m)
        exact[name] = nnzr_exact
        emit(dict(phase="predict", matrix=name, rows=m.nrows, nnz=m.nnz,
                  buckets=len(binplan.buckets), samples=int(rows.size),
                  z_star=int(pred.sampled_nnz), f_star=int(pred.sampled_flop),
                  total_flop=int(pred.total_flop),
                  predicted_nnz=float(pred.nnz_total), exact_nnz=nnz_exact,
                  rel_err=(float(pred.nnz_total) - nnz_exact) / nnz_exact,
                  equals_host_oracle=True, launches=counts, seconds=secs))
        binned[name] = pred
        del ad, plain

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
    b_row_nnz = {}      # matrix -> (b)'s row_nnz
    for name, m in mats:
        # (b) every bucket on ESC: the prediction launches the fused ESC
        # symbolic kernel once (the plan passes floprC from the host)
        (p, out, c, secs), counts = drive("plan_esc",
                                          lambda: run_plan(m, "esc"))
        if (counts["fused_flop_symbolic_buckets"], counts["flop_rows_buckets"],
                counts["fused_flop_symbolic"]) != (1, 0, 0):
            fail(f"plan_execute {name}: launches {counts}, not one kernel-2 "
                 "launch")
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
        b_row_nnz[name] = row_nnz
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
                  launches=counts, **secs))
        del c

        # (c) the default route: same buckets, prediction and capacities,
        # so the same col, row_nnz and overflow as (b)
        (pa, outa, ca, secs), counts = drive("plan_auto",
                                             lambda: run_plan(m, "auto"))
        esc_buckets = [i for i, bk in enumerate(pa.binning.buckets)
                       if bk.route == binning.ROUTE_ESC]
        auto_runs[name] = (pa.binning.route_rows(), counts, int(np.isin(
            pa.binning.row_bucket[pa.sample_rows], esc_buckets).sum()))
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

    # ---- (d) the paper's predictor at global bounds: one pad, no buckets,
    # on (a)'s sampled rows; its integers and nnz equal (a)'s bit for bit
    global_structure = {}   # matrix -> (d)'s predicted structure (host)
    for name, m in mats:
        rows = oracle.sample_rows(m.nrows, seed=0)
        ad = csr.to_device(m, device=dev)
        rows_d = torch.from_numpy(rows.astype(np.int32)).to(dev)
        da = int(m.row_nnz.max())
        binplan = binning.build_plan(m, m, route="esc")
        if name not in binned:      # the analogues: (a) ran on the suite
            binned[name] = predictor.proposed_predict_binned(
                ad, ad, rows_d, binplan, use_kernel=True)
        want = binned[name]
        want_ref = predictor.reference_predict_binned(ad, ad, rows_d, binplan,
                                                      use_kernel=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        (pred, ref), counts = drive("global_predict", lambda: (
            predictor.proposed_predict(ad, ad, rows_d, da, da,
                                       use_kernel=True),
            predictor.reference_predict(ad, ad, rows_d, da, da,
                                        use_kernel=True)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        floprc_host, total_host = oracle.flop_per_row(m, m)
        host = (oracle.exact_sampled_nnz(m, m, rows),
                int(floprc_host[rows].sum()), total_host)
        for p_, w_ in ((pred, want), (ref, want_ref)):
            got = (int(p_.sampled_nnz), int(p_.sampled_flop),
                   int(p_.total_flop))
            if got != host or got != (int(w_.sampled_nnz),
                                      int(w_.sampled_flop),
                                      int(w_.total_flop)):
                fail(f"global_predict {name}: (z*, f*, F) {got} != binned "
                     f"or host oracle {host}")
            if not all(torch.equal(getattr(p_, k), getattr(w_, k)) for k in
                       ("nnz_total", "compression_ratio", "structure")):
                fail(f"global_predict {name}: prediction != the binned one")
        # floprC exactly: the structure is floprC / r* in float32
        if not torch.equal(pred.structure, torch.from_numpy(
                floprc_host.astype(np.float32)).to(dev)
                / pred.compression_ratio):
            fail(f"global_predict {name}: floprC != host oracle")
        if counts["sampled_symbolic"] <= 0 or counts["flop_per_row"] <= 0:
            fail(f"global_predict {name}: kernels 7 and 9 not launched")
        (zb, fb), bcounts = drive("global_bitmask", lambda: kops.bitmask_symbolic(
            ad, ad, rows_d, da, da))
        if (int(zb), int(fb)) != host[:2] or bcounts["bitmask_symbolic"] <= 0:
            fail(f"global_bitmask {name}: (z*, f*) != host oracle or kernel "
                 "8 not launched")
        global_structure[name] = pred.structure.cpu().numpy()
        nnz_exact = int(exact[name].sum()) if name in exact else None
        emit(dict(phase="global_predict", matrix=name, samples=int(rows.size),
                  max_deg=da, z_star=host[0], f_star=host[1],
                  total_flop=total_host,
                  predicted_nnz=float(pred.nnz_total),
                  reference_nnz=float(ref.nnz_total), exact_nnz=nnz_exact,
                  rel_err=(None if nnz_exact is None else
                           (float(pred.nnz_total) - nnz_exact) / nnz_exact),
                  equals_binned=True, equals_host_oracle=True,
                  launches=counts, bitmask_launches=bcounts, seconds=secs))
        del ad, pred, ref, want_ref

    # ---- (e) the quickstart flow at full size: one global capacity from
    # the global prediction, all rows through the ESC numeric kernel at
    # global bounds
    for name, m in mats:
        ad = csr.to_device(m, device=dev)
        da = int(m.row_nnz.max())
        floprc_host, _ = oracle.flop_per_row(m, m)
        alloc = predictor.AllocationPlan.from_prediction(
            global_structure[name], floprc_host, safety=SAFETY)
        kw = dict(row_capacity=alloc.row_capacity, max_deg_a=da,
                  max_deg_b=da)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out, counts = drive("global_spgemm", lambda: spgemm.spgemm(
            ad, ad, use_kernel=True, **kw))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        row_nnz = out.row_nnz.cpu().numpy()
        # the exact structure where (a) computed it, else (b)'s row_nnz,
        # which equals each bucket's plain numeric phase
        want_nnz = exact.get(name, b_row_nnz[name])
        overflow = int(out.overflow)
        if (not np.array_equal(row_nnz, want_nnz) or overflow != int(
                np.maximum(row_nnz - alloc.row_capacity, 0).sum())
                or not bool(torch.isfinite(out.val).all())
                or counts["spgemm_numeric"] <= 0):
            fail(f"global_spgemm {name}: row_nnz, overflow or values wrong")
        if m.nrows * da * da <= PLAIN_GLOBAL_LANES:
            chk = np.arange(m.nrows)
        else:
            chk = np.union1d(oracle.sample_rows(m.nrows, seed=0),
                             np.argsort(m.row_nnz)[-WIDEST_ROWS:])
        chk_d = torch.from_numpy(chk.astype(np.int32)).to(dev)
        want = spgemm.spgemm_rows(ad, ad, chk_d, **kw)
        rl = chk_d.long()
        got_v = out.val[rl]
        if not (torch.equal(out.col[rl], want.col)
                and torch.equal(out.row_nnz[rl], want.row_nnz)
                and vals_close(got_v, want.val)):
            fail(f"global_spgemm {name}: kernel != plain spgemm")
        num_err["spgemm_numeric"] = max(num_err["spgemm_numeric"],
                                        float((got_v - want.val).abs().max()))
        emit(dict(phase="global_spgemm", matrix=name, rows=m.nrows,
                  max_deg=da, row_capacity=alloc.row_capacity,
                  upper_bound_capacity=int(floprc_host.max()),
                  nnz_c=int(row_nnz.sum()), overflow=overflow, safety=SAFETY,
                  row_nnz_equals=("exact" if name in exact else "plan_esc"),
                  plain_rows_compared=int(chk.size), seconds=secs,
                  peak_bytes=peak, launches=counts))
        del ad, out, want, got_v
        torch.cuda.empty_cache()
    t = time.perf_counter()
    qs = subprocess.run(
        [sys.executable, "-m", "repro_torch.quickstart"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=600)
    lines = qs.stdout.strip().splitlines()
    if qs.returncode != 0 or not lines or not lines[-1].startswith("OK"):
        fail(f"quickstart exited {qs.returncode}:\n{qs.stdout}\n{qs.stderr}")
    emit(dict(phase="quickstart", seconds=time.perf_counter() - t,
              output=lines))

    # ---- (f) the paper's accuracy experiment: the 75-case subset, z*, f*
    # and F of every case from the card, each held to the host oracle; the
    # card's share of the time (upload, kernels 9 and 7, the read-back) is
    # measured apart from the host's (exact structure, k-min-hash)
    seen = []
    card_counts = experiment.sampled_counts

    def recorded(a, b, rows, device=None):
        t = time.perf_counter()
        got = card_counts(a, b, rows, device)      # ints: synchronised
        seen.append((a, b, rows, got, time.perf_counter() - t))
        return got

    experiment.sampled_counts = recorded
    t = time.perf_counter()
    try:
        res, counts = drive("experiment",
                            lambda: experiment.run_subset(device=dev))
    finally:
        experiment.sampled_counts = card_counts
    secs = time.perf_counter() - t
    if len(seen) != len(res["cases"]):
        fail("experiment: not every case took its counts from the card")
    card_secs = sum(x[4] for x in seen)
    for (a, b, rows, got, _), case in zip(seen, res["cases"]):
        floprc_host, total_host = oracle.flop_per_row(a, b)
        host = (oracle.exact_sampled_nnz(a, b, rows),
                int(floprc_host[rows].sum()), total_host)
        if got != host or case["flop"] != total_host:
            fail(f"experiment {case['A']}x{case['B']}: (z*, f*, F) {got} "
                 f"!= host oracle {host}")
    with open(os.path.join(ROOT, BASELINE)) as f:
        baseline = json.load(f)
    agg, pin = res["aggregate"], baseline["pinned"]
    if not (agg["n_cases"] == 75
            and agg["mean_abs_e2"] <= pin["max_mean_abs_e2"]
            and agg["worst_abs_e2"] <= pin["max_worst_abs_e2"]
            and agg["mean_abs_e2"] < agg["mean_abs_e1"]
            and counts["sampled_symbolic"] > 0
            and counts["flop_per_row"] > 0):
        fail(f"experiment: aggregate {agg} outside the pinned limits {pin}")
    keys = ("mean_abs_e1", "worst_abs_e1", "mean_abs_e2", "worst_abs_e2",
            "mean_abs_e3", "worst_abs_e3", "proposed_better_frac",
            "corr_e1_ef", "max_eq5_resid")
    emit(dict(phase="experiment", cases=agg["n_cases"], seconds=secs,
              card_seconds=card_secs, host_seconds=secs - card_secs,
              counts_equal_host_oracle=True, launches=counts,
              aggregate={k: agg[k] for k in keys},
              baseline={k: baseline["aggregate"][k] for k in keys},
              pinned=pin))

    # ---- (g) blocked GQA flash attention at two model configs' attention
    # widths, from src/repro/configs: qwen2_5_32b.py (d_model 5120, 40
    # heads, 8 kv heads: D 128, groups of 5) and phi3_mini.py (d_model
    # 3072, 32 heads and kv heads: D 96), over launch/specs.py's train_4k
    # sequence of 4096 tokens, its batch of 256 cut to 4, 2 and 1; G4
    # attends 1024 queries over 4096 keys (top-left causal mask).  Inputs
    # are standard normal from a seed, made on the card.
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 in fp32
    attn = {}           # case -> (max abs error against plain, kernel ms,
    #                     variant, TFLOP/s)
    timed_attn = {}     # G1, G2 -> (q, k, v, plain output, causal)
    for case, shape_q, shape_kv, dtype, causal in (
            ("G1", (4, 40, 4096, 128), (4, 8, 4096, 128), torch.bfloat16,
             True),
            ("G2", (1, 40, 4096, 128), (1, 8, 4096, 128), torch.float32,
             True),
            ("G3", (2, 32, 4096, 96), (2, 32, 4096, 96), torch.bfloat16,
             True),
            ("G4", (1, 40, 1024, 128), (1, 8, 4096, 128), torch.bfloat16,
             True),
            ("G4_full", (1, 40, 1024, 128), (1, 8, 4096, 128),
             torch.bfloat16, False)):
        gen = torch.Generator(device=dev).manual_seed(len(attn))
        q, k, v = (torch.randn(s_, generator=gen, device=dev).to(dtype)
                   for s_ in (shape_q, shape_kv, shape_kv))
        # the kernel follows from dtype and head dim: G2 (float32) on the
        # CUDA cores, the 16-bit cases on the tensor cores
        variant = fa_k.variant(dtype, shape_q[3])
        kernel, other = (f"flash_attention_{x}" for x in (
            variant, "simt" if variant == "sm90" else "sm90"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, counts = drive("attention", lambda: kops.flash_attention(
            q, k, v, causal=causal))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        want = fa_k.flash_attention_plain(q, k, v, causal=causal)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        err = float((out.float() - want.float()).abs().max())
        if ((counts["flash_attention"], counts[kernel], counts[other])
                != (1, 1, 0) or out.shape != q.shape
                or out.dtype != dtype or not bool(out.isfinite().all())
                or (dtype == torch.float32 and err > tol)
                or not torch.allclose(out.float(), want.float(), rtol=tol,
                                      atol=tol)):
            fail(f"attention {case}: kernel != plain (max abs {err}) or "
                 f"not launched once on {kernel} ({counts})")
        ms = cuda_ms(torch, lambda: fa_k.flash_attention(q, k, v,
                                                         causal=causal))
        ops, nbytes = attention_work(q, k, causal)
        attn[case] = (err, ms, variant, ops / ms * 1e-9)
        if case in ("G1", "G2"):    # beside the plain version and SDPA
            timed_attn[case] = (q, k, v, want, causal)
        emit(dict(phase="attention", case=case, variant=variant,
                  kernel=kernel, q=list(shape_q), kv=list(shape_kv),
                  dtype=str(dtype).split(".")[-1], causal=causal,
                  max_abs_err=err, tolerance=tol, seconds=secs, kernel_ms=ms,
                  operations=ops, bytes=nbytes,
                  tflop_per_s=ops / ms * 1e-9, launches=counts))
        del q, k, v, out
    torch.cuda.empty_cache()

    predictions = dict(predict=len(PREDICT_MATRICES), plan_esc=len(mats),
                       plan_auto=len(mats))
    emit(dict(phase="main_path_launches", predictions=predictions,
              **launches))
    # plan_spgemm takes floprC from the host, so the FLOP kernel (1) runs on
    # path (a) only: once a prediction; the fused ESC symbolic kernel (2)
    # once a prediction on (a) and (b), and never per bucket
    one_each = (("predict", "flop_rows_buckets"),
                ("predict", "fused_flop_symbolic_buckets"),
                ("plan_esc", "fused_flop_symbolic_buckets"))
    for path, k in one_each:
        if launches[path][k] != predictions[path]:
            fail(f"kernel {k} launched {launches[path][k]} times on main "
                 f"path {path}, not once for each of {predictions[path]} "
                 "predictions")
    for path in ("predict", "plan_esc", "plan_auto"):
        if (launches[path]["flop_rows"]
                or launches[path]["fused_flop_symbolic"]):
            fail(f"a per-bucket kernel-1 or kernel-2 launch on path {path}")
    # kernel 7 runs on kernel 2's body, but counts as itself: one launch a
    # global-pad prediction (proposed and reference on each product, one a
    # case of the experiment), and no kernel-2 launch on those paths
    for path, want in (("global_predict", 2 * len(mats)),
                       ("experiment", 75)):
        got = tuple(launches[path][k] for k in (
            "sampled_symbolic", "fused_flop_symbolic",
            "fused_flop_symbolic_buckets"))
        if got != (want, 0, 0):
            fail(f"path {path}: launches of kernels 7, 2 (per bucket, one "
                 f"launch) {got}, not ({want}, 0, 0)")
    for path, kinds in (("plan_esc", ("spgemm_numeric",)),
                        ("plan_auto", ("fused_flop_symbolic_bitmask",
                                       "spa_numeric", "bin_numeric")),
                        ("global_predict", ("sampled_symbolic",
                                            "flop_per_row")),
                        ("global_bitmask", ("bitmask_symbolic",)),
                        ("global_spgemm", ("spgemm_numeric",)),
                        ("experiment", ("sampled_symbolic", "flop_per_row")),
                        ("attention", ("flash_attention",
                                       "flash_attention_sm90",
                                       "flash_attention_simt"))):
        for k in kinds:
            if launches[path][k] <= 0:
                fail(f"kernel {k} was not launched on main path {path}")
    for name, (routes, counts, esc_samples) in auto_runs.items():
        for route, k in ((binning.ROUTE_SPA, "spa_numeric"),
                         (binning.ROUTE_BIN, "bin_numeric")):
            if routes[route] and counts[k] <= 0:
                fail(f"plan_auto {name}: {route} buckets but no {k} launch")
        # one kernel-2 launch when a sampled row lands in an ESC bucket, and
        # no launch at all when none does
        if counts["fused_flop_symbolic_buckets"] != int(esc_samples > 0):
            fail(f"plan_auto {name}: {counts['fused_flop_symbolic_buckets']}"
                 f" kernel-2 launches for {esc_samples} ESC samples")

    # ---- small products on every route against the dense oracle -------- #
    minis = suite.mini_suite(scale=200)
    forced_spa = []     # (matrix, kwargs) of each forced-SPA bucket
    for route in ("esc", "spa", "bin", "auto"):
        for name, m in minis:
            p = plan.plan_spgemm(m, m, route=route, use_kernel=True,
                                 device=dev)
            if route != "auto" and p.binning.route_rows()[route] != m.nrows:
                fail(f"reference {name}: route {route} not forced")
            if route == "spa":
                ad = p.to_device(m, "a")
                forced_spa += [(name, dict(
                    a=ad, b=ad, rows=torch.from_numpy(bk.rows).to(dev),
                    max_deg_a=bk.deg_a, max_deg_b=bk.deg_b, row_capacity=cap,
                    tile_n=bk.tile_n, n_tiles=bk.n_tiles))
                    for bk, cap in zip(p.binning.buckets,
                                       p.alloc.bucket_capacities)]
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
                   fused_flop_symbolic_bitmask=0, sampled_symbolic=0,
                   bitmask_symbolic=0, flop_per_row=0)
    calls = {}          # (kernel, matrix) -> [(kwargs, host rows, ...), ...]
    one_launch = {}     # (kernel, matrix) -> (entry, kwargs, plain version)
    esc_samples_of = {}  # matrix -> (kernel 2's sampled rows, host z*)
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
        # kernels 1 and 2 as the predictor launches them, once over the
        # whole prediction: against their plain versions, the per-bucket
        # launches above and the host oracles
        tabs = predictor.plan_tables(binplan, ad.rpt.device)
        kw = dict(a=ad, rownnz_b=rnb, tables=tabs.flop)
        got = flop_k.flop_rows_buckets(**kw)
        want = flop_k.flop_rows_buckets_plain(**kw)
        per_bucket = torch.cat([flop_k.flop_rows(**c[0]) for c in fc])[
            torch.from_numpy(binplan.inverse_perm()).to(dev)]
        if not (torch.equal(got, want) and torch.equal(got, per_bucket)
                and np.array_equal(got.cpu().numpy(), floprc_host)):
            fail(f"flop_rows_buckets {name}: kernel != plain/per-bucket/host")
        int_err["flop_rows"] = max(int_err["flop_rows"],
                                   int((got - want).abs().max()))
        one_launch["flop_rows", name] = (flop_k.flop_rows_buckets, kw,
                                         flop_k.flop_rows_buckets_plain)
        table = predictor.esc_sample_table(binplan, tabs, rows,
                                           floprc_host[rows], ad.rpt.device)
        kw = dict(a=ad, b=ad, table=table, rownnz_b=rnb)
        got = sym_k.fused_flop_symbolic_buckets(**kw)
        want = sym_k.fused_flop_symbolic_buckets_plain(**kw)
        host = (oracle.exact_sampled_nnz(m, m, rows),
                int(floprc_host[rows].sum()))
        per_bucket = [sym_k.fused_flop_symbolic(**c[0]) for c in sc]
        err = max(abs(int(got[0]) - int(want[0])),
                  abs(int(got[1]) - int(want[1])),
                  int((got[2] - want[2]).abs().max()))
        if (err or (int(got[0]), int(got[1])) != host
                or (sum(int(x[0]) for x in per_bucket),
                    sum(int(x[1]) for x in per_bucket)) != host
                or not np.array_equal(got[2].cpu().numpy(),
                                      floprc_host[rows])):
            fail(f"fused_flop_symbolic_buckets {name}: kernel != plain/"
                 "per-bucket/host oracle")
        int_err["fused_flop_symbolic"] = max(
            int_err["fused_flop_symbolic"], err)
        one_launch["fused_flop_symbolic", name] = (
            sym_k.fused_flop_symbolic_buckets, kw,
            sym_k.fused_flop_symbolic_buckets_plain)
        esc_samples_of[name] = (table.samples[0].cpu().numpy(), host[0])
        # a FLOP below the rows' products (1 a row) sizes every workspace
        # too small: each row then counts in the spill bitmask, exactly
        low = predictor.esc_sample_table(binplan, tabs, rows,
                                         np.ones(rows.size, np.int64),
                                         ad.rpt.device)
        got = sym_k.fused_flop_symbolic_buckets(a=ad, b=ad, table=low,
                                                rownnz_b=rnb)
        if ((int(got[0]), int(got[1])) != host
                or not np.array_equal(got[2].cpu().numpy(),
                                      floprc_host[rows])):
            fail(f"fused_flop_symbolic_buckets {name}: rows past their "
                 "bound != host oracle")
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
    # kernels 7-9 at (d)'s global-pad shapes: kernel 9 over all rows at the
    # global max_deg_a, kernels 7 and 8 over (a)'s sampled rows, against
    # their plain versions, the host oracles and each other, and kernel 7
    # against the fused ESC kernel (kernel 2) on the same rows at the same
    # bounds; the contract line times 7 and 8 on R-MAT's rows, 9 on cant's
    # (9 is also timed on webbase's and pl's, the skewed products)
    for name, m in mats:
        rows = oracle.sample_rows(m.nrows, seed=0)
        ad = csr.to_device(m, device=dev)
        rnb = torch.diff(ad.rpt)
        da = int(m.row_nnz.max())
        floprc_host, _ = oracle.flop_per_row(m, m)
        kw9 = dict(a=ad, rownnz_b=rnb, max_deg_a=da)
        fl = flop_k.flop_per_row(**kw9)
        err = int((fl - flop_k.flop_per_row_plain(**kw9)).abs().max())
        if err or not np.array_equal(fl.cpu().numpy(), floprc_host):
            fail(f"flop_per_row {name}: kernel != plain/host")
        int_err["flop_per_row"] = max(int_err["flop_per_row"], err)
        rows_d = torch.from_numpy(rows.astype(np.int32)).to(dev)
        kw = dict(a=ad, b=ad, rows=rows_d, max_deg_a=da, max_deg_b=da,
                  rownnz_b=rnb)
        hint = fl[rows_d.long()]
        host = (oracle.exact_sampled_nnz(m, m, rows),
                int(floprc_host[rows].sum()))
        got7 = sym_k.sampled_symbolic(**kw, row_flop=hint)
        got8 = acc_k.bitmask_symbolic(**kw)
        for k, got, others in (
                ("sampled_symbolic", got7,
                 (sym_k.sampled_symbolic_plain(**kw),
                  sym_k.sampled_symbolic(**kw),
                  sym_k.fused_flop_symbolic(**kw)[:2])),
                ("bitmask_symbolic", got8,
                 (acc_k.bitmask_symbolic_plain(**kw), got7))):
            got = (int(got[0]), int(got[1]))
            err = max(max(abs(g - int(w)) for g, w in zip(got, want))
                      for want in others)
            if err or got != host:
                fail(f"{k} {name}: kernel != plain/ESC kernel/host oracle")
            int_err[k] = max(int_err[k], err)
        if name in ("cant_like", "webbase_like", "pl_100k_d4"):
            calls["flop_per_row", name] = [(kw9, None, da, None)]
        if name == "rmat_80k":
            calls["sampled_symbolic", name] = [
                (dict(kw, row_flop=hint), rows, da, da)]
            calls["bitmask_symbolic", name] = [(kw, rows, da, da)]
        del ad, fl, hint
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
        rnb = torch.diff(ad.rpt)    # once an execute, as the executor does
        for bk, cap, bound in zip(p.binning.buckets,
                                  p.alloc.bucket_capacities,
                                  p.flop_bounds()):
            kw = dict(a=ad, b=ad, rows=torch.from_numpy(bk.rows).to(dev),
                      max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
                      row_capacity=cap, rownnz_b=rnb)
            # ESC and BIN size their workspaces by the plan's FLOP bound,
            # as the main path passes it
            call = (dict(kw, max_row_flop=bound), bk.rows, bk.deg_a,
                    bk.deg_b, cap)
            calls.setdefault(("spgemm_numeric", name), []).append(call)
            if bk.route == binning.ROUTE_SPA:
                calls.setdefault(("spa_numeric", name), []).append(
                    (dict(kw, tile_n=bk.tile_n, n_tiles=bk.n_tiles),
                     *call[1:]))
            elif bk.route == binning.ROUTE_BIN:
                calls.setdefault(("bin_numeric", name), []).append(
                    (dict(call[0], tile_n=bk.tile_n, n_tiles=bk.n_tiles),
                     *call[1:]))

    # ---- determinism: each numeric kernel twice on every bucket, val
    # compared bit for bit; all three add each column's products in a fixed
    # order and fail on a difference.  SPA also on the forced route="spa"
    # plans of the reference phase, each bucket held there to its plain
    # version and to the ESC kernel too
    same = {k: [0, 0] for k in ("spgemm_numeric", "spa_numeric",
                                "bin_numeric", "spa_numeric_forced")}

    def twice(kernel, fn, kw, what):
        first, second = fn(**kw), fn(**kw)
        if not (torch.equal(first[0], second[0])
                and torch.equal(first[1].view(torch.int32),
                                second[1].view(torch.int32))
                and torch.equal(first[2], second[2])):
            fail(f"determinism {kernel} {what}: differs between two launches")
        same[kernel][0] += 1
        same[kernel][1] += 1
        return first

    for (kernel, name), cs in calls.items():
        if kernel not in same:
            continue
        fn = dict(spgemm_numeric=num_k.spgemm_numeric,
                  spa_numeric=acc_k.spa_numeric,
                  bin_numeric=acc_k.bin_numeric)[kernel]
        for c in cs:
            twice(kernel, fn, c[0], f"{name} on a bucket of width "
                  f"{c[2]}x{c[3]}")
    for name, kw in forced_spa:
        got = twice("spa_numeric_forced", acc_k.spa_numeric, kw,
                    f"{name} (forced SPA) on a bucket of width "
                    f"{kw['max_deg_a']}x{kw['max_deg_b']}")
        esc_kw = {k: v for k, v in kw.items() if k not in ("tile_n",
                                                           "n_tiles")}
        for want in (acc_k.spa_numeric_plain(**kw),
                     num_k.spgemm_numeric(**esc_kw)):
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[2], want[2])
                    and int(got[3]) == int(want[3])
                    and vals_close(got[1], want[1])):
                fail(f"forced SPA {name}: kernel != plain/ESC kernel on a "
                     f"bucket of width {kw['max_deg_a']}x{kw['max_deg_b']}")
    emit(dict(phase="determinism", **{
        k: dict(buckets=n, bitwise_equal=eq) for k, (n, eq) in same.items()}))

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
                     "accumulator.py:387"),
                 "sampled_symbolic": (
                     sym_k.sampled_symbolic, sym_k.sampled_symbolic_plain,
                     sym_k.fused_flop_symbolic, "esc_symbolic.cu",
                     "spgemm_symbolic.py:142"),
                 "bitmask_symbolic": (
                     acc_k.bitmask_symbolic, acc_k.bitmask_symbolic_plain,
                     sym_k.sampled_symbolic, "bitmask_symbolic.cu",
                     "accumulator.py:223"),
                 "flop_per_row": (
                     flop_k.flop_per_row, flop_k.flop_per_row_plain, None,
                     "flop_rows.cu", "flop_per_row.py:39")}
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

    def library_flop_ms(name, rows):
        """Yardstick only: Algorithm 1 for ``rows`` as one cuSPARSE product
        of those A rows' pattern (values 1.0) by B's row lengths as float32,
        exact below 2^24.  The rows' pattern is built before the timed
        call."""
        m = dict(mats)[name]
        deg = np.diff(m.rpt)[rows]
        rpt = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        idx = np.repeat(m.rpt[rows] - rpt[:-1], deg) + np.arange(rpt[-1])
        pattern = torch.sparse_csr_tensor(
            torch.from_numpy(rpt).to(dev),
            torch.from_numpy(m.col[idx].astype(np.int64)).to(dev),
            torch.ones(int(rpt[-1]), dtype=torch.float32, device=dev),
            size=(rows.size, m.ncols))
        lengths = torch.from_numpy(np.diff(m.rpt).astype(np.float32)).to(
            dev)[:, None]
        got = torch.sparse.mm(pattern, lengths)[:, 0]
        if not np.array_equal(got.cpu().numpy(),
                              oracle.flop_per_row(m, m)[0][rows]):
            fail(f"library FLOP {name}: != host oracle")
        return cuda_ms(torch, lambda: torch.sparse.mm(pattern, lengths))

    def library_rows_ms(name, rows, ones=False):
        """Yardstick only: one cuSPARSE product of those rows of A (its
        pattern and values, built before the timed call) by B, checked
        against the rows' exact nnz; with ``ones`` every value is 1, so no
        sum cancels (the symbolic kernels' yardstick: the product's row
        nnz are the rows' z)."""
        m = dict(mats)[name]
        val = np.ones_like(m.val) if ones else m.val
        deg = np.diff(m.rpt)[rows]
        rpt = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        idx = np.repeat(m.rpt[rows] - rpt[:-1], deg) + np.arange(rpt[-1])
        a_rows = torch.sparse_csr_tensor(
            torch.from_numpy(rpt).to(dev),
            torch.from_numpy(m.col[idx].astype(np.int64)).to(dev),
            torch.from_numpy(val[idx]).to(dev), size=(rows.size, m.ncols))
        b_sp = torch.sparse_csr_tensor(
            torch.from_numpy(m.rpt).to(dev),
            torch.from_numpy(m.col.astype(np.int64)).to(dev),
            torch.from_numpy(val).to(dev), size=m.shape)
        got = torch.sparse.mm(a_rows, b_sp)
        if not np.array_equal(torch.diff(got.crow_indices()).cpu().numpy(),
                              b_row_nnz[name][rows]):
            fail(f"library rows {name}: row nnz != the ESC run's")
        return cuda_ms(torch, lambda: torch.sparse.mm(a_rows, b_sp))

    def entry(kernel, name):
        fn, plain_fn, esc_fn, source, replaces = kernel_of[kernel]
        cs = calls[kernel, name]
        m = dict(mats)[name]
        extra, device = {}, {}
        if (kernel, name) in one_launch:
            # one launch over the whole prediction, its tables already on
            # the card, and the per-bucket launches beside it
            fn1, kw1, plain1 = one_launch[kernel, name]
            ms = cuda_ms(torch, lambda: fn1(**kw1))
            plain_ms = cuda_ms(torch, lambda: plain1(**kw1))
            extra = dict(entry=fn1.__name__, per_bucket_calls=len(cs),
                         per_bucket_ms=cuda_ms(
                             torch, lambda: [fn(**c[0]) for c in cs]))
        else:
            ms = cuda_ms(torch, lambda: [fn(**c[0]) for c in cs])
            if kernel in DEVICE_TIMED:
                device[kernel] = device_ms(
                    torch, lambda: [fn(**c[0]) for c in cs],
                    DEVICE_TIMED[kernel])
            # the workspace hint is the kernel's own: the plain versions
            # and the fused ESC kernel take none
            plain_kw = [{k: v for k, v in c[0].items()
                         if k not in ("row_flop", "max_row_flop") and not (
                             k == "rownnz_b" and kernel.endswith("numeric"))}
                        for c in cs]
            plain_ms = cuda_ms(torch,
                               lambda: [plain_fn(**kw) for kw in plain_kw])
        esc_ms = None
        if esc_fn is not None:
            # the ESC kernel on the same rows, at the same bounds
            esc_kw = [{k: v for k, v in c[0].items()
                       if k not in ("span", "tile_n", "n_tiles", "row_flop")}
                      for c in cs]
            if esc_fn is num_k.spgemm_numeric:
                for kw, c in zip(esc_kw, cs):
                    kw["max_row_flop"] = int(floprc[name][c[1]].max())
            esc_ms = cuda_ms(torch, lambda: [esc_fn(**kw) for kw in esc_kw])
        ops = 0
        lib_ms = None
        if kernel == "flop_rows":
            nbytes = sum(bytes_flop_rows(np, m, c[1], c[2]) for c in cs)
            lib_ms = library_flop_ms(name,
                                     np.concatenate([c[1] for c in cs]))
        elif kernel == "flop_per_row":
            nbytes = sum(bytes_flop_all(np, m, c[2]) for c in cs)
            lib_ms = library_flop_ms(name, np.arange(m.nrows))
        elif "symbolic" in kernel:
            nbytes = sum(bytes_symbolic(np, m, c[1], c[2], c[3]) for c in cs)
            if kernel == "fused_flop_symbolic":
                # the sampled rows' product, whose row nnz sum to z*
                esc_rows, z_host = esc_samples_of[name]
                if int(b_row_nnz[name][esc_rows].sum()) != z_host:
                    fail(f"library rows {name}: sum != host z*")
                lib_ms = library_rows_ms(name, esc_rows)
            else:
                # kernels 4, 7 and 8: their sampled rows' product by B
                lib_ms = library_rows_ms(
                    name, np.concatenate([c[1] for c in cs]), ones=True)
        else:
            nbytes = sum(bytes_numeric(np, m, *c[1:]) for c in cs)
            ops = sum(numeric_ops(floprc[name], c[1]) for c in cs)
            if kernel == "bin_numeric":
                lib_ms = library_rows_ms(name,
                                         np.concatenate([c[1] for c in cs]))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOP_PER_S * 1e3
        numeric = kernel.endswith("numeric")
        return dict(name=kernel, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=f"src/repro/kernels/{replaces}",
                    launches=sum(launches[p][kernel]
                                 + launches[p].get(f"{kernel}_buckets", 0)
                                 for p in launches),
                    max_abs_err=float(int_err.get(kernel,
                                                  num_err.get(kernel))),
                    ms=ms, plain_ms=plain_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=(lib_ms if lib_ms is not None or not numeric
                                else library_ms(name)),
                    esc_ms=esc_ms, timed_on=name,
                    calls=1 if extra else len(cs), bytes=nbytes,
                    operations=ops,
                    **({"device_ms": device[kernel]} if device else {}),
                    **extra)

    # every (kernel, matrix) timing gets its own line; the contract line
    # takes one matrix per kernel: the power-law predict input for the ESC
    # predict kernels (one launch over the prediction), the cant-sized FEM
    # product for the ESC numeric, the fused bitmask symbolic, the SPA and
    # the all-rows FLOP kernels, R-MAT's hub rows for BIN and R-MAT's
    # sampled rows at global bounds for the global-pad symbolic kernels
    timings = {key: entry(*key) for key in calls}
    # the global pad's cost in the predictor: kernel 7 on R-MAT's sampled
    # rows beside the binned predictor's fused per-bucket calls on the same
    # rows, all-ESC (kernel 2) and auto-routed (kernels 2 and 4)
    m = dict(mats)["rmat_80k"]
    ad = csr.to_device(m, device=dev)
    rnb = torch.diff(ad.rpt)
    rows = oracle.sample_rows(m.nrows, seed=0)
    for route in ("esc", "auto"):
        bp = binning.build_plan(m, m, route=route)
        bk_calls = [
            dict(a=ad, b=ad, rows=torch.from_numpy(sub).to(dev),
                 max_deg_a=bk.deg_a, max_deg_b=bk.deg_b, route=bk.route,
                 span=bk.span, rownnz_b=rnb)
            for bk, sub in zip(bp.buckets, bp.subset(rows)) if sub.size]
        timings["sampled_symbolic", "rmat_80k"][f"binned_{route}_ms"] = \
            cuda_ms(torch, lambda: [kops.fused_flop_symbolic_routed(**kw)
                                    for kw in bk_calls])
        timings["sampled_symbolic", "rmat_80k"][
            f"binned_{route}_launches"] = len(bk_calls)
    del ad, bk_calls
    for e in timings.values():
        emit(dict(phase="kernel_time", **e))
    # the global pad's cost in the numeric phase: kernel 3 over all rows at
    # global bounds (the quickstart's spgemm) beside the binned auto-routed
    # execute and cuSPARSE on the same product
    for name in ("cant_like", "rmat_80k"):
        m = dict(mats)[name]
        ad = csr.to_device(m, device=dev)
        da = int(m.row_nnz.max())
        cap = predictor.AllocationPlan.from_prediction(
            global_structure[name], floprc[name],
            safety=SAFETY).row_capacity
        global_ms = cuda_ms(torch, lambda: spgemm.spgemm(
            ad, ad, row_capacity=cap, max_deg_a=da, max_deg_b=da,
            use_kernel=True))
        p = plan.plan_spgemm(m, m, use_kernel=True, safety=SAFETY,
                             device=dev)
        pa = p.to_device(m, "a")
        execute_ms = cuda_ms(torch, lambda: plan.execute(p, pa, pa))
        all_rows = np.arange(m.nrows)
        nbytes = bytes_numeric(np, m, all_rows, da, da, cap)
        ops = numeric_ops(floprc[name], all_rows)
        emit(dict(phase="global_numeric_time", matrix=name,
                  global_ms=global_ms, global_row_capacity=cap,
                  binned_execute_ms=execute_ms,
                  binned_row_capacity=p.alloc.row_capacity,
                  binned_esc_kernel_ms=timings["spgemm_numeric", name]["ms"],
                  library_ms=library_ms(name),
                  bound_ms=max(nbytes / HBM_BYTES_PER_S,
                               ops / FP32_FLOP_PER_S) * 1e3))
        del ad, pa, p
        torch.cuda.empty_cache()
    # flash attention beside its plain version and SDPA, the yardstick (its
    # is_causal is top-left aligned too), held to the plain version first:
    # the tensor-core kernel on G1, the CUDA-core one on G2 (float32)
    for case in ("G1", "G2"):
        q, k, v, want, causal = timed_attn.pop(case)
        err, ms, variant, tflops = attn[case]
        name = f"flash_attention_{variant}"

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)

        if not torch.allclose(sdpa().float(), want.float(), rtol=1e-2,
                              atol=1e-2):
            fail(f"attention {case}: scaled_dot_product_attention != plain")
        ops, nbytes = attention_work(q, k, causal)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / (FP32_FLOP_PER_S if q.dtype == torch.float32
                        else BF16_FLOP_PER_S) * 1e3
        bound = max(bytes_ms, ops_ms)
        source = FLASH_SOURCES[variant]
        e = dict(name=name, route="cuda",
                 source=f"src/repro_torch/kernels/csrc/{source}",
                 replaces="src/repro/kernels/flash_attention.py:82",
                 launches=sum(launches[p][name] for p in launches),
                 max_abs_err=err, ms=ms,
                 plain_ms=cuda_ms(torch, lambda: fa_k.flash_attention_plain(
                     q, k, v, causal=causal)),
                 bound_ms=bound,
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 library_ms=cuda_ms(torch, sdpa), timed_on=case, calls=1,
                 bytes=nbytes, operations=ops, tflop_per_s=tflops)
        if case == "G1":
            # the redesign's marks: half the bound (where the rule leaves a
            # kernel alone, if it also does not lose to SDPA) and the
            # acceptance bar
            e.update(target_ms=2 * bound, target_met=ms <= 2 * bound,
                     acceptance_ms=G1_ACCEPT_MS,
                     acceptance_met=ms <= G1_ACCEPT_MS,
                     loses_to_library=ms > e["library_ms"])
            sdpa_backends(torch, q, k, v, want, emit, attn)
        timings[name, case] = e
        emit(dict(phase="kernel_time", **e))
        del q, k, v, want
    report = [timings["flop_rows", "pl_100k_d4"],
              timings["fused_flop_symbolic", "pl_100k_d4"],
              timings["spgemm_numeric", "cant_like"],
              timings["fused_flop_symbolic_bitmask", "cant_like"],
              timings["spa_numeric", "cant_like"],
              timings["bin_numeric", "rmat_80k"],
              timings["sampled_symbolic", "rmat_80k"],
              timings["bitmask_symbolic", "rmat_80k"],
              timings["flop_per_row", "cant_like"],
              timings["flash_attention_sm90", "G1"],
              timings["flash_attention_simt", "G2"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: e[k] for k in keys + (("per_bucket_ms",) if "per_bucket_ms" in e
                                  else ())} for e in report]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
