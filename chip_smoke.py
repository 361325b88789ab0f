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
       and FEM products on the SPA route and R-MAT's hub rows on BIN: one
       launch of the bitmask symbolic kernel a prediction with SPA or BIN
       samples, none per bucket;
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
   (h) re-planning on overflow and plan templates: the seven products
       planned at ``safety=0`` (every bucket at the 8-slot floor) with
       ``RetryPolicy()``, with the legacy ``retry_safety=1.5`` and with
       ``RetryPolicy(rounds=0)`` (the exact-symbolic fallback alone:
       kernels 2 and 4 count the offending buckets' rows), and with
       ``pop_quant=True``, each held to (c)'s product (row pointers and
       ``col`` exactly, ``val`` to tolerance, whether bitwise said), only
       the overflowing buckets re-launched, the bumped plan run again
       without a retry; and two families of three members planned through
       ``template="auto"`` until, after the template's last growth, every
       member keeps one key, hits the cache and builds nothing, each
       member's product equal to its direct plan's;
   (i) column-partitioned B and fault injection: the seven products
       planned with ``n_panels=4`` (and 2 on ``rmat_80k`` and
       ``band_60k_d16``), one numeric launch a (bucket × panel) unit with
       products, each block held to the plain numeric phase on the same
       panel operand and the reassembled CSR to (c)'s; re-planning per unit
       at 4 panels (``safety=0`` with ``RetryPolicy()`` and
       ``RetryPolicy(rounds=0)``, and ``pop_quant=True``), exactly the
       overflowing units re-launched; then on ``pl_100k_d4`` (ESC) and
       ``band_60k_d16`` (SPA) starved capacities and a corrupted sketch
       (held to (c)'s CSR), a starved panel operand
       (``CapacityExhaustedError`` naming the panel) and a failed executor
       (``ShardFailureError`` from ``InjectedFault``), wave and panel wave;
   (j) measured route profiles, the straggler watchdog and the service:
       ``profiles.microbenchmark()`` times every route on the card's
       kernels (3, 5, 6 and the count modes 2c, 4c), round-trips through
       a file (a host profile is refused); the seven products planned
       under it, each CSR held to (c)'s (bitwise where no bucket changed
       route); ``DispatchBudget()`` armed on the seven, whole-B and at 4
       panels, under the analytic and the measured model, two clean runs
       each (a trip fails), then an injected delay on each wave kind on
       ``pl_100k_d4``, ``band_60k_d16`` and ``rmat_80k``: the replay
       bitwise equal to the clean run, JAX's ledger, one numeric launch a
       replayed unit; ``SpgemmService(use_kernel=True)`` on (h)'s
       template families at full size (every result bitwise equal to a
       direct run; a second pass builds nothing; the most its memory
       budget reserved at once at or above the pass's peak device bytes);
       and the service's chaos classes 1–6 on ``tests/test_service.py``'s
       small families;
   (k) distributed execution on a 4-shard mesh of the one card
       (``make_mesh((4,), ("data",), devices=[cuda:0] * 4)``): the seven
       products whole-B and at 2 panels, each CSR held to (c)'s (``val``
       bitwise, or the differing rows and routes printed), one numeric
       launch a (bucket × shard) unit with rows and products, the
       admission reservation at or above the run's peak device bytes; a
       lost shard (``faults.inject(lose_shard=...)``) on ``pl_100k_d4``,
       ``band_60k_d16`` and ``rmat_80k`` whole-B and ``band_60k_d16`` at 2
       panels, re-homed on the survivors, bitwise equal to the clean run,
       JAX's ledger order, no survivor's unit run twice; and
       ``SpgemmService`` on the mesh over (h)'s template families, DONE and
       then DEGRADED under a lost shard, each result bitwise equal to its
       direct run;
   (l) first of all, the LM serving path, which reaches no kernel of the
       port (its counts must stay 0): deepseek-v3-671b at its published
       widths cut to 4 layers in bf16 (31.6 GB, random weights from a
       seed), ``serve.engine.generate`` of 32 tokens for 4 prompts of 16,
       greedy twice (equal) and at temperature 0.7, every served logit
       held to ``transformer.forward`` of the same tokens within a bf16
       bound, prefill and decode steps timed and one decode window
       profiled; (l2) the paper's MoE capacity on that MoE layer at 4 ×
       512 tokens under a skewed router (the sampled block estimate
       against the exact count, the torch twin on the card against
       numpy, and ``apply_moe`` at the predicted and the default
       capacity); (l3) the eight attention-family smoke configs in
       float32, card against host within 1e-4, greedy tokens equal.
       ``python3 chip_smoke.py --lm-only`` runs (l), (m) and (n) alone,
       without the kernel build, and prints no ``ok`` line;
   (m) the recurrent families served, training and checkpoints, which
       reach no kernel either;
   (n) the LM stack sharded (``models/sharding.py``) on a (1, 1)
       ("data", "model") NCCL mesh of the card: (n1) phi3-mini at published
       widths cut to 4 layers, three train steps sharded and unsharded from
       the same weights and batches, losses and parameters compared; (n2)
       deepseek-v3 at 4 layers, decode steps with parameters and caches
       laid out by the decode specs (the caches' sequence axis on
       `model`), logits and caches against the unsharded ones; (n3)
       ``roofline.hlo_cost`` counts (n1)'s sharded step, its bound on the
       H100's rates against its CUDA-event time; (n4) the mini dry run
       (``python -m repro_torch.launch.dryrun --mini``, fake 2 × 4 mesh of
       ``cuda`` fake tensors) in a subprocess, which must count FLOPs and
       collective bytes;
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
   rows; the one-launch FLOP, ESC and bitmask symbolic entries also
   against the per-bucket kernels and the host oracles) and times both,
   with CUDA events (the SPA, all-rows FLOP and bitmask symbolic kernels
   also by their profiler device time; the all-rows FLOP kernel on
   ``cant_like``, ``webbase_like`` and ``pl_100k_d4``),
   beside the bound and a PyTorch yardstick (the BIN and symbolic
   kernels': ``torch.sparse.mm`` of their rows of A by B; attention's:
   ``scaled_dot_product_attention``, also through each of its backends);
   kernels 1, 2 and 4 as one launch over a whole prediction, their
   per-bucket sequence beside it;
   kernels 2 and 4 in their per-row count mode over the largest bucket
   (h)'s fallback counted with each;
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

import dataclasses
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
TF32_FLOP_PER_S = 495e12         # H100 SXM tf32 tensor cores, dense
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
FLASH_SOURCES = dict(sm90="flash_attention_sm90.cu", mma="flash_attention.cu")
# kernels whose kernel_time lines also carry their profiler device time, by
# a part of their CUDA kernels' names
DEVICE_TIMED = dict(spa_numeric="spa_numeric", flop_per_row="flop_all_rows",
                    fused_flop_symbolic_bitmask="bitmask_symbolic",
                    bitmask_symbolic="bitmask_symbolic")
G1_ACCEPT_MS = 2.0     # the tensor-core redesign's acceptance bar on G1
G2_ACCEPT_MS = 3.8     # the mma (3xTF32) redesign's acceptance bar on G2
# (h)'s template families, three members each, planned through
# template="auto"; a pass over the members repeats until one comes after
# the template's last growth
TEMPLATE_FAMILIES = (
    ("power_law", lambda sprand, s: sprand.power_law(100_000, 100_000, 4, 1.8,
                                                     seed=s), (201, 202, 203)),
    ("banded", lambda sprand, s: sprand.banded(60_000, 60_000, 16, 24, seed=s),
     (401, 402, 403)))
TEMPLATE_PASSES = 4
# (h)'s pad-row member: the first family's shape, banded, its row 0 a hub
PAD_ROW_SEED = 405
PAD_ROW_HUB = 2000
# (j4) serves each template family's members this many times a pass
SERVICE_COPIES = 2


# (l) the LM serving path: deepseek-v3-671b at its published widths, cut
# to its 3 dense layers and one MoE layer (15.8 B parameters, 31.6 GB in
# bf16), serving 4 requests of 16 prompt tokens and 32 generated ones
LM_CONFIG = "deepseek-v3-671b"
LM_LAYERS = 4
LM_BATCH, LM_PROMPT, LM_NEW = 4, 16, 32
LM_SEED = 0
LM_TEMPERATURE = 0.7
LM_FWD_CAPACITY = 64       # ≥ 47 tokens a group: the forward drops nothing
# decode against forward in bf16: the two paths round q, k and the
# residual stream at different points (MLA decode scores the absorbed
# query against the latent cache, the forward expands the latent), and
# this schema's scales (1/sqrt of shape[-2]) make attention scores ~7
# standard deviations wide, so one bf16 rounding of a score moves its
# softmax weight by up to ~3% of itself.  At a cut width (d_model 512,
# 64 experts) on the host the paths part by 0.24 of the largest |logit| at
# most and 0.05 of the logits' standard deviation on average; the bound is
# twice each.  A misplaced position or cache row moves the mean to ~1.4
# standard deviations.
LM_BF16_MAX_REL = 0.5
LM_BF16_MEAN_REL = 0.10
# (l2) the capacity example's flow at full width: 4 groups of 512 tokens
LM_MOE_GROUPS, LM_MOE_GROUP = 4, 512
LM_MOE_SKEW = 0.35
LM_MOE_SAFETY = 1.1        # predict_group_capacity's default
# (l3) the eight attention-family smoke configs in float32, card against
# host: within 1e-4 relative plus 1e-4 × the largest |logit|
LM_SMOKE_TOL = 1e-4
LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_P = 2, 10, 5

# (m) the recurrent families and training.  (m1) zamba2-7b whole (81
# layers, 6.75 B parameters, 13.5 GB in bf16) and (m2) xlstm-125m whole,
# each serving (l1)'s 4 requests of 16 prompt and 32 generated tokens,
# decode held to the forward within (l1)'s bf16 bounds; (m3) their smoke
# configs in float32, card against host
LM_RECURRENT = ("zamba2-7b", "xlstm-125m")
# zamba2's decode is held to its forward on the same weights in float32
# (27 GB at all 81 layers): under the schema's random scales its shared
# attention's scores are ~110 standard deviations wide, so one bf16
# rounding can change the key a query attends to, and the bf16 paths part
# by more than (l1)'s mean bound on a correct model (at 7 layers on the
# host: 0.130 of the logits' standard deviation against 0.100; in float32
# 8.4e-6).  Its bf16 differences are reported, not gated.
LM_F32_GATE = ("zamba2-7b",)
# (m4) xlstm-125m trained whole through launch.train: batch 8 of 512
# tokens (two SSD chunks), 30 steps, a checkpoint every 10; a restart from
# step 10's checkpoint; launch.serve on the last
TRAIN_CONFIG = "xlstm-125m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 512, 30, 10
TRAIN_LR, TRAIN_WARMUP = 1e-3, 5
TRAIN_RESUME_AT = 10
# (m5) phi3-mini-3.8b at published widths cut to 4 layers (651,193,344
# parameters): the whole model's parameters, gradients and float32 moments
# (~61 GB) leave no room for activations on one card
TRAIN_CUT_CONFIG, TRAIN_CUT_LAYERS = "phi3-mini-3.8b", 4
TRAIN_CUT_BATCH, TRAIN_CUT_SEQ, TRAIN_CUT_STEPS = 4, 1024, 10
# (m6) one train step of these smoke configs in float32, card against
# host: loss and grad norm within 1e-4 relative
TRAIN_SMOKE = ("deepseek-v3-671b", "xlstm-125m", "zamba2-7b")
TRAIN_SMOKE_SEQ = 29       # two SSD chunks of the smoke configs' 16
TRAIN_SMOKE_TOL = 1e-4
# (n) the LM stack on a device mesh, a (1, 1) ("data", "model") mesh of the
# one card over NCCL.  (n1) (m5)'s phi3-mini at 4 layers: SHARD_STEPS train
# steps sharded and unsharded from the same weights and batches, in the
# config's bf16 and in float32; Adam's first steps are the sign of each
# gradient, so ``eps`` is raised to keep a gradient within rounding of 0
# from flipping a step.  The sharded loss takes its log-sum-exp as a max
# and a sum (the vocab may be sharded), so the two runs part in rounding,
# and training amplifies that: Adam divides each gradient by its own root
# mean square, so parameters 1e-7 apart after one step give gradients
# that differ by percents two steps later (measured on the card: at equal
# parameters the float32 gradients agree within 2.9e-6 at every step, bf16
# within 3.9%, one or a few bf16 steps).  Gated: the first step's loss
# (before any update) within SHARD_LOSS_RTOL; in float32 the gradients at
# the last step's parameters, taken sharded and unsharded, within
# SHARD_GRAD_TOL of each leaf's largest |gradient|; every loss within
# SHARD_STEP_LOSS_RTOL and the parameters within SHARD_PARAM_TOL of each
# leaf's largest |value| (a misplaced shard moves them by their own size).
# (n2) (l1)'s deepseek-v3 at 4 layers: SHARD_PROMPT decode steps and one
# more, the caches' sequence axis laid out on `model`; its softmax is taken
# as an exp over a max and a sum, so logits within
# SHARD_LOGIT_MAX_REL of the largest |logit| (max) and SHARD_LOGIT_MEAN_REL
# of their standard deviation (mean).  (n3) hlo_cost's counts of (n1)'s
# sharded step against its CUDA-event time.  (n4) the mini dry run.
SHARD_STEPS, SHARD_TIMED, SHARD_EPS = 3, 5, 1e-3
SHARD_LOSS_RTOL, SHARD_GRAD_TOL = 1e-5, 1e-4
SHARD_STEP_LOSS_RTOL, SHARD_PARAM_TOL = 1e-2, 0.1
SHARD_PROMPT = 8
SHARD_LOGIT_MAX_REL, SHARD_LOGIT_MEAN_REL = 0.05, 0.01


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


def lm_within(got, want, tol: float) -> tuple[float, bool]:
    """(max |got − want|, whether every element is within ``tol`` relative
    plus ``tol`` × the largest |want|)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = max(float(want.abs().max()), 1.0)
    return (float(diff.max()),
            bool((diff <= tol * want.abs() + tol * scale).all()))


def lm_decode_profile(torch, engine, sess, decode_fn, prompt,
                      steps: int = 8) -> dict:
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    steps (after two untraced ones), the device's kernel time a step, its
    idle share of the traced wall time, and the kernels that take most of
    it (empty where the profiler sees no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        engine.prefill(sess, prompt[:, i:i + 1], decode_fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(2, 2 + steps):
            engine.prefill(sess, prompt[:, i:i + 1], decode_fn)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kern) / 1e3
    if not busy_ms:
        return dict(profile_device_ms=None)
    top = sorted(kern, key=lambda e: -e.device_time_total)[:8]
    return dict(profile_device_ms=busy_ms / steps,
                profile_wall_ms=wall_ms / steps,
                profile_idle_share=max(0.0, 1 - busy_ms / wall_ms),
                profile_kernels_a_step=sum(e.count for e in kern) / steps,
                profile_top=[[e.key[:70], e.device_time_total / 1e3 / steps,
                              e.count // steps] for e in top])


def lm_smoke(torch, np, dev, names) -> None:
    """(l3)/(m3): each named smoke config in float32 on the card against
    the host on the same weights: forward (and MTP) logits, every decode
    step's and greedy tokens."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import schema
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    if torch.backends.cuda.matmul.allow_tf32:
        fail("lm: TF32 is on for float32 products")
    cpu = torch.device("cpu")
    for name in names:
        scfg = get_smoke_config(name)
        sch = T.build_schema(scfg)
        gen = torch.Generator().manual_seed(LM_SEED)
        p_host = schema.init_params(sch, gen, torch.float32, cpu)
        rng = np.random.default_rng(LM_SEED)
        tok_np = rng.integers(0, scfg.vocab_size,
                              (LM_SMOKE_B, LM_SMOKE_S)).astype(np.int32)
        fe_np = None
        if scfg.frontend == "audio_stub":
            fe_np = rng.standard_normal((LM_SMOKE_B, scfg.encoder_seq_len,
                                         scfg.d_model)).astype(np.float32)
        res = {}
        for where, device in (("host", cpu), ("card", dev)):
            p = schema.tree_map(lambda a: a.to(device), p_host)
            tok = torch.from_numpy(tok_np).to(device)
            fe = None if fe_np is None else torch.from_numpy(fe_np).to(device)
            batch = {"tokens": tok}
            if fe is not None:
                batch["frame_embeds"] = fe
            with torch.no_grad():
                full, _, mtp = T.forward(p, scfg, batch,
                                         capacity=LM_FWD_CAPACITY)
            steps = engine.prefill(engine.start_session(
                scfg, p, LM_SMOKE_B, LM_SMOKE_S, frame_embeds=fe,
                device=device), tok, all_logits=True)
            greedy = engine.generate(engine.start_session(
                scfg, p, LM_SMOKE_B, LM_SMOKE_S + 1, frame_embeds=fe,
                device=device), tok[:, :LM_SMOKE_P], LM_SMOKE_S - LM_SMOKE_P)
            res[where] = [a.cpu() if a is not None else None
                          for a in (full, mtp, steps, greedy)]
        (hf, hm, hs, hg), (cf, cm, cs, cg) = res["host"], res["card"]
        checks = dict(decode_vs_forward=lm_within(cs, cf, LM_SMOKE_TOL),
                      forward_vs_host=lm_within(cf, hf, LM_SMOKE_TOL),
                      decode_vs_host=lm_within(cs, hs, LM_SMOKE_TOL))
        if hm is not None:
            checks["mtp_vs_host"] = lm_within(cm, hm, LM_SMOKE_TOL)
        bad = [c for c, (_, ok) in checks.items() if not ok]
        if bad or not torch.equal(cg, hg):
            fail(f"lm smoke {name}: {bad} past {LM_SMOKE_TOL} or greedy "
                 f"tokens {cg.tolist()} != host {hg.tolist()}")
        emit(dict(phase="lm_smoke", config=name, served=True,
                  tolerance=LM_SMOKE_TOL, greedy_equal=True,
                  **{c: err for c, (err, _) in checks.items()}))


def lm_serving(torch, np, dev) -> None:
    """Phase (l): the LM serving path on the card, through the engine a
    user calls.  It launches no kernel of the port: the JAX package's model
    reaches none of its Pallas kernels, and its attention and expert
    products are plain tensor products here as there."""
    from repro_torch.configs.base import get_config, smoke_registry
    from repro_torch.core import moe_capacity
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import schema
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    t_phase = time.perf_counter()

    # ---- (l1) deepseek-v3 at its published widths, 4 layers, bf16
    cfg = dataclasses.replace(get_config(LM_CONFIG), num_layers=LM_LAYERS)
    sch = T.build_schema(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    params = schema.init_params(sch, gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = schema.param_count(sch)
    p_bytes = schema.param_bytes(params)
    if p_bytes != 2 * n_params:
        fail(f"lm: {p_bytes} parameter bytes for {n_params} bf16 parameters")
    emit(dict(phase="lm_params", config=cfg.name, num_layers=cfg.num_layers,
              d_model=cfg.d_model, experts=cfg.moe_num_experts,
              vocab=cfg.vocab_size, parameters=n_params, bytes=p_bytes,
              init_seconds=init_s))
    rng = np.random.default_rng(LM_SEED)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)
    max_len = LM_PROMPT + LM_NEW + 1

    def session():
        return engine.start_session(cfg, params, LM_BATCH, max_len,
                                    device=dev)

    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, logits = engine.generate(session(), prompt, LM_NEW,
                                   return_logits=True)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t
    again = engine.generate(session(), prompt, LM_NEW)
    sampled = engine.generate(session(), prompt, LM_NEW,
                              temperature=LM_TEMPERATURE, seed=LM_SEED)
    for what, tk in (("greedy", toks), ("sampled", sampled)):
        if (tuple(tk.shape) != (LM_BATCH, LM_NEW)
                or not bool(((tk >= 0) & (tk < cfg.vocab_size)).all())):
            fail(f"lm: {what} tokens of shape {tuple(tk.shape)} outside "
                 f"[0, {cfg.vocab_size})")
    if not torch.equal(toks, again):
        fail("lm: two greedy runs of one prompt gave different tokens")
    if not bool(torch.isfinite(logits).all()):
        fail("lm: a served logit is not finite")
    # decode against the teacher-forced forward of the same tokens
    seq = torch.cat([prompt, toks[:, :-1]], dim=1)
    with torch.no_grad():
        full, aux, mtp = T.forward(params, cfg, {"tokens": seq},
                                   capacity=LM_FWD_CAPACITY)
    # the dropped fraction is 1 − a float32 mean of the kept flags: an
    # all-kept mean may round to 1 − 2^-24
    if float(aux.moe_dropped) > 1e-6:
        fail(f"lm: the forward at capacity {LM_FWD_CAPACITY} dropped "
             f"{float(aux.moe_dropped)}")
    if not (bool(torch.isfinite(full).all())
            and bool(torch.isfinite(mtp).all())):
        fail("lm: a forward or MTP logit is not finite")
    diff = (logits[:, :-1] - full).abs()
    max_d, mean_d = float(diff.max()), float(diff.mean())
    max_bound = LM_BF16_MAX_REL * float(full.abs().max())
    mean_bound = LM_BF16_MEAN_REL * float(full.std())
    v = cfg.vocab_size
    agree = float((logits[:, :-1, :v].argmax(-1)
                   == full[..., :v].argmax(-1)).float().mean())
    if max_d > max_bound or mean_d > mean_bound:
        fail(f"lm: decode against forward max |diff| {max_d} (bound "
             f"{max_bound}), mean {mean_d} (bound {mean_bound})")
    del full, mtp, diff, seq
    # timed: the prompt's prefill, then each decode step on CUDA events
    decode_fn = engine.make_decode_fn(cfg)
    sess = session()
    torch.cuda.synchronize()
    t = time.perf_counter()
    last = engine.prefill(sess, prompt, decode_fn)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    events, picks = [], []
    for i in range(LM_NEW):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        picks.append(last[:, -1, :v].argmax(-1))
        start.record()
        last = engine.prefill(sess, toks[:, i:i + 1], decode_fn)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    if not torch.equal(torch.stack(picks, 1).to(torch.int32), toks):
        fail("lm: the timed decode steps pick other tokens than generate")
    median_ms = step_ms[len(step_ms) // 2]
    # the step's bytes: every weight but the embedding table (a gather of
    # one row a request) and the MTP module (not run when serving), the
    # rows gathered, and the latent cache at its full length
    tok_bytes = params["embed"]["tok"].numel() * 2
    mtp_bytes = schema.param_bytes(params["mtp"])
    cache_bytes = sum(a.numel() * a.element_size()
                      for seg in sess.cache.values() for c in seg.values()
                      for a in c)
    step_bytes = (p_bytes - tok_bytes - mtp_bytes + LM_BATCH * cfg.d_model * 2
                  + cache_bytes)
    profile = lm_decode_profile(torch, engine, session(), decode_fn, prompt)
    line = dict(phase="lm_serve", config=cfg.name, num_layers=cfg.num_layers,
                batch=LM_BATCH, prompt=LM_PROMPT, generated=LM_NEW,
                param_bytes=p_bytes, generate_seconds=generate_s,
                prefill_seconds=prefill_s, decode_ms_median=median_ms,
                decode_ms_min=step_ms[0], decode_ms_max=step_ms[-1],
                tokens_per_s=LM_BATCH * 1e3 / median_ms,
                step_bytes=step_bytes,
                step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
                all_weights_ms=p_bytes / HBM_BYTES_PER_S * 1e3,
                peak_bytes=torch.cuda.max_memory_allocated(),
                decode_vs_forward_max_abs=max_d, max_abs_bound=max_bound,
                decode_vs_forward_mean_abs=mean_d, mean_abs_bound=mean_bound,
                argmax_agreement=agree,
                greedy_first=toks[0, :8].tolist(),
                sampled_first=sampled[0, :8].tolist(), **profile)
    emit(line)
    del sess, last, logits, again, sampled

    # ---- (l2) the paper's MoE capacity at full width, on (l1)'s MoE layer
    # (examples/moe_capacity_planning.py's flow: a skewed router, 4 groups
    # of 512 tokens)
    moe_p = schema.tree_map(lambda a: a[0], params["seg1"]["pos0"]["moe"])
    router = moe_p["router"].clone()
    router[:, :2] += LM_MOE_SKEW
    moe_p = dict(moe_p, router=router)
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    tokens = LM_MOE_GROUPS * LM_MOE_GROUP
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LM_MOE_GROUPS, LM_MOE_GROUP, cfg.d_model)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    ids = torch.topk((x @ router).float(), k, dim=-1).indices.reshape(
        tokens, k)
    ids_np = ids.cpu().numpy()
    plan = moe_capacity.predict_dispatch_capacity(
        ids_np, e, group_size=64, seed=0, sample_fraction=0.05)
    exact = moe_capacity.exact_dispatch_blocks(ids_np, group_size=64)
    gids = torch.from_numpy(moe_capacity.dispatch_sample_groups(
        tokens, 64, 0, 0.05)).to(dev)
    blocks, cr, flopr = moe_capacity.predict_dispatch_capacity_torch(
        ids, e, 64, gids)
    z, f = moe_capacity.sampled_dispatch_counts_torch(ids, 64, gids)
    if (int(z), f) != (plan.exact_sample_blocks, plan.sampled_assignments):
        fail(f"lm: the torch twin's (z*, f*) {(int(z), f)} != numpy's "
             f"{(plan.exact_sample_blocks, plan.sampled_assignments)}")
    if not np.array_equal(flopr.cpu().numpy(),
                          np.bincount(ids_np.reshape(-1), minlength=e)):
        fail("lm: the torch twin's flopr_e != numpy's")
    blocks_rel = abs(float(blocks) - plan.predicted_blocks) / \
        plan.predicted_blocks
    if blocks_rel > 1e-6:
        fail(f"lm: the torch twin's blocks* {float(blocks)} != numpy's "
             f"{plan.predicted_blocks}")
    pred_cap = moe_capacity.predict_group_capacity(
        ids_np, e, group_size=LM_MOE_GROUP, sample_fraction=0.2, seed=1)
    guess_cap = moe_mod.default_capacity(cfg, LM_MOE_GROUP)
    # the most a group can need: every token on one expert, × the safety
    cap_bound = -(-int(np.ceil(LM_MOE_GROUP * LM_MOE_SAFETY)) // 4) * 4
    bound_bytes = moe_mod.dispatch_buffer_bytes(cfg, LM_MOE_GROUPS,
                                                cap_bound, torch.bfloat16)
    dropped = {}
    for label, cap in (("default", guess_cap), ("predicted", pred_cap)):
        buf_bytes = moe_mod.dispatch_buffer_bytes(cfg, LM_MOE_GROUPS, cap,
                                                  torch.bfloat16)
        free = torch.cuda.mem_get_info()[0]
        # the buffer, the expert outputs of its size and the hidden layer
        if cap > cap_bound or 2.6 * buf_bytes > free:
            fail(f"lm: capacity {cap} (bound {cap_bound}) needs "
                 f"{buf_bytes} buffer bytes, {free} free")
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            y, maux = moe_mod.apply_moe(moe_p, cfg, x, capacity=cap)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(y).all()):
            fail(f"lm: apply_moe at capacity {cap} is not finite")
        dropped[label] = float(maux.dropped_fraction)
        emit(dict(phase="lm_moe_capacity", capacity_from=label,
                  capacity=cap, capacity_bound=cap_bound,
                  buffer_bytes=buf_bytes, bound_buffer_bytes=bound_bytes,
                  dropped_fraction=dropped[label],
                  seconds=time.perf_counter() - t))
        del y, maux
    if dropped["predicted"] > dropped["default"]:
        fail(f"lm: the predicted capacity drops more {dropped}")
    emit(dict(phase="lm_moe_blocks", tokens=tokens, group_size=64,
              exact_blocks=exact, predicted_blocks=plan.predicted_blocks,
              rel_error=(plan.predicted_blocks - exact) / exact,
              compression_ratio=plan.compression_ratio,
              sampled_groups=int(gids.numel()), twin_blocks=float(blocks),
              twin_rel_diff=blocks_rel, twin_cr=float(cr)))
    del params, moe_p, router, x, ids, toks
    torch.cuda.empty_cache()

    # ---- (l3) the attention-family smoke configs in float32: the card
    # against the host
    lm_smoke(torch, np, dev, sorted(n for n in smoke_registry()
                                    if n not in LM_RECURRENT))
    emit(dict(phase="lm_seconds", seconds=time.perf_counter() - t_phase))


def cache_step_bytes(cache) -> int:
    """Bytes a decode step moves in the serving cache: a recurrent state
    (SSM, conv, sLSTM) is read and written whole, a KV cache read whole
    (its one new position's write is left out)."""
    from repro_torch.models.attention import KVCache
    if isinstance(cache, dict):
        return sum(cache_step_bytes(c) for c in cache.values())
    n = sum(a.numel() * a.element_size() for a in cache)
    return n if isinstance(cache, KVCache) else 2 * n


def decode_vs_forward(torch, T, cfg, params, prompt, toks, logits) -> dict:
    """The served logits (prompt then generated tokens) against the
    teacher-forced forward of the same tokens: the largest and the mean
    |difference|, (l1)'s bounds on each, and the arg-max agreement."""
    seq = torch.cat([prompt, toks[:, :-1]], dim=1)
    with torch.no_grad():
        full, _, _ = T.forward(params, cfg, {"tokens": seq})
    if not bool(torch.isfinite(full).all()):
        fail(f"{cfg.name}: a forward logit is not finite")
    diff = (logits[:, :-1] - full).abs()
    v = cfg.vocab_size
    return dict(
        decode_vs_forward_max_abs=float(diff.max()),
        max_abs_bound=LM_BF16_MAX_REL * float(full.abs().max()),
        decode_vs_forward_mean_abs=float(diff.mean()),
        mean_abs_bound=LM_BF16_MEAN_REL * float(full.std()),
        argmax_agreement=float((logits[:, :-1, :v].argmax(-1)
                                == full[..., :v].argmax(-1)).float().mean()))


def check_decode_vs_forward(what: str, g: dict) -> None:
    if (g["decode_vs_forward_max_abs"] > g["max_abs_bound"]
            or g["decode_vs_forward_mean_abs"] > g["mean_abs_bound"]):
        fail(f"{what}: decode against forward max |diff| "
             f"{g['decode_vs_forward_max_abs']} (bound {g['max_abs_bound']})"
             f", mean {g['decode_vs_forward_mean_abs']} (bound "
             f"{g['mean_abs_bound']})")


def lm_serve_whole(torch, np, dev, name: str) -> None:
    """(m1)/(m2): ``name`` at its published widths and depth in bf16,
    random weights drawn on the card, served through ``engine.generate``;
    decode held to the forward, greedy twice equal, timed and profiled."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import schema
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    cfg = get_config(name)
    sch = T.build_schema(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    params = schema.init_params(sch, gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = schema.param_count(sch)
    p_bytes = schema.param_bytes(params)
    if p_bytes != 2 * n_params:
        fail(f"{name}: {p_bytes} parameter bytes for {n_params} bf16 "
             "parameters")
    emit(dict(phase="lm_recurrent_params", config=name,
              num_layers=cfg.num_layers, d_model=cfg.d_model,
              vocab=cfg.vocab_size, parameters=n_params, bytes=p_bytes,
              by_part={k: schema.param_count(v) for k, v in sch.items()},
              init_seconds=init_s))
    rng = np.random.default_rng(LM_SEED)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)
    max_len = LM_PROMPT + LM_NEW + 1

    def session():
        return engine.start_session(cfg, params, LM_BATCH, max_len,
                                    device=dev)

    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, logits = engine.generate(session(), prompt, LM_NEW,
                                   return_logits=True)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t
    again = engine.generate(session(), prompt, LM_NEW)
    if (tuple(toks.shape) != (LM_BATCH, LM_NEW)
            or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
        fail(f"{name}: greedy tokens of shape {tuple(toks.shape)} outside "
             f"[0, {cfg.vocab_size})")
    if not torch.equal(toks, again):
        fail(f"{name}: two greedy runs of one prompt gave different tokens")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{name}: a served logit is not finite")
    # decode against the teacher-forced forward of the same tokens (within
    # zamba2's 4096-token window the two agree, ROADMAP R9)
    v = cfg.vocab_size
    gate = decode_vs_forward(torch, T, cfg, params, prompt, toks, logits)
    if name not in LM_F32_GATE:
        check_decode_vs_forward(name, gate)
    del logits, again
    decode_fn = engine.make_decode_fn(cfg)
    sess = session()
    torch.cuda.synchronize()
    t = time.perf_counter()
    last = engine.prefill(sess, prompt, decode_fn)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    events, picks = [], []
    for i in range(LM_NEW):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        picks.append(last[:, -1, :v].argmax(-1))
        start.record()
        last = engine.prefill(sess, toks[:, i:i + 1], decode_fn)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    if not torch.equal(torch.stack(picks, 1).to(torch.int32), toks):
        fail(f"{name}: the timed decode steps pick other tokens than "
             "generate")
    median_ms = step_ms[len(step_ms) // 2]
    # the step's bytes: every weight once but the embedding table (a
    # gather of one row a request), zamba2's shared block once each time
    # it runs, and the caches (cache_step_bytes)
    n_shared = sum(1 for i in range(cfg.num_layers)
                   if cfg.attn_every and (i + 1) % cfg.attn_every == 0)
    shared_bytes = (schema.param_bytes(params["shared_attn"])
                    if n_shared else 0)
    tok_bytes = params["embed"]["tok"].numel() * 2
    cache_bytes = cache_step_bytes(sess.cache)
    step_bytes = (p_bytes - tok_bytes + LM_BATCH * cfg.d_model * 2
                  + max(n_shared - 1, 0) * shared_bytes + cache_bytes)
    profile = lm_decode_profile(torch, engine, session(), decode_fn, prompt)
    serve_peak = torch.cuda.max_memory_allocated()
    del sess, last
    if name in LM_F32_GATE:
        # the same weights in float32: decode held to the forward there
        bf16_gate = gate
        params = schema.tree_map(lambda a: a.float(), params)
        torch.cuda.empty_cache()
        f32_cfg = dataclasses.replace(cfg, dtype="float32")
        toks32, logits32 = engine.generate(
            engine.start_session(f32_cfg, params, LM_BATCH, max_len,
                                 device=dev), prompt, LM_NEW,
            return_logits=True)
        gate = decode_vs_forward(torch, T, f32_cfg, params, prompt, toks32,
                                 logits32)
        check_decode_vs_forward(f"{name} (float32)", gate)
        gate = dict(gate, gated_in="float32",
                    float32_peak_bytes=torch.cuda.max_memory_allocated(),
                    **{f"bf16_{k}": x for k, x in bf16_gate.items()})
        del toks32, logits32
    emit(dict(phase="lm_recurrent_serve", config=name,
              num_layers=cfg.num_layers, batch=LM_BATCH, prompt=LM_PROMPT,
              generated=LM_NEW, param_bytes=p_bytes,
              shared_block_runs=n_shared, cache_step_bytes=cache_bytes,
              generate_seconds=generate_s, prefill_seconds=prefill_s,
              decode_ms_median=median_ms, decode_ms_min=step_ms[0],
              decode_ms_max=step_ms[-1],
              tokens_per_s=LM_BATCH * 1e3 / median_ms,
              step_bytes=step_bytes,
              step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
              peak_bytes=serve_peak, greedy_first=toks[0, :8].tolist(),
              **gate, **profile))
    del params
    torch.cuda.empty_cache()


def lm_recurrent(torch, np, dev) -> None:
    """Phase (m1)–(m3): the recurrent families served on the card.  No
    kernel of the port runs: the JAX package's SSD scan and recurrences
    are plain array code, as the port's are."""
    t_phase = time.perf_counter()
    for name in LM_RECURRENT:
        lm_serve_whole(torch, np, dev, name)
    lm_smoke(torch, np, dev, LM_RECURRENT)
    emit(dict(phase="lm_recurrent_seconds",
              seconds=time.perf_counter() - t_phase))


def _tree_bits(torch, tree) -> list:
    """Every leaf of a (params, AdamState) tree on the host, bfloat16 as
    its 16-bit pattern (for a bit-for-bit comparison)."""
    from repro_torch.models import schema
    params, state = tree
    leaves = (schema.tree_leaves(params) + [state.step]
              + schema.tree_leaves(state.mu) + schema.tree_leaves(state.nu))
    return [(a.view(torch.int16) if a.dtype == torch.bfloat16 else a)
            .detach().cpu().clone() for a in leaves]


def lm_training(torch, np, dev) -> None:
    """Phase (m4)–(m6): training on the card."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.ckpt import checkpoint as ckpt_mod
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import schema
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import make_train_step
    t_phase = time.perf_counter()

    # ---- (m4) xlstm-125m whole through launch.train, restart, serve
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        run_a, run_b = os.path.join(root, "a"), os.path.join(root, "b")
        argv = ["--arch", TRAIN_CONFIG, "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--warmup",
                str(TRAIN_WARMUP), "--ckpt-every", str(TRAIN_CKPT_EVERY),
                "--log-every", str(TRAIN_CKPT_EVERY), "--device", "cuda"]
        losses, stamps, saved = {}, {}, {}

        def on_step(step, metrics, params, opt_state):
            losses[step] = float(metrics["loss"])   # waits for the step
            stamps[step] = time.perf_counter()
            if step == TRAIN_RESUME_AT:
                saved["tree"] = _tree_bits(torch, (params, opt_state))

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        first, last = launch_train.main(
            argv + ["--steps", str(TRAIN_STEPS), "--ckpt-dir", run_a],
            on_step=on_step)
        train_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        if sorted(losses) != list(range(1, TRAIN_STEPS + 1)):
            fail(f"train: steps {sorted(losses)} ran")
        if not all(np.isfinite(list(losses.values()))):
            fail(f"train: a loss is not finite: {losses}")
        if not last < first:
            fail(f"train: the loss did not fall: first {first}, last five "
                 f"{last}")
        gaps = sorted(stamps[i + 1] - stamps[i]
                      for i in range(1, TRAIN_STEPS))
        step_ms = gaps[len(gaps) // 2] * 1e3
        kept = sorted(os.listdir(run_a))
        # restart from step 10's checkpoint in a directory of its own
        shutil.copytree(os.path.join(run_a, f"step_{TRAIN_RESUME_AT:010d}"),
                        os.path.join(run_b,
                                     f"step_{TRAIN_RESUME_AT:010d}"))
        cfg = get_config(TRAIN_CONFIG)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        like = schema.init_params(T.build_schema(cfg), gen, torch.bfloat16,
                                  dev)
        like_state = opt_mod.init_state(
            opt_mod.AdamWConfig(state_dtype=cfg.opt_state_dtype), like)
        restored, _, step = ckpt_mod.restore(run_b, (like, like_state))
        got = _tree_bits(torch, restored)
        if step != TRAIN_RESUME_AT or len(got) != len(saved["tree"]) or \
                not all(torch.equal(a, b) for a, b in zip(got,
                                                          saved["tree"])):
            fail(f"train: the tree restored at step {step} is not the "
                 "one saved bit for bit")
        del like, like_state, restored, got, saved["tree"]
        resumed = {}
        launch_train.main(
            argv + ["--steps", str(TRAIN_RESUME_AT + 1), "--ckpt-dir", run_b],
            on_step=lambda i, m, *_: resumed.__setitem__(i, float(m["loss"])))
        want = losses[TRAIN_RESUME_AT + 1]
        if resumed != {TRAIN_RESUME_AT + 1: want}:
            fail(f"train: the resumed step's loss {resumed} != the "
                 f"uninterrupted run's {want}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            served = launch_serve.main([
                "--arch", TRAIN_CONFIG, "--batch", str(LM_BATCH),
                "--prompt-len", str(LM_PROMPT), "--gen", str(LM_PROMPT),
                "--ckpt-dir", run_a, "--device", "cuda"])
        if f"restored step {TRAIN_STEPS}" not in out.getvalue():
            fail(f"serve: did not restore step {TRAIN_STEPS}: "
                 f"{out.getvalue()[:300]}")
        if (served.shape != (LM_BATCH, LM_PROMPT)
                or not ((served >= 0) & (served < cfg.vocab_size)).all()):
            fail(f"serve: tokens of shape {served.shape} out of range")
        emit(dict(phase="train_whole", config=TRAIN_CONFIG,
                  parameters=cfg.param_count_estimate(), batch=TRAIN_BATCH,
                  seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=TRAIN_LR,
                  warmup=TRAIN_WARMUP, seconds=train_s,
                  step_ms_median=step_ms, step_ms_min=gaps[0] * 1e3,
                  step_ms_max=gaps[-1] * 1e3,
                  tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * 1e3 / step_ms,
                  peak_bytes=peak, first_loss=first, last5_loss=float(last),
                  losses=[losses[i] for i in sorted(losses)],
                  checkpoints_kept=kept, resumed_at=TRAIN_RESUME_AT,
                  resumed_loss=resumed[TRAIN_RESUME_AT + 1],
                  resume_bit_exact=True, served_first=served[0].tolist()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- (m5) phi3-mini at published widths, 4 layers, 10 steps
    cfg = dataclasses.replace(get_config(TRAIN_CUT_CONFIG),
                              num_layers=TRAIN_CUT_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = schema.init_params(T.build_schema(cfg), gen,
                                getattr(torch, cfg.dtype), dev)
    n_params = schema.param_count(T.build_schema(cfg))
    opt_cfg = opt_mod.AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=2,
                                  total_steps=TRAIN_CUT_STEPS,
                                  state_dtype=cfg.opt_state_dtype)
    state = opt_mod.init_state(opt_cfg, params)
    step_fn = make_train_step(cfg, opt_cfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_CUT_SEQ,
                                  TRAIN_CUT_BATCH, seed=LM_SEED))
    cut_losses, cut_ms = [], []
    for i in range(TRAIN_CUT_STEPS):
        b = data.batch(i)
        batch = {k: torch.from_numpy(b[k]).to(dev)
                 for k in ("tokens", "labels", "positions")}
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        cut_losses.append(float(m["loss"]))
        cut_ms.append((time.perf_counter() - t) * 1e3)
    tokens = TRAIN_CUT_BATCH * TRAIN_CUT_SEQ
    cut_sorted = sorted(cut_ms[1:])
    median = cut_sorted[len(cut_sorted) // 2]
    if not np.isfinite(cut_losses).all():
        fail(f"train cut: a loss is not finite: {cut_losses}")
    if not np.mean(cut_losses[-3:]) < cut_losses[0]:
        fail(f"train cut: the loss did not fall: {cut_losses}")
    emit(dict(phase="train_cut", config=cfg.name,
              num_layers=cfg.num_layers, parameters=n_params,
              reduced="depth 32 → 4 layers: the whole model's parameters, "
                      "gradients and float32 moments leave no room on one "
                      "card", batch=TRAIN_CUT_BATCH, seq=TRAIN_CUT_SEQ,
              steps=TRAIN_CUT_STEPS, step_ms_median=median,
              step_ms_first=cut_ms[0], tokens_per_s=tokens * 1e3 / median,
              flop_bound_ms=6 * n_params * tokens / BF16_FLOP_PER_S * 1e3,
              peak_bytes=torch.cuda.max_memory_allocated(),
              losses=cut_losses))
    del params, state, step_fn
    torch.cuda.empty_cache()

    # ---- (m6) one train step of three smoke configs, card against host
    if torch.backends.cuda.matmul.allow_tf32:
        fail("train: TF32 is on for float32 products")
    for name in TRAIN_SMOKE:
        scfg = get_smoke_config(name)
        host = schema.init_params(T.build_schema(scfg),
                                  torch.Generator().manual_seed(LM_SEED),
                                  torch.float32, torch.device("cpu"))
        b = SyntheticLM(DataConfig(scfg.vocab_size, TRAIN_SMOKE_SEQ, 2,
                                   seed=LM_SEED)).batch(0)
        opt_cfg = opt_mod.AdamWConfig(warmup_steps=1, total_steps=2)
        res = {}
        for where, device in (("host", torch.device("cpu")), ("card", dev)):
            p = schema.tree_map(lambda a: a.to(device), host)
            batch = {k: torch.from_numpy(b[k]).to(device)
                     for k in ("tokens", "labels")}
            _, _, m = make_train_step(scfg, opt_cfg)(
                p, opt_mod.init_state(opt_cfg, p), batch)
            res[where] = {k: float(v) for k, v in m.items()}
        rel = {k: abs(res["card"][k] - res["host"][k])
               / max(abs(res["host"][k]), 1e-30)
               for k in ("loss", "grad_norm")}
        if any(r > TRAIN_SMOKE_TOL for r in rel.values()):
            fail(f"train smoke {name}: card against host {rel}")
        emit(dict(phase="train_smoke", config=name,
                  tolerance=TRAIN_SMOKE_TOL, card=res["card"],
                  host=res["host"], rel_diff=rel))
    emit(dict(phase="train_seconds", seconds=time.perf_counter() - t_phase))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _whole(tree, specs, mesh):
    """``tree``'s tensors as DTensors laid out by ``specs`` on a (1, 1)
    mesh, where every shard is the whole tensor: the same storage, no
    copy."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import sharding
    if isinstance(tree, dict):
        return {k: _whole(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, tuple) and not sharding.is_spec(specs):
        return type(tree)(*(_whole(t, s, mesh) for t, s in zip(tree, specs)))
    return DTensor.from_local(tree, mesh, sharding.placements(specs, mesh),
                              run_check=False)


def _tree_diff(torch, got, want) -> dict:
    """Leaves equal bit for bit, and the largest |difference| over the
    leaf's largest |value|, of two trees of the same structure."""
    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, tuple):
            return [x for v in t for x in leaves(v)]
        return [t]
    equal, worst = 0, 0.0
    a_s, b_s = leaves(got), leaves(want)
    for a, b in zip(a_s, b_s):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        equal += bool(torch.equal(a, b))
        d = (a.float() - b.float()).abs().max()
        worst = max(worst, float(d / b.float().abs().max().clamp_min(1e-30)))
    return dict(leaves=len(b_s), bitwise_leaves=equal, max_rel=worst)


def lm_sharded(torch, np, dev) -> None:
    """Phase (n): the LM stack sharded (``models/sharding.py``) on a (1, 1)
    NCCL mesh of the card, held to the unsharded runs, its roofline counted
    (``roofline/hlo_cost.py``), and the mini dry run in a subprocess.  No
    kernel of the port runs."""
    import contextlib
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import schema, sharding
    from repro_torch.models import transformer as T
    from repro_torch.roofline import analysis as roof
    from repro_torch.roofline import hlo_cost
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import grads_of, make_train_step
    t_phase = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))

        # ---- (n1) phi3-mini at published widths, 4 layers: a sharded
        # train step against the unsharded one, in bf16 and in float32
        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            return out, (start, end)

        def median_ms(events):
            torch.cuda.synchronize()
            ms = sorted(a.elapsed_time(b) for a, b in events)
            return ms[len(ms) // 2]

        def roofline(cfg, params, state, b, step):
            """(n3): ``hlo_cost``'s counts of the sharded step against its
            CUDA-event time."""
            with sharding.use_mesh(mesh):
                counts = hlo_cost.analyze(step, params, state, b)
                events = []
                for _ in range(SHARD_TIMED):
                    (params, state, _), ev = timed(
                        lambda: step(params, state, b))
                    events.append(ev)
            measured = median_ms(events)
            six_nd = roof.model_flops_train(cfg,
                                            TRAIN_CUT_BATCH * TRAIN_CUT_SEQ)
            compute_ms = counts["flops"] / roof.PEAK_FLOPS * 1e3
            memory_ms = counts["bytes"] / roof.HBM_BW * 1e3
            bound = max(compute_ms, memory_ms)
            emit(dict(phase="sharded_roofline", config=cfg.name,
                      flops=counts["flops"], bytes=counts["bytes"],
                      collectives=counts["collectives"],
                      model_flops_6nd=six_nd, compute_ms=compute_ms,
                      memory_ms=memory_ms, bound_ms=bound,
                      bound_by="operations" if compute_ms >= memory_ms
                      else "bytes", step_ms_median=measured,
                      share=bound / measured,
                      useful_ratio=six_nd / counts["flops"],
                      peak_flops=roof.PEAK_FLOPS, hbm_bw=roof.HBM_BW))
            if not counts["flops"] > six_nd / 2 or not measured > 0:
                fail(f"sharded roofline: {counts} against 6ND {six_nd}")

        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(get_config(TRAIN_CUT_CONFIG),
                                      num_layers=TRAIN_CUT_LAYERS,
                                      dtype=dtype)
            sch = T.build_schema(cfg)
            specs = sharding.specs_from_schema(sch, sharding.make_rules(
                cfg, mesh_model=1, multi_pod=False))
            opt_cfg = opt_mod.AdamWConfig(
                lr_peak=TRAIN_LR, warmup_steps=2,
                total_steps=TRAIN_CUT_STEPS, eps=SHARD_EPS,
                state_dtype=cfg.opt_state_dtype)
            data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_CUT_SEQ,
                                          TRAIN_CUT_BATCH, seed=LM_SEED))
            batches = [{k: torch.from_numpy(b[k]).to(dev)
                        for k in ("tokens", "labels", "positions")}
                       for b in map(data.batch, range(SHARD_STEPS))]
            step = make_train_step(cfg, opt_cfg)

            def init():
                gen = torch.Generator(device=dev)
                gen.manual_seed(LM_SEED)
                return schema.init_params(sch, gen, getattr(torch, dtype),
                                          dev)

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            params = init()
            state = opt_mod.init_state(opt_cfg, params)
            plain_losses, plain_ev = [], []
            for b in batches:
                (params, state, m), ev = timed(
                    lambda: step(params, state, b))
                plain_losses.append(float(m["loss"]))
                plain_ev.append(ev)
            plain, plain_ms = params, median_ms(plain_ev)
            del state, params
            torch.cuda.empty_cache()

            params = _whole(init(), specs, mesh)
            state = opt_mod.init_state(opt_cfg, params)
            dbatches = [_whole(b, sharding.batch_specs(cfg, "train", False),
                               mesh) for b in batches]
            losses, ev_sharded = [], []
            with sharding.use_mesh(mesh):
                for b in dbatches:
                    (params, state, m), ev = timed(
                        lambda: step(params, state, b))
                    losses.append(float(m["loss"].full_tensor()))
                    ev_sharded.append(ev)
            diff = _tree_diff(torch, params, plain)
            rels = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                         plain_losses)]
            # the gradients at one set of parameters, sharded and not
            same = schema.tree_map(lambda t: t.to_local(), params)
            _, want_g = grads_of(same, cfg, batches[-1])
            with sharding.use_mesh(mesh):
                _, got_g = grads_of(params, cfg, dbatches[-1])
            grad_diff = _tree_diff(torch, got_g, want_g)
            del same, want_g, got_g
            emit(dict(phase="sharded_train", config=cfg.name, dtype=dtype,
                      num_layers=cfg.num_layers, batch=TRAIN_CUT_BATCH,
                      seq=TRAIN_CUT_SEQ, steps=SHARD_STEPS, mesh=[1, 1],
                      eps=SHARD_EPS, losses=losses,
                      plain_losses=plain_losses, loss_rel=rels,
                      params=diff, grads_at_equal_params=grad_diff,
                      bitwise=diff["bitwise_leaves"] == diff["leaves"]
                      and losses == plain_losses,
                      step_ms_median=median_ms(ev_sharded),
                      plain_step_ms_median=plain_ms,
                      peak_bytes=torch.cuda.max_memory_allocated()))
            if not all(np.isfinite(losses)) or rels[0] > SHARD_LOSS_RTOL \
                    or max(rels) > SHARD_STEP_LOSS_RTOL \
                    or diff["max_rel"] > SHARD_PARAM_TOL or (
                        dtype == "float32"
                        and grad_diff["max_rel"] > SHARD_GRAD_TOL):
                fail(f"sharded train ({dtype}): losses {losses} against "
                     f"{plain_losses}, parameters {diff}, gradients at "
                     f"equal parameters {grad_diff}")
            del plain
            if dtype == "bfloat16":     # (n3) on the model's own dtype
                roofline(cfg, params, state, dbatches[0], step)
            del params, state, dbatches, batches, step
            torch.cuda.empty_cache()

        # ---- (n2) deepseek-v3 at published widths, 4 layers: a sharded
        # decode step against the unsharded one
        cfg = dataclasses.replace(get_config(LM_CONFIG), num_layers=LM_LAYERS)
        sch = T.build_schema(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(LM_SEED)
        params = schema.init_params(sch, gen, torch.bfloat16, dev)
        rng = np.random.default_rng(LM_SEED)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (LM_BATCH, SHARD_PROMPT + 1)).astype(
                np.int32)).to(dev)
        max_len = SHARD_PROMPT + 2

        def decode(p, cache, tok_spec, ctx):
            with torch.no_grad(), ctx:
                for t in range(SHARD_PROMPT + 1):
                    cur = torch.tensor(t, dtype=torch.int32, device=dev)
                    tt = toks[:, t:t + 1]
                    if tok_spec is not None:
                        tt = _whole(tt, tok_spec, mesh)
                    logits, _ = T.decode_step(p, cfg, tt, cache, cur)
            return logits

        cache = T.init_cache(cfg, LM_BATCH, max_len, device=dev)
        want = decode(params, cache, None, contextlib.nullcontext())
        dparams = _whole(params, sharding.specs_from_schema(
            sch, sharding.make_rules(cfg, mesh_model=1, multi_pod=False)),
            mesh)
        dcache = _whole(T.init_cache(cfg, LM_BATCH, max_len, device=dev),
                        sharding.cache_spec_tree(cfg, 1, False), mesh)
        got = decode(dparams, dcache, sharding.P("data", None),
                     sharding.use_mesh(mesh)).full_tensor()
        d = (got - want).abs()
        max_d, mean_d = float(d.max()), float(d.mean())
        max_bound = SHARD_LOGIT_MAX_REL * float(want.abs().max())
        mean_bound = SHARD_LOGIT_MEAN_REL * float(want.std())
        cache_diff = _tree_diff(torch, dcache, cache)
        emit(dict(phase="sharded_decode", config=cfg.name,
                  num_layers=cfg.num_layers, batch=LM_BATCH,
                  steps=SHARD_PROMPT + 1, mesh=[1, 1],
                  logits_bitwise=bool(torch.equal(got, want)),
                  logits_max_abs=max_d, logits_max_bound=max_bound,
                  logits_mean_abs=mean_d, logits_mean_bound=mean_bound,
                  cache=cache_diff))
        if not bool(torch.isfinite(got).all()) or max_d > max_bound \
                or mean_d > mean_bound:
            fail(f"sharded decode: max |diff| {max_d} (bound {max_bound}), "
                 f"mean {mean_d} (bound {mean_bound})")
        del params, dparams, cache, dcache
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # ---- (n4) the mini dry run, in a process of its own (its fake process
    # group never meets this one's NCCL group)
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mini",
         "--device", "cuda"], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    if out.returncode != 0:
        fail(f"mini dry run: {out.stderr[-2000:]}")
    mini = json.loads(out.stdout.strip().splitlines()[-1])
    emit(dict(phase="mini_dryrun", seconds=time.perf_counter() - t, **mini))
    if not (mini["flops"] > 0 and mini["collective_bytes"] > 0):
        fail(f"mini dry run: no FLOPs or no collective bytes: {mini}")
    emit(dict(phase="lm_sharded_seconds",
              seconds=time.perf_counter() - t_phase))


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
    from repro_torch.sparse.formats import CSR, spgemm_dense_oracle

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
    if "--lm-only" in sys.argv[1:]:
        lm_serving(torch, np, dev)
        lm_recurrent(torch, np, dev)
        lm_training(torch, np, dev)
        lm_sharded(torch, np, dev)
        return 0
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
               fa_k.flash_attention_mma,
               acc_k.fused_flop_symbolic_bitmask_buckets,
               sym_k.exact_row_counts_esc, acc_k.exact_row_counts_bitmask)
    names = [k.__name__ for k in kernels]
    launches = {path: dict.fromkeys(names, 0)
                for path in ("predict", "plan_esc", "plan_auto", "replan",
                             "templates", "panels", "global_predict",
                             "profiles", "measured_routes", "watchdog",
                             "service", "mesh", "global_bitmask",
                             "global_spgemm",
                             "experiment",
                             "attention", "lm_serving", "lm_recurrent",
                             "train", "lm_sharded")}

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

    # ---- (l) the LM serving path first, on an empty card (it holds 31.6 GB
    # of weights and up to ~9 GB of dispatch buffers, all freed after); it
    # reaches no kernel of the port, as the JAX package's model reaches
    # none of its Pallas kernels
    _, counts = drive("lm_serving", lambda: lm_serving(torch, np, dev))
    if any(counts.values()):
        fail(f"a kernel of the port launched on the LM serving path: {counts}")
    # ---- (m) the recurrent families served, then training: no kernel of
    # the port either
    for path, phase in (("lm_recurrent", lm_recurrent),
                        ("train", lm_training), ("lm_sharded", lm_sharded)):
        _, counts = drive(path, lambda: phase(torch, np, dev))
        if any(counts.values()):
            fail(f"a kernel of the port launched on path {path}: {counts}")

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
    auto_csr = {}       # matrix -> (c)'s reassembled host CSR, for (h), (i)
    auto_secs = {}      # matrix -> (c)'s seconds and peak bytes, for (i)
    auto_routes = {}    # matrix -> (c)'s bucket routes, for (j)
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
        esc_samples = int(np.isin(pa.binning.row_bucket[pa.sample_rows],
                                  esc_buckets).sum())
        auto_runs[name] = (pa.binning.route_rows(), counts, esc_samples,
                           pa.sample_rows.size - esc_samples)
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
        if int(outa.overflow) == 0:     # (h) holds its runs to a whole C
            auto_csr[name] = ca
        auto_secs[name] = secs
        auto_routes[name] = [bk.route for bk in pa.binning.buckets]
        del p, out, pa, outa, ca, ad
        torch.cuda.empty_cache()

    # ---- (h) re-planning on overflow and plan templates.  The seven
    # products planned at the 8-slot floor (safety 0), so the numeric wave
    # overflows and execute re-plans: by RetryPolicy()'s ladder, by the
    # legacy retry_safety=1.5, and by the exact-symbolic fallback alone
    # (RetryPolicy(rounds=0): kernels 2 and 4 count the offending buckets'
    # rows); then pop_quant=True at the smoke's safety.  Each result is held
    # to (c)'s auto run of the same product and sample rows.
    numeric_kernels = (num_k.spgemm_numeric, acc_k.spa_numeric,
                       acc_k.bin_numeric)

    def numeric_launches():
        return sum(k.launches for k in numeric_kernels)

    class CountingCache(plan.PlanCache):
        """A plan cache that notes at each executor lookup the numeric
        kernels' launches so far: each call's launches (the wave's, then
        each re-run bucket's) are the differences."""

        def __init__(self):
            super().__init__()
            self.marks = []

        def executor(self, key, build):
            self.marks.append((key[0], numeric_launches()))
            return super().executor(key, build)

        def calls(self):
            ends = [n for _, n in self.marks[1:]] + [numeric_launches()]
            return [(k, e - n) for (k, n), e in zip(self.marks, ends)]

    def csr_matches(got, want):
        """(structure equal, val within VAL_RTOL (+ VAL_ATOL_REL × the
        row's largest |value|), val bitwise) of two host CSRs."""
        if not (np.array_equal(got.rpt, want.rpt)
                and np.array_equal(got.col, want.col)):
            return False, False, False
        lens = np.diff(want.rpt)
        vmax = np.zeros(want.nrows, dtype=np.float32)
        if want.nnz:
            vmax[lens > 0] = np.maximum.reduceat(np.abs(want.val),
                                                 want.rpt[:-1][lens > 0])
        close = bool((np.abs(got.val - want.val)
                      <= VAL_RTOL * np.abs(want.val)
                      + VAL_ATOL_REL * np.repeat(vmax, lens)).all())
        return True, close, np.array_equal(got.val.view(np.int32),
                                           want.val.view(np.int32))

    def run_replan(m, cache, **opts):
        """plan → execute (re-planning) → reassemble on the card: the plan,
        its capacities before the run, the output, the host CSR and
        host-clock seconds and peak device bytes as run_plan measures
        them."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        p = plan.plan_spgemm(m, m, use_kernel=True, device=dev, **opts)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t
        caps0 = list(p.alloc.bucket_capacities)
        t = time.perf_counter()
        out = plan.execute(p, m, m, cache=cache)
        torch.cuda.synchronize()
        t_exec = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        return p, caps0, out, plan.reassemble(p, out), dict(
            plan_s=t_plan, execute_s=t_exec, peak_bytes=peak)

    replan_modes = (
        ("policy", dict(safety=0.0, retry_policy=plan.RetryPolicy())),
        ("legacy", dict(safety=0.0, retry_safety=1.5)),
        ("fallback", dict(safety=0.0,
                          retry_policy=plan.RetryPolicy(rounds=0))),
        ("pop_quant", dict(safety=SAFETY, pop_quant=True,
                           retry_policy=plan.RetryPolicy())))
    largest = {}        # kernel -> (rows, matrix, bucket, FLOP bound) of the
    #                     largest bucket the fallback counted on the card
    for name, m in mats:
        if name not in auto_csr:
            fail(f"replan {name}: (c)'s auto run overflowed at safety "
                 f"{SAFETY}, so there is no whole product to hold (h) to")
        want_c = auto_csr[name]
        for mode, opts in replan_modes:
            cache = CountingCache()
            (p, caps0, out, c, secs), counts = drive(
                "replan", lambda: run_replan(m, cache, **opts))
            structure, close, bitwise = csr_matches(c, want_c)
            if not (structure and close) or int(out.overflow):
                fail(f"replan {name} {mode}: reassembled CSR != (c)'s auto "
                     "run")
            n = out.row_nnz.cpu().numpy().astype(np.int64)
            buckets = p.binning.buckets
            over = {i for i, bk in enumerate(buckets)
                    if bk.n_rows and int(n[bk.rows].max()) > caps0[i]}
            rerun = ([e["bucket"] for e in p.retry_events]
                     + [d["bucket"] for d in p.degradations])
            # the wave launches one numeric kernel a bucket, each re-run
            # bucket one more: only the overflowing buckets re-launch
            calls = cache.calls()
            if (calls[0] != ("spgemm-plan", sum(
                    1 for t_ in p.host_tables() if t_.size))
                    or [k for k, _ in calls[1:]]
                    != ["bucket-retry"] * len(rerun)
                    or any(x != 1 for _, x in calls[1:])
                    or sorted(rerun) != sorted(over)):
                fail(f"replan {name} {mode}: re-launched buckets {rerun} "
                     f"({calls}) != the overflowing ones {sorted(over)}")
            rounds = [calls[0][1]] + [
                sum(1 for e in p.retry_events if e["round"] == r)
                for r in range(1, p.retries + 1)]
            if p.degradations:
                rounds.append(len(p.degradations))
            line = dict(phase="replan", matrix=name, mode=mode,
                        buckets=len(buckets), overflowing=sorted(over),
                        retries=p.retries, retry_events=len(p.retry_events),
                        degradations=len(p.degradations),
                        numeric_launches_per_round=rounds,
                        row_capacity=p.alloc.row_capacity,
                        equals_auto_run=True, val_bitwise=bitwise,
                        builds=cache.traces, launches=counts, **secs)
            if mode == "pop_quant":
                line["row_padding"] = p.stats()["row_padding"]
                if line["row_padding"] > 2:
                    fail(f"replan {name}: row padding "
                         f"{line['row_padding']} > 2")
            if mode == "fallback":
                if not p.degradations or p.retry_events:
                    fail(f"replan {name}: the fallback alone did not run")
                # kernels 2 and 4's per-row counts over each offending
                # bucket against its numeric row_nnz and the plain counts
                ad = p.to_device(m, "a")
                for d in p.degradations:
                    bk = buckets[d["bucket"]]
                    kw = dict(max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
                              route=bk.route, span=bk.span)
                    got = predictor.exact_row_counts(
                        ad, ad, bk.rows, use_kernel=True,
                        row_flop=p.flopr[bk.rows], **kw)
                    plain_counts = predictor.exact_row_counts(ad, ad, bk.rows,
                                                              **kw)
                    if not (np.array_equal(got, n[bk.rows])
                            and np.array_equal(got, plain_counts)
                            and int(got.max()) == d["need"]):
                        fail(f"replan {name}: exact counts of bucket "
                             f"{d['bucket']} != numeric row_nnz/plain")
                    mode_of = ("esc" if bk.route == binning.ROUTE_ESC
                               else "bitmask")
                    if bk.n_rows > largest.get(mode_of, (0,))[0]:
                        largest[mode_of] = (bk.n_rows, name, bk,
                                            p.flopr[bk.rows])
                line["exact_counts_equal_row_nnz_and_plain"] = True
                del ad
            if mode != "pop_quant":
                # the bumped plan again: right the first time, no retries
                del out, c
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = plan.execute(p, m, m, cache=cache)
                torch.cuda.synchronize()
                line["execute_s_no_retry"] = time.perf_counter() - t
                if (p.retries or p.degradations or int(out.overflow)
                        or not np.array_equal(out.row_nnz.cpu().numpy(), n)):
                    fail(f"replan {name} {mode}: the bumped plan re-planned")
            emit(line)
            del p, out
            torch.cuda.empty_cache()
        del want_c
    for k in ("exact_row_counts_esc", "exact_row_counts_bitmask",
              "spgemm_numeric", "spa_numeric", "bin_numeric"):
        if launches["replan"][k] <= 0:
            fail(f"kernel {k} was not launched on main path replan")
    if any(launches["replan"][k] for k in (
            "flop_rows", "fused_flop_symbolic", "fused_flop_symbolic_bitmask")):
        fail("a per-bucket kernel-1, 2 or 4 launch on path replan")

    # templates: two families of three members, each planned through
    # template="auto" (a registry and a cache of its own) until a pass of
    # the three after the template's last growth: there every member keeps
    # one key, hits the cache and builds nothing.  Each member's CSR equals
    # its direct plan's.
    for fam, gen, seeds in TEMPLATE_FAMILIES:
        members = [(s, gen(sprand, s)) for s in seeds]
        direct = {}
        for s, m in members:
            pd = plan.plan_spgemm(m, m, use_kernel=True, device=dev,
                                  retry_policy=plan.RetryPolicy())
            direct[s] = plan.reassemble(pd, plan.execute(
                pd, m, m, cache=plan.PlanCache()))
            del pd
        reg, cache = plan.TemplateRegistry(), plan.PlanCache()
        passes = []
        for _ in range(TEMPLATE_PASSES):
            rec = []
            for s, m in members:
                tpl = reg.lookup(m, m)
                g0 = tpl.growths if tpl is not None else 0
                hits0, builds0 = cache.hits, cache.traces
                (p, caps0, out, c, secs), counts = drive(
                    "templates", lambda: run_replan(
                        m, cache, template="auto", registry=reg,
                        retry_policy=plan.RetryPolicy()))
                structure, close, bitwise = csr_matches(c, direct[s])
                if not (structure and close):
                    fail(f"templates {fam} seed {s}: CSR != its direct "
                         "plan's")
                rec.append(dict(seed=s, key=plan._plan_key_id(p),
                                hits=cache.hits - hits0,
                                builds=cache.traces - builds0,
                                growths=p._template.growths - g0,
                                retries=p.retries,
                                degradations=len(p.degradations),
                                row_padding=p.stats()["row_padding"],
                                val_bitwise=bitwise, launches=counts,
                                **secs))
                del p, out, c
            passes.append(rec)
            if (len({r["key"] for r in rec}) == 1
                    and all(r["hits"] == 1 and r["builds"] == 0
                            and r["growths"] == 0 for r in rec)):
                break
        else:
            fail(f"templates {fam}: no pass after the last growth shares "
                 f"one key without a build ({passes})")
        if reg.stats()["misses"] != 1:
            fail(f"templates {fam}: members resolved to {reg.stats()}")
        emit(dict(phase="templates", family=fam, seeds=list(seeds),
                  registry=reg.stats(), passes=passes, steady_pass=len(passes),
                  equals_direct_plan=True))
        del members, direct
        torch.cuda.empty_cache()

    # pad rows: a banded member with a hub row 0, planned against the
    # power-law family's template, leaves template buckets empty; each
    # launches row 0 under its own narrow bounds, at row 0's FLOP.  Every
    # padded table through its route's kernel against the plain numeric
    # phase on the same table, and the member's product against its
    # direct plan's
    gen, seed = TEMPLATE_FAMILIES[0][1], TEMPLATE_FAMILIES[0][2][0]
    m0 = gen(sprand, seed)
    n = m0.nrows
    band = sprand.banded(n, n, 6, 8, seed=PAD_ROW_SEED)
    hub = np.random.default_rng(PAD_ROW_SEED).choice(
        np.arange(1, n), min(PAD_ROW_HUB, n - 1), replace=False)
    coo_rows = np.concatenate([np.zeros(hub.size, np.int64),
                               np.repeat(np.arange(n), np.diff(band.rpt))])
    member = CSR.from_coo(
        coo_rows, np.concatenate([hub, band.col.astype(np.int64)]),
        np.random.default_rng(PAD_ROW_SEED).standard_normal(
            coo_rows.size).astype(np.float32), (n, n))
    tpl = plan.PlanTemplate.from_plan(plan.plan_spgemm(
        m0, m0, pop_quant=True, use_kernel=True, device=dev))
    (p, caps0, out, c, secs), counts = drive(
        "templates", lambda: run_replan(member, plan.PlanCache(),
                                        template=tpl,
                                        retry_policy=plan.RetryPolicy()))
    pd = plan.plan_spgemm(member, member, use_kernel=True, device=dev,
                          retry_policy=plan.RetryPolicy())
    structure, close, bitwise = csr_matches(c, plan.reassemble(
        pd, plan.execute(pd, member, member, cache=plan.PlanCache())))
    empty = [i for i, bk in enumerate(p.binning.buckets) if not bk.n_rows]
    if not (structure and close) or not empty or any(
            p.flop_bounds()[i] != int(p.flopr[0]) for i in empty):
        fail(f"pad rows: product != its direct plan's, or no empty bucket "
             f"({empty}) launched row 0 at its FLOP")
    ad = p.to_device(member, "a")
    rnb = torch.diff(ad.rpt)
    for bk, cap, table, bound in zip(p.binning.buckets,
                                     p.alloc.bucket_capacities,
                                     p.device_args(), p.flop_bounds()):
        kw = dict(row_capacity=cap, deg_a=bk.deg_a, deg_b=bk.deg_b,
                  route=bk.route, tile_n=bk.tile_n, n_tiles=bk.n_tiles,
                  span=bk.span)
        got = spgemm.routed_spgemm_rows(ad, ad, table, use_kernel=True,
                                        max_row_flop=bound, rownnz_b=rnb,
                                        **kw)
        want = spgemm.routed_spgemm_rows(ad, ad, table, **kw)
        if not (torch.equal(got.col, want.col)
                and torch.equal(got.row_nnz, want.row_nnz)
                and int(got.overflow) == int(want.overflow)
                and vals_close(got.val, want.val)):
            fail(f"pad rows: a padded {bk.route} table of width "
                 f"{bk.deg_a}x{bk.deg_b} kernel != plain")
    emit(dict(phase="pad_rows", rows=n, hub=int(hub.size),
              buckets=len(p.binning.buckets), empty_buckets=empty,
              row0_flop=int(p.flopr[0]),
              populations=list(p.local_populations()),
              routes=[bk.route for bk in p.binning.buckets],
              tables_equal_plain=True, equals_direct_plan=True,
              val_bitwise=bitwise, launches=counts, **secs))
    del m0, band, member, tpl, p, pd, out, c, ad, rnb, got, want
    torch.cuda.empty_cache()

    # ---- (i) column panels and fault injection.  Each product planned with
    # n_panels=4 (and 2 on rmat_80k and band_60k_d16): every (bucket ×
    # panel) unit one launch of its bucket's numeric kernel against that
    # panel's operand, each block held to the plain numeric phase on the
    # same operand, the reassembled CSR to (c)'s.  Then re-planning per unit
    # at n_panels=4, and the fault classes on an ESC and a SPA product
    from repro_torch.core import faults
    from repro_torch.core.errors import (CapacityExhaustedError,
                                         ShardFailureError)
    predict_kernels = ("flop_rows_buckets", "fused_flop_symbolic_buckets",
                       "fused_flop_symbolic_bitmask_buckets")

    def run_panels(m, n_panels, cache, **opts):
        """plan → execute → reassemble of a panel plan on the card, as
        run_plan measures them, with the panel caps before the run."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        p = plan.plan_spgemm(m, m, use_kernel=True, device=dev,
                             n_panels=n_panels, **opts)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t
        caps0 = p.panel_caps.copy()
        t = time.perf_counter()
        out = plan.execute(p, m, m, cache=cache)
        torch.cuda.synchronize()
        t_exec = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        t = time.perf_counter()
        c = plan.reassemble(p, out)
        t_reasm = time.perf_counter() - t
        return p, caps0, out, c, dict(plan_s=t_plan, execute_s=t_exec,
                                      reassemble_s=t_reasm, peak_bytes=peak)

    def launched_units(p):
        """The (bucket × panel) units the wave launches: real rows and
        products in the panel."""
        bounds = p.panel_flop_bounds()
        return [(i, q) for i, bk in enumerate(p.binning.buckets)
                for q in range(p.n_panels)
                if p.host_tables()[i].size and bounds[i][q]]

    def hold_blocks(p, m, out, what):
        """Every block against the plain numeric phase of its bucket's
        route on the same panel operand, on the card: the largest |val|
        difference by numeric kernel."""
        ad = p.to_device(m, "a")
        bps = plan._panel_operands_local(p, m)
        err = {}
        for i, (bk, table) in enumerate(zip(p.binning.buckets,
                                            p.device_args())):
            rows = table[:bk.n_rows]
            for q, bp in enumerate(bps):
                cap = int(p.panel_caps[i, q])
                meta = plan._panel_meta(bk, p.panel_deg_b[i], cap)
                want = spgemm.routed_spgemm_rows(
                    ad, bp, rows, row_capacity=cap, deg_a=meta[0],
                    deg_b=meta[1], route=bk.route, tile_n=bk.tile_n,
                    n_tiles=bk.n_tiles, span=bk.span)
                got_v = out.vals[i][q]
                if not (torch.equal(out.cols[i][q], want.col)
                        and torch.equal(out.row_nnz[i][q], want.row_nnz)
                        and vals_close(got_v, want.val)):
                    fail(f"{what}: bucket {i} ({bk.route}) panel {q} block "
                         "!= the plain numeric phase on the panel operand")
                k = ("spgemm_numeric" if bk.route == binning.ROUTE_ESC
                     else f"{bk.route}_numeric")
                err[k] = max(err.get(k, 0.0), float(
                    (got_v - want.val).abs().max()) if got_v.numel() else 0.0)
                del want, got_v
        del ad, bps
        return err

    def block_bytes(p):
        """Bytes of the panel blocks (col and val, 8 a slot)."""
        return int(sum(bk.n_rows * int(p.panel_caps[i, q]) * 8
                       for i, bk in enumerate(p.binning.buckets)
                       for q in range(p.n_panels)))

    panel_err = {}
    for name, m in mats:
        want_c = auto_csr[name]
        for n_panels in (4, 2) if name in ("rmat_80k", "band_60k_d16") \
                else (4,):
            cache = CountingCache()
            (p, caps0, out, c, secs), counts = drive(
                "panels", lambda: run_panels(m, n_panels, cache,
                                             safety=SAFETY))
            structure, close, bitwise = csr_matches(c, want_c)
            if not (structure and close) or int(out.overflow):
                fail(f"panels {name} P={n_panels}: CSR != (c)'s auto run")
            units = launched_units(p)
            calls = cache.calls()
            if calls != [("spgemm-plan-panels", len(units))]:
                fail(f"panels {name} P={n_panels}: numeric launches {calls}, "
                     f"not one for each of the {len(units)} units")
            want_pred = {k: auto_runs[name][1][k] for k in predict_kernels}
            if {k: counts[k] for k in predict_kernels} != want_pred:
                fail(f"panels {name} P={n_panels}: prediction launches "
                     f"{counts} != (c)'s {want_pred}")
            for k, v in hold_blocks(p, m, out, f"panels {name}").items():
                panel_err[k] = max(panel_err.get(k, 0.0), v)
            # the same plan again: the panel structure is on the card
            # already and the FLOP bounds are cached, as a serving pair
            # finds them
            del out
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, again = drive("panels", lambda: plan.execute(p, m, m,
                                                              cache=cache))
            torch.cuda.synchronize()
            secs["execute_s_again"] = time.perf_counter() - t
            if (sum(again[k] for k in ("spgemm_numeric", "spa_numeric",
                                       "bin_numeric")) != len(units)
                    or cache.traces != 1):
                fail(f"panels {name} P={n_panels}: the plan again launched "
                     f"{again} with {cache.traces} builds")
            csec = auto_secs[name]
            emit(dict(phase="panels", matrix=name, n_panels=n_panels,
                      edges=[int(e) for e in p.panels.edges],
                      buckets=len(p.binning.buckets), units=len(units),
                      units_without_products=len(p.binning.buckets)
                      * n_panels - len(units),
                      panel_block_bytes=block_bytes(p),
                      c_execute_s=csec["execute_s"],
                      c_peak_bytes=csec["peak_bytes"],
                      c_output_bytes=m.nrows * 8 * p.alloc.row_capacity,
                      equals_auto_run=True, val_bitwise=bitwise,
                      blocks_equal_plain=True, builds=cache.traces,
                      launches=counts, **secs))
            del p, out, c
            torch.cuda.empty_cache()

        # re-planning per (bucket × panel) unit, at 4 panels
        for mode, opts in (
                ("policy", dict(safety=0.0,
                                retry_policy=plan.RetryPolicy())),
                ("fallback", dict(safety=0.0,
                                  retry_policy=plan.RetryPolicy(rounds=0))),
                ("pop_quant", dict(safety=SAFETY, pop_quant=True,
                                   retry_policy=plan.RetryPolicy()))):
            cache = CountingCache()
            (p, caps0, out, c, secs), counts = drive(
                "panels", lambda: run_panels(m, 4, cache, **opts))
            structure, close, bitwise = csr_matches(c, want_c)
            if not (structure and close) or int(out.overflow):
                fail(f"panels {name} {mode}: CSR != (c)'s auto run")
            n = [[x.cpu().numpy() for x in bn] for bn in out.row_nnz]
            over = sorted((i, q) for i, bk in enumerate(p.binning.buckets)
                          if bk.n_rows for q in range(4)
                          if int(n[i][q].max()) > caps0[i, q])
            rerun = sorted([(e["bucket"], e["panel"]) for e in p.retry_events]
                           + [(d["bucket"], d["panel"])
                              for d in p.degradations])
            calls = cache.calls()
            if (calls[0] != ("spgemm-plan-panels", len(launched_units(p)))
                    or calls[1:] != [("bucket-retry-panel", 1)] * len(rerun)
                    or rerun != over):
                fail(f"panels {name} {mode}: re-launched units {rerun} "
                     f"({calls}) != the overflowing ones {over}")
            line = dict(phase="panels_replan", matrix=name, mode=mode,
                        n_panels=4, units=len(launched_units(p)),
                        overflowing=len(over), retries=p.retries,
                        retry_events=len(p.retry_events),
                        degradations=len(p.degradations),
                        panel_block_bytes=block_bytes(p),
                        equals_auto_run=True, val_bitwise=bitwise,
                        builds=cache.traces, launches=counts, **secs)
            if mode == "fallback":
                # one count launch (kernel 2 or 4) a starved unit
                n_counts = (counts["exact_row_counts_esc"]
                            + counts["exact_row_counts_bitmask"])
                if (not p.degradations or p.retry_events
                        or n_counts != len(p.degradations)):
                    fail(f"panels {name} fallback: {n_counts} count launches "
                         f"for {len(p.degradations)} starved units")
                # kernels 2 and 4's per-row counts over each starved unit,
                # on its panel operand at the panel deg_b and FLOP, against
                # the unit's numeric row_nnz and the plain counts: an
                # over-count would only widen the capacity, so the CSR
                # check above cannot see it
                ad = p.to_device(m, "a")
                bps = plan._panel_operands_local(p, m)
                for d in p.degradations:
                    i, q = d["bucket"], d["panel"]
                    bk = p.binning.buckets[i]
                    kw = dict(max_deg_a=bk.deg_a,
                              max_deg_b=p.panel_deg_b[i], route=bk.route,
                              span=bk.span)
                    got = predictor.exact_row_counts(
                        ad, bps[q], bk.rows, use_kernel=True,
                        row_flop=p._panel_flopr[q][bk.rows], **kw)
                    plain_counts = predictor.exact_row_counts(
                        ad, bps[q], bk.rows, **kw)
                    if not (np.array_equal(got, n[i][q])
                            and np.array_equal(got, plain_counts)
                            and int(got.max()) == d["need"]):
                        fail(f"panels {name} fallback: exact counts of unit "
                             f"({i}, {q}) != its numeric row_nnz/plain")
                line["exact_counts_equal_row_nnz_and_plain"] = True
                del ad, bps
            if mode == "pop_quant":
                line["row_padding"] = p.stats()["row_padding"]
            emit(line)
            del p, out, c
            torch.cuda.empty_cache()
    for k in ("spgemm_numeric", "spa_numeric", "bin_numeric",
              "exact_row_counts_esc", "exact_row_counts_bitmask"):
        if launches["panels"][k] <= 0:
            fail(f"kernel {k} was not launched on main path panels")
    if any(launches["panels"][k] for k in (
            "flop_rows", "fused_flop_symbolic", "fused_flop_symbolic_bitmask")):
        fail("a per-bucket kernel-1, 2 or 4 launch on path panels")

    # faults: each class on an ESC product and a SPA one, the expected
    # outcome or the run fails
    fault_cases = (
        ("capacity", dict(capacity_scale=0.2),
         dict(retry_policy=plan.RetryPolicy(rounds=2)), None),
        ("sketch", dict(sketch_scale=0.05),
         dict(retry_policy=plan.RetryPolicy(rounds=2)), None),
        ("gather", dict(gather_scale=0.25), dict(n_panels=2),
         CapacityExhaustedError),
        ("executor", dict(fail_executor={"unit": "local"}), {},
         ShardFailureError),
        ("executor_panels", dict(fail_executor={"unit": "local-panels"}),
         dict(n_panels=4), ShardFailureError))

    def run_fault(m, inj, opts):
        with faults.inject(**inj):
            p = plan.plan_spgemm(m, m, use_kernel=True, device=dev,
                                 safety=SAFETY, **opts)
            out = plan.execute(p, m, m, cache=plan.PlanCache())
            return p, out, plan.reassemble(p, out)

    for name in ("pl_100k_d4", "band_60k_d16"):
        m = dict(mats)[name]
        for fault, inj, opts, err in fault_cases:
            line = dict(phase="faults", matrix=name, fault=fault)
            t = time.perf_counter()
            try:
                (p, out, c), counts = drive(
                    "panels", lambda: run_fault(m, inj, opts))
            except Exception as exc:     # the typed error is the outcome
                if err is None or type(exc) is not err:
                    raise
                ctx = exc.context
                if err is CapacityExhaustedError and not (
                        "panel" in ctx and ctx["observed"] > ctx["planned"]):
                    fail(f"faults {name} {fault}: context {ctx}")
                if err is ShardFailureError and not (
                        isinstance(exc.__cause__, faults.InjectedFault)
                        and ctx == inj["fail_executor"]):
                    fail(f"faults {name} {fault}: {exc!r} from "
                         f"{exc.__cause__!r}")
                line.update(outcome=type(exc).__name__, context=ctx,
                            cause=type(exc.__cause__).__name__
                            if exc.__cause__ else None)
            else:
                if err is not None:
                    fail(f"faults {name} {fault}: no {err.__name__}")
                structure, close, bitwise = csr_matches(c, auto_csr[name])
                if not (structure and close) or int(out.overflow):
                    fail(f"faults {name} {fault}: CSR != (c)'s auto run")
                line.update(outcome="equals_auto_run", val_bitwise=bitwise,
                            retries=p.retries,
                            retry_events=len(p.retry_events),
                            degradations=len(p.degradations),
                            launches=counts)
                del p, out, c
            if faults.armed():
                fail(f"faults {name} {fault}: a fault stayed armed")
            line["seconds"] = time.perf_counter() - t
            emit(line)
            torch.cuda.empty_cache()
    emit(dict(phase="panels_checked", max_abs_err=panel_err))

    # ---- (j) measured route profiles, the straggler watchdog with
    # single-device recovery, and the SpGEMM service.  (j1) times every
    # route on the card (the numeric kernels 3/5/6 and the count modes
    # 2c/4c) into a profile; (j2) plans the seven products under it; (j3)
    # arms DispatchBudget() on them, whole-B and at 4 panels, under the
    # analytic and the measured model (no clean run may trip), then delays
    # the wave and holds the replay to the clean run bit for bit; (j4)
    # serves (h)'s template families at full size, each result bitwise
    # equal to a direct run; (j5) runs the service's chaos classes on the
    # small families.  The active profile is cleared on the way out.
    import tempfile
    from repro_torch.core import profiles
    from repro_torch.core.errors import SpgemmError
    from repro_torch.serve import admission
    from repro_torch.serve import spgemm_service as svc_mod
    ready = numeric_kernels + (sym_k.exact_row_counts_esc,
                               acc_k.exact_row_counts_bitmask)

    def require_launched(path, kinds):
        for k in kinds:
            if launches[path][k] <= 0:
                fail(f"kernel {k} was not launched on main path {path}")

    def track_reservations(service):
        """The most a service's memory budget holds at once, noted at each
        reservation (``["max"]``, reset by the caller)."""
        budget = service._budget
        seen = dict(max=0)
        reserve = budget.reserve

        def noting(est):
            reserve(est)
            seen["max"] = max(seen["max"], budget.reserved)

        budget.reserve = noting
        return seen

    def routes_of(p):
        return {r: sum(1 for bk in p.binning.buckets if bk.route == r)
                for r in binning.ROUTES}

    try:
        # (j1) the profile, on the card's kernels
        t = time.perf_counter()
        prof, counts = drive("profiles", profiles.microbenchmark)
        secs = time.perf_counter() - t
        require_launched("profiles", [k.__name__ for k in ready])
        if prof.device_kind != kind or {c["route"] for c in prof.cells} \
                != set(binning.ROUTES) or not all(
                    c["numeric_s"] > 0 and c["symbolic_s"] > 0
                    for c in prof.cells):
            fail(f"profile: kind {prof.device_kind!r} or cells {prof.cells}")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "profile.json")
            profiles.save(prof, path)
            back = profiles.load(path)
            if (back is None or back.cells != prof.cells
                    or profiles.status()["source"] != "measured"):
                fail(f"profile: save/load round trip {profiles.status()}")
            host = os.path.join(tmp, "host.json")
            profiles.save(dataclasses.replace(prof, device_kind="cpu"), host)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if profiles.load(host, activate=False) is not None or not any(
                        issubclass(w.category, profiles.ProfileLoadWarning)
                        for w in caught):
                    fail("profile: a host profile loaded on the card")
        emit(dict(phase="profile", device_kind=prof.device_kind,
                  flops=prof.flops, bytes_per_s=prof.bytes_per_s,
                  cells=list(prof.cells), seconds=secs, round_trip=True,
                  host_profile_refused=True, launches=counts))

        # (j2) the seven products under the measured model, held to (c);
        # then each model's plan executed twice in turns (analytic,
        # measured), the second execute timed: a first execute builds
        # executors and allocates workspaces
        def second_execute_s(m, model):
            profiles.set_active(prof if model == "measured" else None)
            p = plan.plan_spgemm(m, m, use_kernel=True, device=dev,
                                 safety=SAFETY)
            cache = plan.PlanCache()
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                plan.execute(p, m, m, cache=cache)
                torch.cuda.synchronize()
            return time.perf_counter() - t

        profiles.set_active(prof)
        measured = {}       # matrix -> bucket routes under the profile
        for name, m in mats:
            (p, out, c, secs), counts = drive(
                "measured_routes", lambda: run_plan(m, "auto"))
            structure, close, bitwise = csr_matches(c, auto_csr[name])
            same = [bk.route for bk in p.binning.buckets] == auto_routes[name]
            if not (structure and close) or int(out.overflow) or (
                    same and not bitwise):
                fail(f"measured_routes {name}: CSR != (c)'s auto run "
                     f"(same routes {same}, val bitwise {bitwise})")
            measured[name] = [bk.route for bk in p.binning.buckets]
            measured_buckets = routes_of(p)
            del p, out, c
            torch.cuda.empty_cache()
            again, _ = drive("measured_routes", lambda: {
                model: second_execute_s(m, model)
                for model in ("analytic", "measured")})
            profiles.set_active(prof)
            torch.cuda.empty_cache()
            emit(dict(phase="measured_routes", matrix=name,
                      analytic_buckets={r: auto_routes[name].count(r)
                                        for r in binning.ROUTES},
                      measured_buckets=measured_buckets,
                      changed=sum(x != y for x, y in zip(
                          measured[name], auto_routes[name])),
                      analytic_execute_s=auto_secs[name]["execute_s"],
                      execute_s=secs["execute_s"],
                      analytic_execute_s_again=again["analytic"],
                      execute_s_again=again["measured"],
                      equals_auto_run=True, val_bitwise=bitwise,
                      launches=counts))

        # (j3) the watchdog: two clean runs of each armed plan, under each
        # model; then an injected delay on each wave kind
        def run_armed(m, n_panels, cache, reps):
            p = plan.plan_spgemm(m, m, use_kernel=True, device=dev,
                                 safety=SAFETY, n_panels=n_panels,
                                 dispatch_budget=plan.DispatchBudget())
            runs = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = plan.execute(p, m, m, cache=cache)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t)
                if p.recoveries:
                    fail(f"watchdog: a clean run tripped ({p.recoveries})")
            return p, out, runs

        for model in ("analytic", "measured"):
            profiles.set_active(prof if model == "measured" else None)
            for name, m in mats:
                for n_panels in (0, 4):
                    (p, out, runs), counts = drive(
                        "watchdog", lambda: run_armed(m, n_panels,
                                                      plan.PlanCache(), 2))
                    priced = plan._plan_priced_seconds(p)
                    emit(dict(phase="watchdog", model=model, matrix=name,
                              n_panels=n_panels, priced_s=priced,
                              limit_s=p.dispatch_budget.limit(priced),
                              execute_s=runs, recoveries=0,
                              launches=counts))
                    del p, out
                    torch.cuda.empty_cache()
        profiles.set_active(None)
        for name in ("pl_100k_d4", "band_60k_d16", "rmat_80k"):
            m = dict(mats)[name]
            for n_panels, unit in ((0, "local"), (4, "local-panels")):
                cache = CountingCache()
                (p, out, runs), _ = drive(
                    "watchdog", lambda: run_armed(m, n_panels, cache, 2))
                clean = plan.reassemble(p, out)
                del out
                mark = len(cache.marks)
                t = time.perf_counter()
                with faults.inject(delay_executor={"unit": unit},
                                   delay_s=60.0):
                    out, counts = drive("watchdog", lambda: plan.execute(
                        p, m, m, cache=cache))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                c = plan.reassemble(p, out)
                structure, close, bitwise = csr_matches(c, clean)
                units = ([(i, q) for i in range(len(p.binning.buckets))
                          for q in range(n_panels)] if n_panels
                         else list(range(len(p.binning.buckets))))
                want_led = [dict(kind="wave_failed", unit=unit,
                                 error="StragglerError")] + [
                    dict(kind="unit", bucket=u[0], panel=u[1], attempts=1)
                    if n_panels else dict(kind="unit", bucket=u, attempts=1)
                    for u in units]
                bounds = (p.panel_flop_bounds() if n_panels
                          else p.flop_bounds())
                want_calls = [("bucket-retry-panel" if n_panels
                               else "bucket-retry",
                               int(bool(bounds[u[0]][u[1]] if n_panels
                                        else bounds[u])))
                              for u in units]
                calls = cache.calls()[mark:]
                if not (structure and bitwise) or p.recoveries != want_led \
                        or calls[1:] != want_calls or faults.armed():
                    fail(f"watchdog {name} {unit}: replay bitwise "
                         f"{bitwise}, ledger {p.recoveries}, launches "
                         f"{calls}")
                emit(dict(phase="straggler", matrix=name, unit=unit,
                          units=len(units), clean_execute_s=runs,
                          execute_s=secs, replay_launches=sum(
                              n for _, n in calls[1:]),
                          wave_launches=calls[0][1], val_bitwise=True,
                          ledger_equal=True, launches=counts))
                del p, out, c, clean
                torch.cuda.empty_cache()
        require_launched("watchdog", ["spgemm_numeric", "spa_numeric",
                                      "bin_numeric"])

        # (j4) the service under normal traffic: (h)'s two template families
        # at full size, two copies of each member, then a second pass
        free = torch.cuda.mem_get_info(dev)[0]
        cfg = svc_mod.ServiceConfig(use_kernel=True,
                                    device_budget_bytes=free // 2)
        service = svc_mod.SpgemmService(cfg)
        reserved = track_reservations(service)
        direct_reg, direct_cache = plan.TemplateRegistry(), plan.PlanCache()

        def serve(members):
            reqs = [(service.submit(mm, mm), mm) for _, mm in members
                    for _ in range(SERVICE_COPIES)]
            service.drain()
            return reqs

        fam_lines = []
        for fam, gen, seeds in TEMPLATE_FAMILIES:
            members = [(s, gen(sprand, s)) for s in seeds]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reserved["max"] = 0
            reqs, counts = drive("service", lambda: serve(members))
            peak = torch.cuda.max_memory_allocated() - base
            # admission bounds the card's memory: the most the budget held
            # at once covers the pass's peak above its start
            if reserved["max"] < peak:
                fail(f"service {fam}: reserved at most {reserved['max']} "
                     f"bytes, peak {peak}")
            for r, mm in reqs:
                if r.state != svc_mod.RequestState.DONE:
                    fail(f"service {fam}: request {r.id} {r.state} "
                         f"{r.error!r}")
                pd = plan.plan_spgemm(
                    mm, mm, safety=cfg.safety, seed=cfg.seed,
                    pop_quant=cfg.pop_quant, template="auto",
                    registry=direct_reg, use_kernel=True, device=dev,
                    retry_policy=cfg.retry_policy)
                want = plan.reassemble(pd, plan.execute(pd, mm, mm,
                                                        cache=direct_cache))
                structure, close, bitwise = csr_matches(r.result, want)
                if not (structure and bitwise):
                    fail(f"service {fam}: request {r.id} != its direct run")
                del pd, want
            fam_lines.append((fam, members, dict(
                requests=len(reqs), peak_bytes=peak,
                estimate_total_bytes=max(r.estimate.total_bytes
                                         for r, _ in reqs),
                planned_bytes=max(admission.planned_bytes(r.plan)
                                  for r, _ in reqs),
                output_bytes=max(r.plan.shape_a[0] * r.plan.alloc.row_capacity
                                 * 8 for r, _ in reqs),
                reserve_bytes=max(r.estimate.reserve_bytes for r, _ in reqs),
                device_price_bytes=max(r.estimate.device_bytes
                                       for r, _ in reqs),
                reserved_by=sorted({r.estimate.reserved_by for r, _ in reqs}),
                max_reserved_bytes=reserved["max"], launches=counts)))
            for r, _ in reqs:
                r.result = r.plan = None
            torch.cuda.empty_cache()
        traces = service.stats()["plan_cache"]["traces"]
        again, counts = drive("service", lambda: [
            r for _, members, _ in fam_lines for r in serve(members)])
        if service.stats()["plan_cache"]["traces"] != traces or any(
                r.state != svc_mod.RequestState.DONE for r, _ in again):
            fail(f"service: the second pass built executors "
                 f"({service.stats()['plan_cache']})")
        st = service.stats()
        for fam, _, line in fam_lines:
            emit(dict(phase="service", family=fam, **line))
        emit(dict(phase="service_stats", waves=st["waves"],
                  batched_requests=st["batched_requests"],
                  requeues=st["requeues"], terminal=st["terminal"],
                  latency=st["latency"], plan_cache=st["plan_cache"],
                  templates=st["templates"], second_pass_builds=0,
                  second_pass_launches=counts))
        del service, again, fam_lines
        torch.cuda.empty_cache()
        require_launched("service", ["spgemm_numeric", "spa_numeric"])

        # (j5) the service under faults: tests/test_service.py's chaos
        # classes 1-6 on its five small families (the shard-loss class
        # needs a mesh, which the port does not plan yet)
        chaos_fams = [
            (sprand.erdos_renyi(250, 250, 4, seed=25),
             sprand.erdos_renyi(250, 250, 3, seed=26)),
            (sprand.power_law(300, 300, 5, 1.5, seed=21),
             sprand.power_law(300, 300, 4, 1.6, seed=22)),
            (sprand.rmat(250, 250, 1250, seed=31),
             sprand.rmat(250, 250, 1000, seed=32)),
            (sprand.banded(250, 250, 10, 14, seed=23),
             sprand.banded(250, 250, 8, 12, seed=24)),
            (sprand.banded(160, 160, 40, 30, seed=51),
             sprand.banded(160, 160, 32, 28, seed=52))]
        oracles = [spgemm_dense_oracle(a, b) for a, b in chaos_fams]
        nan = sprand.erdos_renyi(50, 50, 3, seed=7)
        nan.val[nan.val.size // 2] = np.nan

        def chaos():
            out = {}
            svc = svc_mod.SpgemmService(svc_mod.ServiceConfig(
                use_kernel=True, queue_capacity=256, max_batch=4,
                breaker_threshold=3, breaker_cooldown=0.0))
            waves = (("capacity", dict(capacity_scale=0.2)),
                     ("sketch", dict(sketch_scale=0.05)),
                     ("executor", dict(fail_executor={"unit": "local"})),
                     ("composed", dict(capacity_scale=0.3,
                                       sketch_scale=0.5)),
                     ("control", None))
            for round_i, (wave, fault) in enumerate(waves):
                reqs = [(svc.submit(a, b), k) for k, (a, b)
                        in enumerate(chaos_fams) for _ in range(5)]
                reqs.append((svc.submit(nan, nan), None))
                with faults.inject(seed=round_i, **(fault or {})):
                    svc.drain()
                out[wave] = reqs
            panel = svc_mod.SpgemmService(svc_mod.ServiceConfig(
                use_kernel=True, queue_capacity=64, n_panels=2))
            out["gather"] = [(panel.submit(a, b), k) for k, (a, b)
                             in enumerate(chaos_fams) for _ in range(2)]
            with faults.inject(gather_scale=0.25):
                panel.drain()
            rec = svc_mod.SpgemmService(svc_mod.ServiceConfig(
                use_kernel=True, queue_capacity=64, max_batch=4,
                dispatch_budget=plan.DispatchBudget(multiple=50.0,
                                                    floor_s=0.25)))
            for a, b in chaos_fams:
                rec.submit(a, b)
            rec.drain()
            out["straggler"] = [(rec.submit(a, b), k) for k, (a, b)
                                in enumerate(chaos_fams) for _ in range(2)]
            with faults.inject(delay_executor={"unit": "local"},
                               delay_s=30.0):
                rec.drain()
            return out, (svc, panel, rec)

        t = time.perf_counter()
        (out, svcs), counts = drive("service", chaos)
        tally = {}
        for cls, reqs in out.items():
            for r, k in reqs:
                if not r.done or (r.error is None) == (r.result is None):
                    fail(f"chaos {cls}: request {r.id} {r.state}")
                if r.error is not None:
                    if not isinstance(r.error, SpgemmError):
                        fail(f"chaos {cls}: untyped {r.error!r}")
                elif not np.allclose(r.result.to_dense(), oracles[k],
                                     rtol=1e-4, atol=1e-4):
                    fail(f"chaos {cls}: request {r.id} != the dense oracle")
                tally.setdefault(cls, {}).setdefault(r.state, 0)
                tally[cls][r.state] += 1
        if set(tally["straggler"]) != {"DEGRADED"} or any(
                b["trips"] for b in svcs[2].stats()["breakers"]):
            fail(f"chaos straggler: {tally['straggler']}")
        if any(s.stats()["queue"]["depth"] or s.stats()["in_flight"]
               for s in svcs) or faults.armed():
            fail("chaos: a queue did not drain or a fault stayed armed")
        emit(dict(phase="service_chaos", states=tally,
                  seconds=time.perf_counter() - t, launches=counts))
        del out, svcs
    finally:
        profiles.clear()

    # ---- (k) distributed execution on a 4-shard mesh of the one card
    # (make_mesh with devices=[cuda:0] * 4: the whole distributed path —
    # shard tables, per-shard launches, the panel gather, recovery — on one
    # H100, held to the port's single-device run).  (k1) the seven
    # products whole-B and at 2 panels, each CSR held to (c)'s (same sample
    # rows), with the reservation against the measured peak; (k2) a lost
    # shard re-homed, bitwise equal to the clean run; (k3) the service on
    # the mesh: DONE, then DEGRADED under a lost shard, each result bitwise
    # equal to its direct run, the budget's reservations over the peak.
    from repro_torch.core import mesh as mesh_mod
    mesh4 = mesh_mod.make_mesh((4,), ("data",), devices=[dev] * 4)
    k_start = time.perf_counter()

    def mesh_units(p):
        """(bucket × shard) units the wave launches: the shard owns rows of
        the bucket and they have products (in its panel)."""
        bounds = p.shard_flop_bounds()
        return sum(1 for i, t in enumerate(p.shard_tables)
                   for s in range(p.num_shards)
                   if t.valid[s].any() and bounds[i][s])

    def run_mesh(m, n_panels, cache):
        """plan → execute → reassemble on the mesh, then the plan again:
        the plan, its estimate, the CSR, host-clock seconds and the peak
        device bytes of the first run above what was allocated before."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        p = plan.plan_spgemm(m, m, mesh=mesh4, use_kernel=True,
                             safety=SAFETY, n_panels=n_panels,
                             retry_policy=plan.RetryPolicy())
        torch.cuda.synchronize()
        secs = dict(plan_s=time.perf_counter() - t)
        est = admission.estimate_cost(p)
        t = time.perf_counter()
        out = plan.execute(p, m, m, cache=cache)
        torch.cuda.synchronize()
        secs["execute_s"] = time.perf_counter() - t
        t = time.perf_counter()
        c = plan.reassemble(p, out)
        secs["reassemble_s"] = time.perf_counter() - t
        secs["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        overflow = [int(x) for x in out.shard_overflow]
        retries = p.retries
        del out
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plan.execute(p, m, m, cache=cache)
        torch.cuda.synchronize()
        secs["execute_s_again"] = time.perf_counter() - t
        del out
        return p, est, c, secs, overflow, retries

    def val_diffs(p, got, want, limit=5):
        """The first rows where ``val`` is not bitwise, with their routes."""
        bad = np.flatnonzero(got.val.view(np.int32) != want.val.view(np.int32))
        rows = np.unique(np.searchsorted(want.rpt, bad, side="right") - 1)
        return [dict(row=int(r), route=p.binning.buckets[
                    p.binning.row_bucket[r]].route) for r in rows[:limit]]

    for name, m in mats:
        want_c = auto_csr.get(name)
        for n_panels in (0, 2):
            cache = plan.PlanCache()
            (p, est, c, secs, overflow, retries), counts = drive(
                "mesh", lambda: run_mesh(m, n_panels, cache))
            line = dict(phase="mesh", matrix=name, n_panels=n_panels,
                        shards=4, devices=sorted({str(d) for d in
                                                  mesh4.devices}),
                        buckets=len(p.binning.buckets), units=mesh_units(p),
                        imbalance=float(p.partition.imbalance),
                        shard_overflow=overflow, retries=retries)
            if want_c is not None:
                structure, close, bitwise = csr_matches(c, want_c)
                if not (structure and close):
                    fail(f"mesh {name} P={n_panels}: CSR != the single-device "
                         "run")
                line.update(equals_single_device=True, val_bitwise=bitwise,
                            val_diff_rows=([] if bitwise else
                                           val_diffs(p, c, want_c)))
            if est.reserve_bytes < secs["peak_bytes"]:
                fail(f"mesh {name} P={n_panels}: reserved "
                     f"{est.reserve_bytes} bytes under the peak "
                     f"{secs['peak_bytes']}")
            numeric = sum(counts[k.__name__] for k in numeric_kernels)
            if not retries and numeric != 2 * mesh_units(p):
                fail(f"mesh {name} P={n_panels}: {numeric} numeric launches "
                     f"for two waves of {mesh_units(p)} units")
            line.update(reserve_bytes=est.reserve_bytes,
                        device_price_bytes=est.device_bytes,
                        jax_estimate_bytes=est.total_bytes,
                        reserved_by=est.reserved_by,
                        comm=p.comm_stats() if n_panels else None,
                        launches=counts, **secs)
            emit(line)
            del p, c
            torch.cuda.empty_cache()

    # (k2) a lost shard: shard 2 whole-B on three products, device 1 of
    # the banded product at 2 panels
    for name, n_panels, lost in (("pl_100k_d4", 0, 2), ("band_60k_d16", 0, 2),
                                 ("rmat_80k", 0, 2), ("band_60k_d16", 2, 1)):
        m = dict(mats)[name]
        cache = plan.PlanCache()
        p = plan.plan_spgemm(m, m, mesh=mesh4, use_kernel=True,
                             safety=SAFETY, n_panels=n_panels,
                             retry_policy=plan.RetryPolicy())
        c0 = plan.reassemble(p, plan.execute(p, m, m, cache=cache))
        torch.cuda.synchronize()
        t = time.perf_counter()
        plan.execute(p, m, m, cache=cache)
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t
        t = time.perf_counter()
        with faults.inject(lose_shard=lost):
            out, counts = drive("mesh", lambda: plan.execute(p, m, m,
                                                             cache=cache))
        torch.cuda.synchronize()
        lost_s = time.perf_counter() - t
        c1 = plan.reassemble(p, out)
        structure, close, bitwise = csr_matches(c1, c0)
        led = p.recoveries
        kinds = [e["kind"] for e in led]
        units = [(e["bucket"], e["shard"]) for e in led
                 if e["kind"] == "unit"]
        rehomes = [e for e in led if e["kind"] == "rehome"]
        if not (structure and bitwise and kinds[:1] == ["wave_failed"]
                and {e["shard"] for e in led if e["kind"] == "shard_lost"}
                == {lost} and rehomes
                and kinds.index("shard_lost") < kinds.index("rehome")
                and len(units) == len(set(units))
                and lost not in {s for _, s in units}
                and {e["shard"] for e in rehomes} == {lost}):
            fail(f"mesh shard loss {name} P={n_panels}: bitwise {bitwise}, "
                 f"ledger {kinds}")
        emit(dict(phase="mesh_shard_loss", matrix=name, n_panels=n_panels,
                  lost=lost, clean_execute_s=clean_s, lost_execute_s=lost_s,
                  units=len(units), rehomes=len(rehomes),
                  rehome_to=sorted({e["to"] for e in rehomes}),
                  rehomed_rows=sum(e["rows"] for e in rehomes),
                  val_bitwise=True, launches=counts))
        del p, out, c0, c1
        torch.cuda.empty_cache()

    # (k3) the service on the mesh: (h)'s template families, each member
    # once; then again under a lost shard
    free = torch.cuda.mem_get_info(dev)[0]
    mcfg = svc_mod.ServiceConfig(use_kernel=True, mesh=mesh4,
                                 device_budget_bytes=free // 2)
    msvc = svc_mod.SpgemmService(mcfg)
    mreserved = track_reservations(msvc)
    direct_reg, direct_cache = plan.TemplateRegistry(), plan.PlanCache()
    for fam, gen, seeds in TEMPLATE_FAMILIES:
        members = [(s, gen(sprand, s)) for s in seeds]
        direct = {}
        for s, mm in members:
            pd = plan.plan_spgemm(
                mm, mm, mesh=mesh4, safety=mcfg.safety, seed=mcfg.seed,
                pop_quant=mcfg.pop_quant, template="auto",
                registry=direct_reg, use_kernel=True,
                retry_policy=mcfg.retry_policy)
            direct[s] = plan.reassemble(pd, plan.execute(
                pd, mm, mm, cache=direct_cache))
            del pd
        torch.cuda.empty_cache()
        for mode, want_state in (("clean", svc_mod.RequestState.DONE),
                                 ("lose", svc_mod.RequestState.DEGRADED)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mreserved["max"] = 0
            reqs = [(msvc.submit(mm, mm), s) for s, mm in members]
            if mode == "lose":
                with faults.inject(lose_shard=2):
                    _, counts = drive("mesh", msvc.drain)
            else:
                _, counts = drive("mesh", msvc.drain)
            peak = torch.cuda.max_memory_allocated() - base
            for r, s in reqs:
                if r.state != want_state:
                    fail(f"mesh service {fam} {mode}: request {r.id} "
                         f"{r.state} {r.error!r}")
                structure, close, bitwise = csr_matches(r.result, direct[s])
                if not (structure and bitwise):
                    fail(f"mesh service {fam} {mode}: request {r.id} != its "
                         "direct run")
            if mreserved["max"] < peak:
                fail(f"mesh service {fam} {mode}: reserved at most "
                     f"{mreserved['max']} bytes, peak {peak}")
            emit(dict(phase="mesh_service", family=fam, mode=mode,
                      requests=len(reqs), states=sorted({r.state
                                                         for r, _ in reqs}),
                      recoveries=[len(r.stats["recoveries"])
                                  for r, _ in reqs],
                      peak_bytes=peak, max_reserved_bytes=mreserved["max"],
                      reserve_bytes=max(r.estimate.reserve_bytes
                                        for r, _ in reqs),
                      reserved_by=sorted({r.estimate.reserved_by
                                          for r, _ in reqs}),
                      val_bitwise=True, launches=counts))
            for r, _ in reqs:
                r.result = r.plan = None
        del direct
        torch.cuda.empty_cache()
    if any(b["trips"] for b in msvc.stats()["breakers"]) or faults.armed():
        fail(f"mesh service: a breaker tripped ({msvc.stats()['breakers']})")
    require_launched("mesh", ["spgemm_numeric", "spa_numeric", "bin_numeric",
                              "fused_flop_symbolic_buckets",
                              "fused_flop_symbolic_bitmask_buckets"])
    emit(dict(phase="mesh_seconds", seconds=time.perf_counter() - k_start))
    del msvc
    auto_csr.clear()

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

    # ---- (g) blocked GQA flash attention at three model configs' attention
    # widths, from src/repro/configs: qwen2_5_32b.py (d_model 5120, 40
    # heads, 8 kv heads: D 128, groups of 5), phi3_mini.py (d_model 3072,
    # 32 heads and kv heads: D 96) and zamba2_7b.py's shared attention
    # (d_model 3584, 32 heads and kv heads: D 112; its 4096-token sliding
    # window is full causal attention at 4096 tokens), over launch/specs.py's
    # train_4k sequence of 4096 tokens, its batch of 256 cut to 4, 2 and 1;
    # G4 attends 1024 queries over 4096 keys (top-left causal mask).  Inputs
    # are standard normal from a seed, made on the card.
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 in fp32
    attn = {}           # case -> (max abs error against plain, kernel ms,
    #                     variant, TFLOP/s)
    timed_attn = {}     # G1, G2, G5 -> (q, k, v, plain output, causal)
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
             torch.bfloat16, False),
            ("G5", (2, 32, 4096, 112), (2, 32, 4096, 112), torch.bfloat16,
             True)):
        gen = torch.Generator(device=dev).manual_seed(len(attn))
        q, k, v = (torch.randn(s_, generator=gen, device=dev).to(dtype)
                   for s_ in (shape_q, shape_kv, shape_kv))
        # the kernel follows from dtype and head dim: G2 (float32) and G5
        # (D 112) on the mma kernel, the other 16-bit cases on the sm90 one
        variant = fa_k.variant(dtype, shape_q[3])
        kernel, other = (f"flash_attention_{x}" for x in (
            variant, "mma" if variant == "sm90" else "sm90"))
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
        if case in ("G1", "G2", "G5"):   # beside the plain version, SDPA
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
                or launches[path]["fused_flop_symbolic"]
                or launches[path]["fused_flop_symbolic_bitmask"]):
            fail(f"a per-bucket kernel-1, 2 or 4 launch on path {path}")
    # kernel 4 counts a prediction's SPA and BIN samples in one launch; the
    # predict and plan_esc paths route every bucket to ESC
    for path in ("predict", "plan_esc"):
        if launches[path]["fused_flop_symbolic_bitmask_buckets"]:
            fail(f"a kernel-4 launch on the all-ESC path {path}")
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
                        ("plan_auto", ("fused_flop_symbolic_bitmask_buckets",
                                       "spa_numeric", "bin_numeric")),
                        ("global_predict", ("sampled_symbolic",
                                            "flop_per_row")),
                        ("global_bitmask", ("bitmask_symbolic",)),
                        ("global_spgemm", ("spgemm_numeric",)),
                        ("experiment", ("sampled_symbolic", "flop_per_row")),
                        ("attention", ("flash_attention",
                                       "flash_attention_sm90",
                                       "flash_attention_mma"))):
        for k in kinds:
            if launches[path][k] <= 0:
                fail(f"kernel {k} was not launched on main path {path}")
    for name, (routes, counts, esc_samples, bitmask_samples) in \
            auto_runs.items():
        for route, k in ((binning.ROUTE_SPA, "spa_numeric"),
                         (binning.ROUTE_BIN, "bin_numeric")):
            if routes[route] and counts[k] <= 0:
                fail(f"plan_auto {name}: {route} buckets but no {k} launch")
        # one kernel-2 launch when a sampled row lands in an ESC bucket, and
        # no launch at all when none does
        if counts["fused_flop_symbolic_buckets"] != int(esc_samples > 0):
            fail(f"plan_auto {name}: {counts['fused_flop_symbolic_buckets']}"
                 f" kernel-2 launches for {esc_samples} ESC samples")
        # and one kernel-4 launch when a sampled row lands in a SPA or BIN
        # bucket, none when none does
        got = counts["fused_flop_symbolic_bitmask_buckets"]
        if got != int(bitmask_samples > 0):
            fail(f"plan_auto {name}: {got} kernel-4 launches for "
                 f"{bitmask_samples} SPA/BIN samples")

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
            # the one launch the predictor makes over all of them: against
            # its plain version, the per-bucket kernel, the ESC kernel on
            # the same rows and the host oracle
            tabs = predictor.plan_tables(binplan, dev)
            table = predictor.bitmask_sample_table(
                binplan, tabs, rows, floprc[name][rows], m.ncols, dev)
            # the SPA and BIN samples in the caller's order
            in_order = rows[~tabs.esc[binplan.row_bucket[rows]]]
            kw = dict(a=ad, b=ad, table=table, rownnz_b=rnb)
            got = acc_k.fused_flop_symbolic_bitmask_buckets(**kw)
            want = acc_k.fused_flop_symbolic_bitmask_buckets_plain(**kw)
            sel = np.concatenate([c[1] for c in bc])
            per_bucket = [acc_k.fused_flop_symbolic_bitmask(**c[0])
                          for c in bc]
            esc = [sym_k.fused_flop_symbolic(**{
                k: v for k, v in c[0].items() if k != "span"}) for c in bc]
            host = (oracle.exact_sampled_nnz(m, m, sel),
                    int(floprc[name][sel].sum()))
            err = max(abs(int(got[0]) - int(want[0])),
                      abs(int(got[1]) - int(want[1])),
                      int((got[2] - want[2]).abs().max()))
            if (err or (int(got[0]), int(got[1])) != host
                    or any((sum(int(x[0]) for x in xs),
                            sum(int(x[1]) for x in xs)) != host
                           for xs in (per_bucket, esc))
                    or not np.array_equal(got[2].cpu().numpy(),
                                          floprc[name][in_order])):
                fail(f"fused_flop_symbolic_bitmask_buckets {name}: kernel "
                     "!= plain/per-bucket/ESC kernel/host oracle")
            int_err["fused_flop_symbolic_bitmask"] = max(
                int_err["fused_flop_symbolic_bitmask"], err)
            one_launch["fused_flop_symbolic_bitmask", name] = (
                acc_k.fused_flop_symbolic_bitmask_buckets, kw,
                acc_k.fused_flop_symbolic_bitmask_buckets_plain)
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
            if kernel in DEVICE_TIMED:
                device[kernel] = device_ms(torch, lambda: fn1(**kw1),
                                           DEVICE_TIMED[kernel])
                extra["per_bucket_device_ms"] = device_ms(
                    torch, lambda: [fn(**c[0]) for c in cs],
                    DEVICE_TIMED[kernel])
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
    # the sm90 kernel on G1, the mma one on G2 (float32) and G5 (bf16, D 112)
    for case in ("G1", "G2", "G5"):
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
        f32 = q.dtype == torch.float32
        # the mma kernel's float32 products take three TF32 passes (3xTF32);
        # 16-bit products are exact in one, bounded by the bf16 rate
        ops_ms = (3 * ops / TF32_FLOP_PER_S if f32
                  else ops / BF16_FLOP_PER_S) * 1e3
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
        if variant == "mma" and f32:
            # the same products as fp32 FMAs on the CUDA cores
            e.update(ffma_bound_ms=ops / FP32_FLOP_PER_S * 1e3)
        elif variant == "mma":
            # this design's passes on the TF32 rate: S one, P V two
            e.update(design_floor_ms=1.5 * ops / TF32_FLOP_PER_S * 1e3)
        if case in ("G1", "G2"):
            # the redesign's marks: half the bound (where the rule leaves a
            # kernel alone, if it also does not lose to SDPA) and the
            # acceptance bar
            accept = G1_ACCEPT_MS if case == "G1" else G2_ACCEPT_MS
            e.update(target_ms=2 * bound, target_met=ms <= 2 * bound,
                     acceptance_ms=accept, acceptance_met=ms <= accept,
                     loses_to_library=ms > e["library_ms"])
        if case == "G1":
            sdpa_backends(torch, q, k, v, want, emit, attn)
        timings[name, case] = e
        emit(dict(phase="kernel_time", **e))
        del q, k, v, want
    # kernels 2 and 4 in their per-row count mode, over the largest bucket
    # (h)'s fallback counted with each, against their plain versions and
    # the ESC run's row nnz
    exact_report = []
    for mode_of, (size, name, bk, flop) in sorted(largest.items()):
        m = dict(mats)[name]
        ad = csr.to_device(m, device=dev)
        bounds = (np.full(size, bk.deg_a, np.int32),
                  np.full(size, bk.deg_b, np.int32))
        if mode_of == "esc":
            def make_table():
                return sym_k.sample_table(bk.rows, *bounds, flop, dev)
            fn, plain_fn = (sym_k.exact_row_counts_esc,
                            sym_k.exact_row_counts_esc_plain)
            source, replaces = "esc_symbolic.cu", "spgemm_symbolic.py:102"
        else:
            lanes = min(bk.span, m.ncols) if bk.span else m.ncols

            def make_table():
                return acc_k.bitmask_table(bk.rows, *bounds,
                                           np.full(size, -(-lanes // 32)),
                                           flop, dev)
            fn, plain_fn = (acc_k.exact_row_counts_bitmask,
                            acc_k.exact_row_counts_bitmask_plain)
            source, replaces = "bitmask_symbolic.cu", "accumulator.py:242"
        # the table's host cost (numpy, then one upload), as the fallback
        # pays it once a bucket
        builds = []
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            table = make_table()
            torch.cuda.synchronize()
            builds.append((time.perf_counter() - t) * 1e3)
        kw = dict(a=ad, b=ad, table=table, rownnz_b=torch.diff(ad.rpt))
        got, want = fn(**kw), plain_fn(**kw)
        err = int((got - want).abs().max())
        if err or not np.array_equal(got.cpu().numpy(),
                                     b_row_nnz[name][bk.rows]):
            fail(f"{fn.__name__} {name}: kernel != plain/the ESC run's "
                 "row nnz")
        nbytes = bytes_symbolic(np, m, bk.rows, bk.deg_a, bk.deg_b)
        e = dict(name=fn.__name__, route="cuda",
                 source=f"src/repro_torch/kernels/csrc/{source}",
                 replaces=f"src/repro/kernels/{replaces}",
                 counts_for="src/repro/core/predictor.py:204",
                 launches=sum(launches[p][fn.__name__] for p in launches),
                 max_abs_err=float(err), ms=cuda_ms(torch, lambda: fn(**kw)),
                 plain_ms=cuda_ms(torch, lambda: plain_fn(**kw)),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 library_ms=library_rows_ms(name, bk.rows, ones=True),
                 device_ms=device_ms(torch, lambda: fn(**kw),
                                     source.split(".")[0]),
                 table_host_ms=sorted(builds)[len(builds) // 2],
                 timed_on=name, rows=size, bucket_route=bk.route,
                 deg_a=bk.deg_a, deg_b=bk.deg_b, calls=1, bytes=nbytes,
                 operations=0)
        emit(dict(phase="kernel_time", **e))
        exact_report.append(e)
        del ad, table, kw, got, want
    if len(exact_report) != 2:
        fail(f"the fallback counted buckets of {sorted(largest)} only")
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
              timings["flash_attention_mma", "G2"]] + exact_report
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: e[k] for k in keys + tuple(x for x in ("entry", "per_bucket_ms",
                                                   "device_ms") if x in e)}
        for e in report]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
