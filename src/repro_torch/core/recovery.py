"""Degraded-mesh recovery: per-unit checkpointing, shard-loss re-homing,
and splice-back (DESIGN.md §12).

The fused :func:`repro_torch.core.plan.execute` waves are all-or-nothing:
one dead or straggling unit unwinds every completed unit of the wave.
This module is the containment layer behind them.  When a wave raises a
typed :class:`~repro_torch.core.errors.ShardFailureError` (a distributed
wave), or a :class:`~repro_torch.core.errors.StragglerError` (a
single-device wave that blew its :class:`~repro_torch.core.plan.
DispatchBudget`), ``execute`` hands the plan here and the wave re-executes
as INDIVIDUAL units through the same cached per-unit executors the
re-planning loop uses (``("bucket-retry", …)`` key families), each priced
and timed on its own, with ``policy.rounds + 1`` dispatch attempts before
the unit is declared dead.  Each completed unit checkpoints in the
recovery ledger (``plan.recoveries``, surfaced by ``plan.stats()
["recoveries"]``) as it lands — the JAX package's ledger.

Distributed recovery (ledger → re-partition → splice):

1. **ledger** — every (bucket × shard) unit re-executes standalone on its
   shard's device with per-shard dispatch attribution; completions
   checkpoint as ``kind="unit"`` events.  A unit that keeps failing past
   the policy's rounds marks its shard LOST (``kind="shard_lost"``).
2. **re-partition** — a lost shard's row range re-partitions across the
   SURVIVING shards with :func:`repro_torch.core.partition.
   balanced_contiguous` on the plan's predicted per-row nnz (panel plans
   move a lost device's units whole to a survivor).
3. **splice** — only the orphaned rows re-execute (``kind="rehome"``
   events name donor and recipient); their blocks splice back at the lost
   shard's ORIGINAL table positions, so :func:`repro_torch.core.plan.
   reassemble` runs unchanged.

The blocks stay on the mesh's first device and are written in place.
Every numeric kernel adds a row's products in a fixed order whichever unit
takes the row, so a recovered result equals the clean wave's bit for bit,
``val`` included.  Capacity overflow inside distributed recovery escalates
per unit through the plan's ladder and exact fallback (the wave's
re-planning cannot run around a lost shard); a single-device replay leaves
it to the ordinary re-planning loop, which runs right after.

On one device the replay is redundant work: the watchdog reads its clock
after a synchronize, so the tripped wave's output is already complete, and
the replay recomputes the same bits.  It is kept so that the ledger and the
dispatches match the JAX package's.  A local executor that dies without
being a straggler still raises :class:`~repro_torch.core.errors.
ShardFailureError`: there is no sibling device to move it to.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import partition as part_mod
from . import plan as plan_mod
from . import predictor as predictor_mod
from .csr import COL_SENTINEL
from .errors import ShardFailureError
from .spgemm import PanelSpgemmOut, SpGEMMOut, assemble


def _policy_rounds(plan) -> int:
    """Failure retries a unit gets: the plan's retry policy's rounds, or
    ``plan_spgemm``'s ``max_retries`` when no policy is set (the JAX
    package's ``_policy_of``)."""
    if plan.retry_policy is not None:
        return int(plan.retry_policy.rounds)
    return int(plan._max_retries)


def _recovery_policy(plan) -> "plan_mod.RetryPolicy":
    """The distributed recovery's escalation policy: the plan's, or the
    JAX package's ladder-only stand-in (``max_retries`` rounds, growth
    1.5, no exact fallback, residual overflow surfaced) when it has
    none."""
    if plan.retry_policy is not None:
        return plan.retry_policy
    return plan_mod.RetryPolicy(rounds=int(plan._max_retries), growth=1.5,
                                exact_fallback=False, on_exhausted="surface")


def _dispatch(plan, run, info, args, meta, pop, rounds, device=None):
    """One unit dispatch with bounded failure retries: up to ``rounds + 1``
    attempts before the unit is declared dead.  Returns ``(out,
    attempts)``; re-raises the last attempt's error."""
    last = None
    for attempt in range(1, rounds + 2):
        try:
            out = plan_mod._invoke_executor(
                run, info, *args, budget=plan.dispatch_budget,
                priced_s=plan_mod._unit_priced_seconds(meta, pop),
                device=device if device is not None else plan.device)
            return out, attempt
        except ShardFailureError as e:
            last = e
    raise last


def recover_local(plan, ad, bd, cache, cause) -> SpGEMMOut:
    """Replay a straggling whole-B wave (``unit="local"``) per bucket, each
    bucket's real rows written into the output in place — the wave
    executor's assembly, so the result equals the clean wave's bit for
    bit."""
    rounds = _policy_rounds(plan)
    buckets = plan.binning.buckets
    tables = plan.device_args()
    bounds = plan.flop_bounds()
    valid = plan.valid_rows()
    caps = [int(c) for c in plan.alloc.bucket_capacities]
    led = plan.recoveries
    led.append(dict(kind="wave_failed", unit="local",
                    error=type(cause).__name__))

    def parts():
        for i, bk in enumerate(buckets):
            meta = plan_mod._bucket_meta(bk, caps[i])
            pop = int(tables[i].shape[0])
            run = cache.executor(
                ("bucket-retry", plan.shape_a, plan.shape_b, plan.cap_a,
                 plan.cap_b, plan.use_kernel, meta, pop),
                lambda m=meta: plan_mod._build_bucket_executor(
                    m, plan.use_kernel))
            out, attempts = _dispatch(
                plan, run, dict(unit="recover", bucket=i),
                (ad, bd, tables[i], bounds[i]), meta, pop, rounds)
            led.append(dict(kind="unit", bucket=i, attempts=attempts))
            rows = tables[i]
            if plan.pop_quant:
                out = plan_mod._real_rows(out, valid[i], caps[i])
                rows = rows[:valid[i]]
            yield rows, out

    return assemble(plan.shape_a[0], plan.alloc.row_capacity, parts(),
                    plan.device)


def recover_local_panels(plan, ad, bps, cache, cause) -> PanelSpgemmOut:
    """Replay a straggling panel wave (``unit="local-panels"``) per
    (bucket × panel) unit; panel blocks are independent, so the replayed
    blocks ARE the output."""
    rounds = _policy_rounds(plan)
    buckets = plan.binning.buckets
    tables = plan.device_args()
    bounds = plan.panel_flop_bounds()
    valid = plan.valid_rows()
    led = plan.recoveries
    led.append(dict(kind="wave_failed", unit="local-panels",
                    error=type(cause).__name__))
    cols, vals, nnzs = [], [], []
    overflow = torch.zeros((), dtype=torch.int32, device=ad.device)
    for i, bk in enumerate(buckets):
        pop = int(tables[i].shape[0])
        bc, bv, bn = [], [], []
        for p in range(plan.n_panels):
            cap = int(plan.panel_caps[i, p])
            meta = plan_mod._panel_meta(bk, plan.panel_deg_b[i], cap)
            run = cache.executor(
                ("bucket-retry-panel", plan.shape_a, plan.shape_b,
                 plan.cap_a, plan._panel_caps_dev[p], plan.use_kernel,
                 meta, pop),
                lambda m=meta: plan_mod._build_bucket_executor(
                    m, plan.use_kernel))
            out, attempts = _dispatch(
                plan, run, dict(unit="recover", bucket=i, panel=p),
                (ad, bps[p], tables[i], bounds[i][p]), meta, pop, rounds)
            led.append(dict(kind="unit", bucket=i, panel=p,
                            attempts=attempts))
            if plan.pop_quant:
                out = plan_mod._real_rows(out, valid[i], cap)
            bc.append(out.col)
            bv.append(out.val)
            bn.append(out.row_nnz)
            overflow = overflow + out.overflow
        cols.append(tuple(bc))
        vals.append(tuple(bv))
        nnzs.append(tuple(bn))
    return PanelSpgemmOut(tuple(cols), tuple(vals), tuple(nnzs), overflow)


# --------------------------------------------------------------------------- #
# Distributed recovery
# --------------------------------------------------------------------------- #
def _recover_unit(plan, cache, ops, rows_dev, valid, cap, bound, key_of,
                  meta_of, info, policy, exact_counts, device):
    """Execute one recovery unit on ``device``, escalating its capacity on
    overflow within the policy's ladder (and its one exact fallback).
    Returns ``(out, row_nnz host, final_cap, residual_overflow,
    attempts)``; raises :class:`ShardFailureError` when every dispatch
    attempt died."""
    pop = int(rows_dev.shape[0])

    def run_at(cap_now):
        meta = meta_of(cap_now)
        run = cache.executor(
            key_of(meta, pop),
            lambda m=meta: plan_mod._build_bucket_executor(
                m, plan.use_kernel))
        out, attempts = _dispatch(plan, run, info,
                                  (*ops, rows_dev, bound), meta, pop,
                                  policy.rounds, device)
        return out, out.row_nnz.cpu().numpy().astype(np.int64), attempts

    tag = {k: info[k] for k in ("bucket", "shard", "panel") if k in info}
    out, n, attempts = run_at(cap)
    for round_ in range(1, policy.rounds + 1):
        need = int(np.where(valid, n, 0).max(initial=0))
        if need <= cap:
            break
        new_cap = policy.clamp(cap, plan_mod._bumped_capacity(
            cap, need, policy.growth, round_))
        if new_cap <= cap:
            break
        out, n, _ = run_at(new_cap)
        plan.retries = max(plan.retries, round_)
        plan.retry_events.append(dict(round=round_, old_cap=int(cap),
                                      new_cap=int(new_cap), need=int(need),
                                      **tag))
        cap = new_cap
    need = int(np.where(valid, n, 0).max(initial=0))
    if need > cap and policy.exact_fallback:
        exact_need = int(exact_counts())
        new_cap = plan_mod._exact_capacity(exact_need, cap + 1)
        out, n, _ = run_at(new_cap)
        plan.degradations.append(dict(kind="exact_symbolic",
                                      old_cap=int(cap), new_cap=int(new_cap),
                                      need=int(exact_need), **tag))
        cap = new_cap
    residual = int(np.where(valid, np.maximum(n - cap, 0), 0).sum())
    return out, n, cap, residual, attempts


def _pad_rows(rows: np.ndarray, pop: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad a row chunk to the unit's population (repeat-last fill, like the
    shard tables) so re-homed chunks hit the SAME cached executor as the
    per-unit pass."""
    out = np.empty(pop, dtype=np.int32)
    out[:rows.size] = rows
    out[rows.size:] = rows[-1] if rows.size else 0
    valid = np.zeros(pop, dtype=bool)
    valid[:rows.size] = True
    return out, valid


def _blocks(tables, widths, device) -> tuple[list, list, list]:
    """Empty stacked ``(num_shards, rows_pb, width)`` blocks per bucket."""
    cols = [torch.full((t.table.shape[0], t.rows_pb, w), COL_SENTINEL,
                       dtype=torch.int32, device=device)
            for t, w in zip(tables, widths)]
    vals = [torch.zeros((t.table.shape[0], t.rows_pb, w),
                        dtype=torch.float32, device=device)
            for t, w in zip(tables, widths)]
    nnzs = [torch.zeros((t.table.shape[0], t.rows_pb), dtype=torch.int32,
                        device=device) for t in tables]
    return cols, vals, nnzs


def _move_ops(ops, device) -> tuple:
    """A unit's ``(A, B, B's row lengths)`` on ``device`` (moved only when
    a unit runs on a survivor that is another device)."""
    a, b, rnb = ops
    return (plan_mod._on_device(a, device), plan_mod._on_device(b, device),
            rnb.to(device))


def recover_dist(plan, ops, mesh, cache, cause) -> "plan_mod.DistSpgemmOut":
    """Re-execute a failed ``unit="dist"`` wave per (bucket × shard) unit,
    re-homing lost shards' rows across survivors; the spliced result feeds
    :func:`repro_torch.core.plan.reassemble` unchanged."""
    policy = _recovery_policy(plan)
    buckets = plan.binning.buckets
    tables = list(plan.shard_tables)
    n_sh = plan.num_shards
    plan.retries = 0
    plan.retry_events = []
    plan.degradations = []
    led = plan.recoveries
    led.append(dict(kind="wave_failed", unit="dist",
                    error=type(cause).__name__))
    first = mesh.devices[0]
    caps = [int(t.capacity) for t in tables]
    cols, vals, nnzs = _blocks(tables, caps, first)
    overflow = np.zeros(n_sh, dtype=np.int64)
    args = plan_mod._shard_args(plan, mesh)

    def key_of(meta, pop):
        return ("bucket-retry", plan.shape_a, plan.shape_b, plan.cap_a,
                plan.cap_b, plan.use_kernel, meta, pop)

    def run_unit(i, rows_dev, rows_host, valid, owner, on):
        """Bucket ``i``'s rows ``rows_host`` (``valid`` real) on shard
        ``on``'s device, charged to shard ``owner``."""
        bk = buckets[i]
        ad, bd, _ = ops[on]
        real = rows_host[valid]

        def exact():
            return predictor_mod.exact_row_counts(
                ad, bd, real, max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
                route=bk.route, span=bk.span, use_kernel=plan.use_kernel,
                row_flop=plan.flopr[real]).max(initial=1)

        out, n, cap_f, res, attempts = _recover_unit(
            plan, cache, (ad, bd), rows_dev, valid, caps[i],
            int(plan.flopr[rows_host].max()) if rows_host.size else 0,
            key_of, lambda cap, b=bk: plan_mod._bucket_meta(b, cap),
            dict(unit="recover", bucket=i, shard=on), policy, exact,
            mesh.devices[on])
        if cap_f > caps[i]:
            cols[i] = plan_mod._widen_block(cols[i], cap_f, COL_SENTINEL)
            vals[i] = plan_mod._widen_block(vals[i], cap_f, 0.0)
            caps[i] = cap_f
        overflow[owner] += res
        return out, attempts

    lost = []
    for s in range(n_sh):
        for i, t in enumerate(tables):
            if not t.valid[s].any():
                continue               # shard owns no rows of this bucket
            try:
                out, attempts = run_unit(i, args[i][s], t.table[s],
                                         t.valid[s], s, s)
            except ShardFailureError as e:
                led.append(dict(kind="shard_lost", shard=s, bucket=i,
                                error=str(e)))
                lost.append(s)
                break                  # remaining units re-home wholesale
            w = out.col.shape[1]
            cols[i][s, :, :w].copy_(out.col)
            vals[i][s, :, :w].copy_(out.val)
            nnzs[i][s].copy_(out.row_nnz)
            led.append(dict(kind="unit", bucket=i, shard=s,
                            attempts=attempts))

    survivors = [s for s in range(n_sh) if s not in lost]
    if lost and not survivors:
        raise ShardFailureError(
            f"recovery impossible: all {n_sh} shards lost", shards=lost,
            plan_key=plan_mod._plan_key_id(plan)) from cause
    for lost_s in lost:
        lo = int(plan.partition.bounds[lost_s])
        hi = int(plan.partition.bounds[lost_s + 1])
        # re-partition the lost shard's rows across survivors on the
        # plan's predicted nnz — the sampled structure priced them already
        sub = part_mod.balanced_contiguous(plan.structure[lo:hi],
                                           len(survivors))
        sub_bounds = (lo + np.asarray(sub.bounds)).astype(np.int64)
        for i, t in enumerate(tables):
            rows_l = t.table[lost_s][t.valid[lost_s]]
            if not rows_l.size:
                continue
            klo, khi = part_mod.shard_slices(rows_l, sub_bounds)
            for k, sv in enumerate(survivors):
                c0, c1 = int(klo[k]), int(khi[k])
                if c1 <= c0:
                    continue
                chunk = rows_l[c0:c1]
                rows_pad, valid = _pad_rows(chunk, t.rows_pb)
                out, _ = run_unit(
                    i, torch.from_numpy(rows_pad).to(mesh.devices[sv]),
                    rows_pad, valid, lost_s, sv)
                # splice at the lost shard's ORIGINAL block positions —
                # reassemble's table/valid layout never learns of the loss
                w = out.col.shape[1]
                cols[i][lost_s, c0:c1, :w].copy_(out.col[:chunk.size])
                vals[i][lost_s, c0:c1, :w].copy_(out.val[:chunk.size])
                nnzs[i][lost_s, c0:c1].copy_(out.row_nnz[:chunk.size])
                led.append(dict(kind="rehome", bucket=i, shard=lost_s,
                                to=sv, rows=int(chunk.size)))

    plan.shard_tables = tuple(dataclasses.replace(t, capacity=caps[i])
                              for i, t in enumerate(tables))
    if plan._template is not None:
        plan._template.grow_dist(n_sh, [t.rows_pb for t in tables], caps)
    if overflow.sum() and policy.on_exhausted == "raise":
        shards = [int(s) for s in np.flatnonzero(overflow)]
        raise ShardFailureError(
            f"recovery exhausted its ladder with {int(overflow.sum())} "
            f"entries still dropped on shards {shards}", shards=shards,
            observed=int(overflow.sum()),
            plan_key=plan_mod._plan_key_id(plan))
    return plan_mod.DistSpgemmOut(tuple(cols), tuple(vals), tuple(nnzs),
                                  overflow)


def recover_dist_panels(plan, ops, mesh, cache,
                        cause) -> "plan_mod.DistSpgemmOut":
    """Re-execute a failed ``unit="dist-panels"`` wave per (bucket ×
    device) unit against the SAME gathered operands the wave used.  A
    persistently dead device's units move WHOLE to survivors (with their
    gathered operands, when the survivor is another device); blocks splice
    at the dead device's original positions."""
    policy = _recovery_policy(plan)
    pg = plan._panel_gather
    npan = plan.n_panels
    buckets = plan.binning.buckets
    tables = list(plan.shard_tables)
    n_dev = plan.num_shards
    plan.retries = 0
    plan.retry_events = []
    plan.degradations = []
    led = plan.recoveries
    led.append(dict(kind="wave_failed", unit="dist-panels",
                    error=type(cause).__name__))
    first = mesh.devices[0]
    caps = np.asarray(plan.panel_caps, dtype=np.int64).copy()
    alloc = [int(t.capacity) for t in tables]     # executed width per bucket
    cols, vals, nnzs = _blocks(tables, alloc, first)
    overflow = np.zeros(n_dev, dtype=np.int64)
    args = plan_mod._shard_args(plan, mesh)

    def key_of(meta, pop):
        return ("bucket-retry-panel-dist", plan.shape_a, plan.shape_b,
                plan.cap_a, pg.nref, pg.ecap, plan.use_kernel, meta, pop)

    def run_unit(i, d, on):
        """Bucket ``i``'s unit of device ``d``, run on device ``on``."""
        bk, t = buckets[i], tables[i]
        p = d % npan
        dev = mesh.devices[on]
        unit_ops = _move_ops(ops[d], dev)[:2]
        rows = t.table[d]
        real = rows[t.valid[d]]
        flop_p = plan._panel_flopr[p]

        def exact():
            return predictor_mod.exact_row_counts(
                unit_ops[0], unit_ops[1], real, max_deg_a=bk.deg_a,
                max_deg_b=plan.panel_deg_b[i], route=bk.route, span=bk.span,
                use_kernel=plan.use_kernel,
                row_flop=flop_p[real]).max(initial=1)

        out, n, cap_f, res, attempts = _recover_unit(
            plan, cache, unit_ops, args[i][d].to(dev), t.valid[d], alloc[i],
            int(flop_p[rows].max()) if rows.size else 0, key_of,
            lambda cap, b=bk, j=i: plan_mod._panel_meta(
                b, plan.panel_deg_b[j], cap),
            dict(unit="recover", bucket=i, panel=p, shard=on), policy, exact,
            dev)
        if cap_f > alloc[i]:
            cols[i] = plan_mod._widen_block(cols[i], cap_f, COL_SENTINEL)
            vals[i] = plan_mod._widen_block(vals[i], cap_f, 0.0)
            alloc[i] = cap_f
        caps[i, p] = max(int(caps[i, p]), cap_f)
        overflow[d] += res
        w = out.col.shape[1]
        cols[i][d, :, :w].copy_(out.col)
        vals[i][d, :, :w].copy_(out.val)
        nnzs[i][d].copy_(out.row_nnz)
        return attempts

    lost = []
    for d in range(n_dev):
        for i, t in enumerate(tables):
            if not t.valid[d].any():
                continue
            try:
                attempts = run_unit(i, d, d)
            except ShardFailureError as e:
                led.append(dict(kind="shard_lost", shard=d, bucket=i,
                                error=str(e)))
                lost.append(d)
                break
            led.append(dict(kind="unit", bucket=i, shard=d, panel=d % npan,
                            attempts=attempts))

    survivors = [d for d in range(n_dev) if d not in lost]
    if lost and not survivors:
        raise ShardFailureError(
            f"recovery impossible: all {n_dev} devices lost", shards=lost,
            plan_key=plan_mod._plan_key_id(plan)) from cause
    for j, lost_d in enumerate(lost):
        for i, t in enumerate(tables):
            if not t.valid[lost_d].any():
                continue
            sv = survivors[(j + i) % len(survivors)]
            run_unit(i, lost_d, sv)
            led.append(dict(kind="rehome", bucket=i, shard=lost_d, to=sv,
                            rows=int(t.valid[lost_d].sum())))

    plan.panel_caps = caps
    plan.shard_tables = tuple(
        dataclasses.replace(t, capacity=int(max(alloc[i], caps[i].max())))
        for i, t in enumerate(tables))
    if overflow.sum() and policy.on_exhausted == "raise":
        devs = [int(d) for d in np.flatnonzero(overflow)]
        raise ShardFailureError(
            f"recovery exhausted its ladder with {int(overflow.sum())} "
            f"entries still dropped", shards=[d // npan for d in devs],
            observed=int(overflow.sum()),
            plan_key=plan_mod._plan_key_id(plan))
    return plan_mod.DistSpgemmOut(tuple(cols), tuple(vals), tuple(nnzs),
                                  overflow)
