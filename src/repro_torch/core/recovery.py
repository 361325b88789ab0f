"""Straggler recovery on one device: per-unit replay with a checkpoint
ledger (DESIGN.md §12).

The fused :func:`repro_torch.core.plan.execute` waves are all-or-nothing:
a wave that blows its :class:`~repro_torch.core.plan.DispatchBudget`
raises a typed :class:`~repro_torch.core.errors.StragglerError` and its
result is dropped.  This module replays such a wave as INDIVIDUAL units —
each bucket (whole-B plans) or each (bucket × panel) unit (panel plans) —
through the same cached per-unit executors the re-planning loop uses
(``("bucket-retry", …)`` / ``("bucket-retry-panel", …)`` keys), each
priced and timed on its own, with ``policy.rounds + 1`` dispatch attempts
before the unit is declared dead.  Each completed unit checkpoints in the
recovery ledger (``plan.recoveries``, surfaced by ``plan.stats()
["recoveries"]``): one ``wave_failed`` event, then one ``unit`` event per
unit with its ``attempts`` — the JAX package's ledger.

The blocks stay on the device: each replayed bucket's rows are written
into the ``(M, row_capacity)`` output in place, as the wave's executor
writes them, and a panel plan's replayed blocks simply are its output.
Every numeric kernel adds a row's products in a fixed order whichever unit
takes the row, so the result equals the clean wave's bit for bit, ``val``
included.  Capacity overflow is left to the ordinary re-planning loop,
which runs right after on the replayed result.

On one device the replay is redundant work: the watchdog reads its clock
after a synchronize, so the tripped wave's output is already complete,
and the replay recomputes the same bits.  It is kept so that the ledger
and the dispatches match the JAX package's; it earns its cost only once a
unit can move to another device.

A local executor that dies without being a straggler still raises
:class:`~repro_torch.core.errors.ShardFailureError`: there is no sibling
device to move it to.  The distributed half of the JAX module (shard-loss
re-homing, ``recover_dist``/``recover_dist_panels``) comes with the
port's distributed plans.
"""
from __future__ import annotations

import torch

from . import plan as plan_mod
from .errors import ShardFailureError
from .spgemm import PanelSpgemmOut, SpGEMMOut, assemble


def _policy_rounds(plan) -> int:
    """Failure retries a unit gets: the plan's retry policy's rounds, or
    ``plan_spgemm``'s ``max_retries`` when no policy is set (the JAX
    package's ``_policy_of``)."""
    if plan.retry_policy is not None:
        return int(plan.retry_policy.rounds)
    return int(plan._max_retries)


def _dispatch(plan, run, info, args, meta, pop, rounds):
    """One unit dispatch with bounded failure retries: up to ``rounds + 1``
    attempts before the unit is declared dead.  Returns ``(out,
    attempts)``; re-raises the last attempt's error."""
    last = None
    for attempt in range(1, rounds + 2):
        try:
            out = plan_mod._invoke_executor(
                run, info, *args, budget=plan.dispatch_budget,
                priced_s=plan_mod._unit_priced_seconds(meta, pop),
                device=plan.device)
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
