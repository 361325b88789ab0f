"""Numeric SpGEMM on device (torch), allocated from the paper's prediction.

The ESC (expand, sort, compress) accumulator: expand each row's products
into a buffer, sort them by column carrying values, sum each run of equal
columns, and write the runs into the row's predicted ``row_capacity`` slots.
A row's true nnz survives truncation, so overflow (a row whose true nnz
exceeds its capacity) is counted and returned — the caller re-plans.

With ``use_kernel`` a bucket runs through the port's hand-written CUDA
kernel (``repro_torch.kernels.spgemm_numeric``); without it, and always on a
CPU tensor, the plain tensor-op version below runs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .csr import COL_SENTINEL, CSRDevice, expand_products, row_chunks


class SpGEMMOut(NamedTuple):
    col: torch.Tensor       # (M, row_capacity) int32, COL_SENTINEL padded
    val: torch.Tensor       # (M, row_capacity) float32
    row_nnz: torch.Tensor   # (M,) int32 — true nnz per row (may exceed capacity)
    overflow: torch.Tensor  # scalar int32 — total entries dropped for capacity


def gather_products(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                    max_deg_a: int, max_deg_b: int,
                    rownnz_b: torch.Tensor | None = None):
    """Columns AND value-products of all intermediate products of ``rows``
    (value-carrying view of :func:`repro_torch.core.csr.expand_products`)."""
    return expand_products(a, b, rows, max_deg_a, max_deg_b,
                           rownnz_b=rownnz_b, with_values=True)


def _accumulate_block(cols: torch.Tensor, vals: torch.Tensor,
                      row_capacity: int):
    """Sort-merge accumulation for one block of rows → (col, val, row_nnz,
    overflow)."""
    c_s, order = torch.sort(cols, dim=-1, stable=True)
    v_s = torch.gather(vals, -1, order)
    valid = c_s != COL_SENTINEL
    newseg = torch.cat(
        [valid[:, :1], (c_s[:, 1:] != c_s[:, :-1]) & valid[:, 1:]], dim=-1)
    seg = torch.cumsum(newseg.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    row_nnz = seg[:, -1] + 1
    # invalid or overflowing slots land in one spill column, cut off below
    seg_sc = torch.where(valid & (seg < row_capacity), seg,
                         row_capacity).long()
    bs = cols.shape[0]
    out_val = torch.zeros((bs, row_capacity + 1), dtype=torch.float32,
                          device=cols.device).scatter_add_(1, seg_sc, v_s)
    out_col = torch.full((bs, row_capacity + 1), COL_SENTINEL,
                         dtype=torch.int32, device=cols.device).scatter_reduce_(
        1, seg_sc, c_s, reduce="amin")
    overflow = torch.clamp(row_nnz - row_capacity, min=0).sum(dtype=torch.int32)
    return (out_col[:, :row_capacity], out_val[:, :row_capacity],
            row_nnz.to(torch.int32), overflow)


def spgemm_rows(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                row_capacity: int, max_deg_a: int,
                max_deg_b: int) -> SpGEMMOut:
    """Numeric phase (ESC/sort route) for an explicit row-id list (one degree
    bucket, or all rows).  Output row ``i`` corresponds to ``rows[i]``.
    Rows are expanded in chunks of at most
    :data:`~repro_torch.core.csr.PLAIN_CHUNK_LANES` product lanes."""
    rownnz_b = torch.diff(b.rpt)
    parts = []
    for lo, hi in row_chunks(rows.shape[0], max_deg_a * max_deg_b):
        cols, vals, _ = gather_products(a, b, rows[lo:hi], max_deg_a,
                                        max_deg_b, rownnz_b=rownnz_b)
        parts.append(_accumulate_block(cols, vals, row_capacity))
    if not parts:
        dev = a.rpt.device
        return SpGEMMOut(
            torch.full((0, row_capacity), COL_SENTINEL, dtype=torch.int32,
                       device=dev),
            torch.zeros((0, row_capacity), dtype=torch.float32, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))
    return SpGEMMOut(torch.cat([p[0] for p in parts]),
                     torch.cat([p[1] for p in parts]),
                     torch.cat([p[2] for p in parts]),
                     torch.stack([p[3] for p in parts]).sum(dtype=torch.int32))


def routed_spgemm_rows(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                       row_capacity: int, deg_a: int, deg_b: int,
                       route: str = "esc",
                       use_kernel: bool = False) -> SpGEMMOut:
    """One bucket's numeric phase on its planned accumulator route — the
    per-bucket dispatch shared by :func:`spgemm_binned` and the plan
    executor.  Only the ESC route is ported: SPA and BIN raise
    :class:`~repro_torch.core.errors.PlanMismatchError`."""
    from repro_torch.kernels import ops as kops
    if use_kernel:
        return SpGEMMOut(*kops.spgemm_numeric_routed(
            a, b, rows, max_deg_a=deg_a, max_deg_b=deg_b,
            row_capacity=row_capacity, route=route))
    kops.check_route(route)
    return spgemm_rows(a, b, rows, row_capacity=row_capacity,
                       max_deg_a=deg_a, max_deg_b=deg_b)


def assemble(nrows: int, cap_out: int, parts, device) -> SpGEMMOut:
    """Write per-bucket results into one ``(nrows, cap_out)`` output.

    ``parts`` yields ``(rows, SpGEMMOut)`` pairs, one per bucket, whose rows
    partition the output rows.  Each bucket's ``(rows, cap)`` block lands in
    its rows' first ``cap`` slots of a buffer pre-filled with the sentinel
    and 0 — in place, so the assembled output is the only full-width buffer
    (the JAX package pads every block to ``cap_out`` and concatenates, which
    holds about three output-sized buffers at once)."""
    col = torch.full((nrows, cap_out), COL_SENTINEL, dtype=torch.int32,
                     device=device)
    val = torch.zeros((nrows, cap_out), dtype=torch.float32, device=device)
    row_nnz = torch.zeros(nrows, dtype=torch.int32, device=device)
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    for rows, (c, v, n, of) in parts:
        rows = rows.long()
        col[rows, :c.shape[1]] = c
        val[rows, :v.shape[1]] = v
        row_nnz[rows] = n
        overflow = overflow + of
    return SpGEMMOut(col, val, row_nnz, overflow)


def spgemm_binned(a: CSRDevice, b: CSRDevice, plan, *,
                  alloc, use_kernel: bool = False) -> SpGEMMOut:
    """C = A·B numeric phase, bucket-iterated (DESIGN.md §4).

    ``plan`` is a ``core.binning.BinningPlan``; ``alloc`` is either an int
    (uniform row capacity) or a ``predictor.BinnedAllocationPlan``
    (per-bucket capacities)."""
    dev = a.rpt.device
    if isinstance(alloc, (int, np.integer)):
        caps = [int(alloc)] * len(plan.buckets)
        cap_out = int(alloc)
    else:
        caps = list(alloc.bucket_capacities)
        cap_out = max(caps) if caps else alloc.row_capacity

    def parts():
        for bucket, cap in zip(plan.buckets, caps):
            rows = torch.from_numpy(bucket.rows).to(dev)
            yield rows, routed_spgemm_rows(
                a, b, rows, row_capacity=cap, deg_a=bucket.deg_a,
                deg_b=bucket.deg_b, route=bucket.route,
                use_kernel=use_kernel)

    return assemble(plan.nrows, cap_out, parts(), dev)


def dense_of(out: SpGEMMOut, ncols: int) -> torch.Tensor:
    """Densify (tests only)."""
    m, cap = out.col.shape
    valid = out.col != COL_SENTINEL
    safe = torch.where(valid, out.col, 0).long()
    dense = torch.zeros((m, ncols), dtype=torch.float32, device=out.col.device)
    return dense.scatter_add_(1, safe, torch.where(valid, out.val, 0.0))
