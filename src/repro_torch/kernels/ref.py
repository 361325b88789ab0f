"""Oracles for the port's kernels, built from the ``core`` modules (the
allclose targets, as ``repro.kernels.ref`` is for the Pallas kernels)."""
from __future__ import annotations

import torch

from repro_torch.core import flop as flop_mod
from repro_torch.core import predictor as pred_mod
from repro_torch.core import spgemm as spgemm_mod
from repro_torch.core.csr import CSRDevice


def flop_per_row_ref(a_rpt, a_col, rownnz_b):
    """Oracle for kernels.flop_per_row.flop_per_row: Algorithm 1 over every
    row of A (``core.flop``), from A's index arrays and B's row lengths."""
    m = a_rpt.shape[0] - 1
    k = rownnz_b.shape[0]
    a = CSRDevice(rpt=a_rpt, col=a_col,
                  val=torch.zeros(a_col.shape[0], dtype=torch.float32,
                                  device=a_col.device), shape=(m, k))
    b_rpt = torch.cat([rownnz_b.new_zeros(1),
                       torch.cumsum(rownnz_b, 0, dtype=torch.int32)])
    b = CSRDevice(rpt=b_rpt, col=rownnz_b.new_zeros(1),
                  val=torch.zeros(1, dtype=torch.float32,
                                  device=rownnz_b.device), shape=(k, 1))
    floprc, _ = flop_mod.flop_per_row(a, b)
    return floprc


def sampled_symbolic_ref(a: CSRDevice, b: CSRDevice, rows, max_deg_a,
                         max_deg_b):
    """Oracle for kernels.spgemm_symbolic.sampled_symbolic: (z*, f*), f*
    the gathered products."""
    cols, valid = pred_mod.gather_sampled_products(a, b, rows, max_deg_a,
                                                   max_deg_b)
    z = pred_mod.count_distinct_sorted(cols).sum(dtype=torch.int32)
    return z, valid.sum(dtype=torch.int32)


def flop_rows_ref(a: CSRDevice, b: CSRDevice, rows):
    """Oracle for kernels.flop_per_row.flop_rows: whole-matrix FLOP,
    gathered at ``rows``."""
    floprc, _ = flop_mod.flop_per_row(a, b)
    return floprc[rows.long()]


def fused_flop_symbolic_ref(a: CSRDevice, b: CSRDevice, rows, max_deg_a,
                            max_deg_b):
    """Oracle for kernels.spgemm_symbolic.fused_flop_symbolic:
    (z*, f*, FLOP per sampled row)."""
    cols, valid = pred_mod.gather_sampled_products(a, b, rows, max_deg_a,
                                                   max_deg_b)
    z = pred_mod.count_distinct_sorted(cols).sum(dtype=torch.int32)
    flop = valid.sum(dim=-1, dtype=torch.int32)
    return z, flop.sum(dtype=torch.int32), flop


def spgemm_numeric_ref(a: CSRDevice, b: CSRDevice, rows, max_deg_a, max_deg_b,
                       row_capacity):
    """Oracle for kernels.spgemm_numeric.spgemm_numeric: (col, val, row_nnz,
    overflow) of one unchunked sort-merge block."""
    cols, vals, _ = spgemm_mod.gather_products(a, b, rows, max_deg_a,
                                               max_deg_b)
    return spgemm_mod._accumulate_block(cols, vals, row_capacity)


def bitmask_symbolic_ref(a: CSRDevice, b: CSRDevice, rows, max_deg_a,
                         max_deg_b):
    """Oracle for the bitmask symbolic kernel: (z*, f*) by dense presence
    over B's whole column space — equal to the ESC counts bit for bit, since
    a distinct count is a property of the column set."""
    cols, valid = pred_mod.gather_sampled_products(a, b, rows, max_deg_a,
                                                   max_deg_b)
    z = pred_mod.count_distinct_dense(cols, b.ncols).sum(dtype=torch.int32)
    return z, valid.sum(dtype=torch.int32)


def spa_numeric_ref(a: CSRDevice, b: CSRDevice, rows, max_deg_a, max_deg_b,
                    row_capacity):
    """Oracle for kernels.accumulator.spa_numeric: one unchunked dense
    scatter-add over B's whole column space, compacted."""
    cols, vals, _ = spgemm_mod.gather_products(a, b, rows, max_deg_a,
                                               max_deg_b)
    return spgemm_mod._dense_accumulate_block(cols, vals, b.ncols,
                                              row_capacity)


def bin_numeric_ref(a: CSRDevice, b: CSRDevice, rows, max_deg_a, max_deg_b,
                    row_capacity, tile_n, n_tiles):
    """Oracle for kernels.accumulator.bin_numeric: one unchunked
    propagation-blocking block (per-bin compaction, runs concatenated)."""
    cols, vals, _ = spgemm_mod.gather_products(a, b, rows, max_deg_a,
                                               max_deg_b)
    return spgemm_mod._bin_accumulate_block(cols, vals, row_capacity, tile_n,
                                            n_tiles)


def attention_ref(q, k, v, *, causal: bool = True):
    """Oracle for kernels.flash_attention, a copy of the JAX package's:
    dense softmax attention in float32, output in q's dtype.  Its causal
    mask is bottom-right aligned (``tril(k=sk - sq)``) where the kernel's is
    top-left, so they agree only at ``Sq == Sk`` (ROADMAP fault R6)."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    kf = torch.repeat_interleave(k, group, dim=1).float()
    vf = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / (d ** 0.5)
    if causal:
        sk = k.shape[2]
        mask = torch.tril(torch.ones(sq, sk, dtype=torch.bool,
                                     device=q.device), diagonal=sk - sq)
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
