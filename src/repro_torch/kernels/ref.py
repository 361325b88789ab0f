"""Oracles for the port's kernels, built from the ``core`` modules (the
allclose targets, as ``repro.kernels.ref`` is for the Pallas kernels)."""
from __future__ import annotations

import torch

from repro_torch.core import flop as flop_mod
from repro_torch.core import predictor as pred_mod
from repro_torch.core import spgemm as spgemm_mod
from repro_torch.core.csr import CSRDevice


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
