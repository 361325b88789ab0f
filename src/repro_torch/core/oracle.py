"""Numpy oracles of the paper's output-structure quantities (host-side).

The ground truth the device pipeline is checked against:

  * ``flop_per_row``    — Algorithm 1: the upper-bound method.
  * ``exact_structure`` — the precise method (symbolic phase).
  * ``sample_rows``     — Algorithm 2 lines 1-3: the sampled row ids.

All functions operate on host ``CSR`` (see ``repro_torch.sparse.formats``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.formats import CSR

# Paper, Algorithm 2 line 1: sample_num = min(0.003 * M, 300).
SAMPLE_FRACTION = 0.003
SAMPLE_CAP = 300


def flop_per_row(a: CSR, b: CSR) -> tuple[np.ndarray, int]:
    """floprC[i] = sum_{k in cols(A_i*)} nnz(B_k*);  total_flop = sum_i floprC[i].

    Vectorized equivalent of the paper's Algorithm 1: only touches A.rpt,
    A.col and B.rpt.
    """
    assert a.ncols == b.nrows, (a.shape, b.shape)
    contrib = b.row_nnz[a.col]  # one entry per nonzero of A
    row_of_nnz = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz)
    floprc = np.zeros(a.nrows, dtype=np.int64)
    np.add.at(floprc, row_of_nnz, contrib)
    return floprc, int(floprc.sum())


def _slice_concat(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Vectorized concatenation of index ranges [starts_i, starts_i+counts_i)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    offs = np.cumsum(counts) - counts
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(offs, counts)
    out += np.repeat(starts.astype(np.int64), counts)
    return out


def expand_products(a: CSR, b: CSR, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All intermediate products C_{i*} += A_ik * B_k* for the given A rows.

    Returns ``(owner, col)``: ``owner`` indexes into ``rows`` and ``col`` is
    the output column of each product.
    """
    rows = np.asarray(rows, dtype=np.int64)
    deg_a = (a.rpt[rows + 1] - a.rpt[rows]).astype(np.int64)
    idx_a = _slice_concat(a.rpt[rows], deg_a)
    ks = a.col[idx_a].astype(np.int64)
    owner_a = np.repeat(np.arange(rows.size, dtype=np.int64), deg_a)
    deg_b = (b.rpt[ks + 1] - b.rpt[ks]).astype(np.int64)
    idx_b = _slice_concat(b.rpt[ks], deg_b)
    col = b.col[idx_b].astype(np.int64)
    owner = np.repeat(owner_a, deg_b)
    return owner, col


def exact_structure(a: CSR, b: CSR, chunk_flop: int = 1 << 23) -> tuple[np.ndarray, int]:
    """Exact nnz per output row of C = A·B (structure only), and total NNZ(C).

    Rows are expanded in chunks of about ``chunk_flop`` products to bound
    peak host memory."""
    floprc, _ = flop_per_row(a, b)
    m, n = a.nrows, b.ncols
    nnzr = np.zeros(m, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(floprc)])
    start = 0
    while start < m:
        end = int(np.searchsorted(cum, cum[start] + chunk_flop, side="right"))
        end = max(start + 1, min(end, m))
        owner, col = expand_products(a, b, np.arange(start, end))
        keys = owner * np.int64(n) + col
        uniq = np.unique(keys)
        cnt = np.bincount((uniq // n).astype(np.int64), minlength=end - start)
        nnzr[start:end] = cnt
        start = end
    return nnzr, int(nnzr.sum())


def sample_rows(m: int, seed: int, fraction: float = SAMPLE_FRACTION,
                cap: int = SAMPLE_CAP) -> np.ndarray:
    """Sampled row ids, with replacement as in the paper: rid = M·rand."""
    sample_num = max(1, min(int(fraction * m), cap))
    rng = np.random.default_rng(seed)
    rand = rng.random(sample_num)  # the paper's `rand` array
    return (m * rand).astype(np.int64).clip(0, m - 1)
