"""Numpy oracles of the paper's output-structure quantities (host-side).

The ground truth the device pipeline is checked against, and the host side
of the accuracy experiment (``core.experiment``):

  * ``flop_per_row``      — Algorithm 1: the upper-bound method.
  * ``exact_structure``   — the precise method (symbolic phase).
  * ``exact_sampled_nnz`` — z*, the exact NNZ of the sampled result rows.
  * ``sample_rows``       — Algorithm 2 lines 1-3: the sampled row ids.
  * ``reference_predict`` — the existing sampling method's reference
                            design, Z1* = z*/p (paper eq. 2).
  * ``proposed_predict``  — THE PAPER'S METHOD, r* = f*/z*, Z2* = F/r*
                            (paper eq. 4).
  * ``minhash_predict``   — the k-min-hash distinct-count estimator on the
                            same sampled product stream.
  * ``stratified_predict`` — one sampled CR* per contiguous row segment.
  * ``upper_bound_predict`` — the structure is floprC (CR assumed 1).
  * ``spgemm``            — exact C = A·B with values (numeric oracle).

All functions operate on host ``CSR`` (see ``repro_torch.sparse.formats``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


def exact_sampled_nnz(a: CSR, b: CSR, rows: np.ndarray) -> int:
    """z* — exact NNZ of the sampled result rows (Algorithm 2 lines 7-31);
    a row sampled twice counts twice."""
    owner, col = expand_products(a, b, rows)
    keys = owner * np.int64(b.ncols) + col
    return int(np.unique(keys).size)


def sample_rows(m: int, seed: int, fraction: float = SAMPLE_FRACTION,
                cap: int = SAMPLE_CAP) -> np.ndarray:
    """Sampled row ids, with replacement as in the paper: rid = M·rand."""
    sample_num = max(1, min(int(fraction * m), cap))
    rng = np.random.default_rng(seed)
    rand = rng.random(sample_num)  # the paper's `rand` array
    return (m * rand).astype(np.int64).clip(0, m - 1)


@dataclasses.dataclass
class Prediction:
    nnz_total: float          # predicted NNZ(C)  (Z1* or Z2*)
    structure: np.ndarray     # predicted nnz per output row
    compression_ratio: float  # predicted CR of the task
    sampled_flop: int         # f*
    sampled_nnz: int          # z*
    sample_num: int
    total_flop: int           # F (always exact, Algorithm 1)


def reference_predict(a: CSR, b: CSR, seed: int = 0,
                      rows: Optional[np.ndarray] = None) -> Prediction:
    """Reference design (paper eq. 2): Z1* = z*/p, structure = flopr / (F/Z1*)."""
    floprc, total_flop = flop_per_row(a, b)
    if rows is None:
        rows = sample_rows(a.nrows, seed)
    z_star = exact_sampled_nnz(a, b, rows)
    f_star = int(floprc[rows].sum())
    p = rows.size / a.nrows
    z1 = z_star / p
    cr = total_flop / max(z1, 1.0)
    return Prediction(z1, floprc / cr, cr, f_star, z_star, rows.size,
                      total_flop)


def proposed_predict(a: CSR, b: CSR, seed: int = 0,
                     rows: Optional[np.ndarray] = None) -> Prediction:
    """THE PAPER'S METHOD (eq. 4 / Algorithm 2 line 32).

    r* = f*/z*;  Z2* = F / r* = total_flop / sample_flop * sample_nnz;
    predicted structure = floprC / r*.
    """
    floprc, total_flop = flop_per_row(a, b)
    if rows is None:
        rows = sample_rows(a.nrows, seed)
    z_star = exact_sampled_nnz(a, b, rows)
    f_star = int(floprc[rows].sum())
    r_star = f_star / max(z_star, 1)
    z2 = total_flop / r_star
    return Prediction(z2, floprc / r_star, r_star, f_star, z_star, rows.size,
                      total_flop)


# --------------------------------------------------------------------------- #
# k-min hash estimator (Bar-Yossef / Amossen / Pham) — the original existing
# method's counting scheme, vectorized.
# --------------------------------------------------------------------------- #
_MERSENNE = (1 << 61) - 1


def _hash01(keys: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed ^ 0x5EED)
    aa = int(rng.integers(1, _MERSENNE))
    bb = int(rng.integers(0, _MERSENNE))
    hv = (keys.astype(np.uint64) * np.uint64(aa) + np.uint64(bb)) % np.uint64(
        _MERSENNE)
    return hv.astype(np.float64) / float(_MERSENNE)


def minhash_predict(a: CSR, b: CSR, seed: int = 0, k: int = 64,
                    rows: Optional[np.ndarray] = None) -> Prediction:
    """Existing method's estimator on the sampled product stream.

    Applies h:[m,n]→[0,1] to every intermediate product of the sampled rows,
    keeps the k-th smallest *distinct* hashed value v, and predicts
    NNZ(C') = k/v (paper Section III), then NNZ(C) = NNZ(C')/p.
    """
    floprc, total_flop = flop_per_row(a, b)
    if rows is None:
        rows = sample_rows(a.nrows, seed)
    owner, col = expand_products(a, b, rows)
    keys = owner * np.int64(b.ncols) + col
    hv = np.unique(_hash01(keys, seed))  # distinct hashed values, sorted
    if hv.size <= k:  # fewer distinct than k → count is exact
        z_star = float(hv.size)
    else:
        v = hv[k - 1]
        z_star = k / v if v > 0 else float(hv.size)
    f_star = int(floprc[rows].sum())
    p = rows.size / a.nrows
    z_pred = z_star / p
    cr = total_flop / max(z_pred, 1.0)
    return Prediction(z_pred, floprc / cr, cr, f_star, int(z_star), rows.size,
                      total_flop)


def stratified_predict(a: CSR, b: CSR, seed: int = 0, num_segments: int = 64,
                       per_segment: int = 8) -> Prediction:
    """BEYOND-PAPER: stratified sampled-CR for heterogeneous matrices.

    The paper's prediction divides flopr by ONE global CR*, so its structure
    estimate is proportional to flopr — it cannot distinguish regions whose
    per-row compression differs (and prediction-balanced partitions then
    coincide with FLOP-balanced ones).  Stratifying the sample — a few rows
    per contiguous row segment, one CR* per segment — keeps the paper's
    error-cancellation *within* each stratum while capturing CR variation
    *across* strata.  Cost: num_segments×per_segment sampled rows (512 at the
    defaults) vs min(0.003·M, 300); still ≪ the precise method.
    """
    floprc, total_flop = flop_per_row(a, b)
    bounds = np.linspace(0, a.nrows, num_segments + 1).astype(np.int64)
    structure = np.zeros(a.nrows, dtype=np.float64)
    rng = np.random.default_rng(seed)
    f_star_total = 0
    z_star_total = 0
    for s in range(num_segments):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        if hi <= lo:
            continue
        rows = lo + (rng.random(per_segment) * (hi - lo)).astype(np.int64)
        f_star = int(floprc[rows].sum())
        if f_star == 0:
            structure[lo:hi] = 0.0
            continue
        z_star = exact_sampled_nnz(a, b, rows)
        cr = f_star / max(z_star, 1)
        structure[lo:hi] = floprc[lo:hi] / cr
        f_star_total += f_star
        z_star_total += z_star
    total = float(structure.sum())
    cr_glob = total_flop / max(total, 1.0)
    return Prediction(total, structure, cr_glob, f_star_total, z_star_total,
                      num_segments * per_segment, total_flop)


def upper_bound_predict(a: CSR, b: CSR) -> Prediction:
    """Upper-bound method: the structure IS floprC (CR assumed 1)."""
    floprc, total_flop = flop_per_row(a, b)
    return Prediction(float(total_flop), floprc.astype(np.float64), 1.0,
                      total_flop, total_flop, 0, total_flop)


# --------------------------------------------------------------------------- #
# Numeric SpGEMM oracle (values), used by the numeric-kernel tests
# --------------------------------------------------------------------------- #
def spgemm(a: CSR, b: CSR, chunk_flop: int = 1 << 23) -> CSR:
    """Exact C = A·B via row-wise expansion + key-collapse (host oracle)."""
    floprc, _ = flop_per_row(a, b)
    m, n = a.nrows, b.ncols
    cum = np.concatenate([[0], np.cumsum(floprc)])
    rows_out, cols_out, vals_out = [], [], []
    start = 0
    while start < m:
        end = int(np.searchsorted(cum, cum[start] + chunk_flop, side="right"))
        end = max(start + 1, min(end, m))
        rows = np.arange(start, end)
        deg_a = (a.rpt[rows + 1] - a.rpt[rows]).astype(np.int64)
        idx_a = _slice_concat(a.rpt[rows], deg_a)
        ks = a.col[idx_a].astype(np.int64)
        av = a.val[idx_a]
        owner_a = np.repeat(np.arange(rows.size, dtype=np.int64), deg_a)
        deg_b = (b.rpt[ks + 1] - b.rpt[ks]).astype(np.int64)
        idx_b = _slice_concat(b.rpt[ks], deg_b)
        col = b.col[idx_b].astype(np.int64)
        prod = np.repeat(av, deg_b) * b.val[idx_b]
        owner = np.repeat(owner_a, deg_b)
        keys = owner * np.int64(n) + col
        uniq, inv = np.unique(keys, return_inverse=True)
        acc = np.zeros(uniq.size, dtype=np.float64)
        np.add.at(acc, inv, prod.astype(np.float64))
        rows_out.append((uniq // n) + start)
        cols_out.append(uniq % n)
        vals_out.append(acc.astype(np.float32))
        start = end
    return CSR.from_coo(np.concatenate(rows_out), np.concatenate(cols_out),
                        np.concatenate(vals_out), (m, n), dedup=False)
