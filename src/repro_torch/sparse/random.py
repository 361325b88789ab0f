"""Synthetic sparse matrix generators.

The paper evaluates on 25 SuiteSparse matrices chosen for their *diversity of
compression ratio* (Table II: CR of A^2 from 1.01 to 28.34) and row-degree
structure (uniform rows like m133-b3, power-law rows like webbase-1M, banded
FEM matrices like cant/pdb1HYS).  SuiteSparse is not available offline, so
these generators reproduce the structural families that drive that CR spread:

* ``erdos_renyi``   — uniform random columns; products rarely collide → CR ≈ 1.
  (paper analogues: m133-b3, mc2depi, patents_main)
* ``power_law``     — Zipf row degrees + hub columns; mild collision → CR 1–3.
  (analogues: webbase-1M, patents_main, scircuit)
* ``banded``        — columns confined to a diagonal band; dense bands make
  products collide heavily → CR grows with nnz/row vs band width.
  (analogues: cant, hood, consph, shipsec1, pwtk, pdb1HYS)
* ``rmat``          — recursive power-law graph (graph-analytics analogue,
  cage*/delaunay-like mid CR).

All generators are deterministic in ``seed`` and return host ``CSR``.
"""
from __future__ import annotations

import numpy as np

from .formats import CSR


def _dedup_rowwise(rows: np.ndarray, cols: np.ndarray, shape) -> CSR:
    return CSR.from_coo(rows, cols, None, shape, dedup=True)


def erdos_renyi(m: int, n: int, nnz_per_row: int, seed: int) -> CSR:
    """Uniform random columns, ~Poisson row degree around ``nnz_per_row``."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(nnz_per_row, size=m).clip(1, n)
    rows = np.repeat(np.arange(m, dtype=np.int64), deg)
    cols = rng.integers(0, n, size=rows.shape[0], dtype=np.int64)
    return _dedup_rowwise(rows, cols, (m, n))


def power_law(m: int, n: int, avg_nnz: int, alpha: float, seed: int) -> CSR:
    """Zipf-ish row degrees and hub-biased columns (web/citation-like)."""
    rng = np.random.default_rng(seed)
    # Row degrees: Pareto tail scaled to the requested mean, clipped.
    raw = rng.pareto(alpha, size=m) + 1.0
    deg = np.maximum(1, (raw * (avg_nnz / raw.mean())).astype(np.int64))
    deg = deg.clip(1, min(n, 50 * avg_nnz))
    rows = np.repeat(np.arange(m, dtype=np.int64), deg)
    # Hub columns: squared-uniform bias toward low indices.
    u = rng.random(rows.shape[0])
    cols = (u * u * n).astype(np.int64).clip(0, n - 1)
    return _dedup_rowwise(rows, cols, (m, n))


def banded(m: int, n: int, nnz_per_row: int, band: int, seed: int) -> CSR:
    """Columns near the scaled diagonal — FEM-like; high CR when band is tight."""
    rng = np.random.default_rng(seed)
    deg = np.full(m, nnz_per_row, dtype=np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), deg)
    center = (rows.astype(np.float64) * n / m).astype(np.int64)
    off = rng.integers(-band, band + 1, size=rows.shape[0])
    cols = (center + off).clip(0, n - 1)
    return _dedup_rowwise(rows, cols, (m, n))


def rmat(m: int, n: int, nnz: int, seed: int, a=0.57, b=0.19, c=0.19) -> CSR:
    """R-MAT recursive generator (power-law graph, cage/delaunay analogue)."""
    rng = np.random.default_rng(seed)
    scale_r = int(np.ceil(np.log2(max(m, 2))))
    scale_c = int(np.ceil(np.log2(max(n, 2))))
    scale = max(scale_r, scale_c)
    rows = np.zeros(nnz, dtype=np.int64)
    cols = np.zeros(nnz, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(nnz)
        down = r >= a + b  # bottom half of the quadtree
        right = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        rows = rows * 2 + down
        cols = cols * 2 + right
    rows = rows % m
    cols = cols % n
    return _dedup_rowwise(rows, cols, (m, n))


def block_diag_fem(m: int, n: int, block: int, fill: float, seed: int) -> CSR:
    """Overlapping near-dense diagonal blocks (pdb1HYS-like, very high CR)."""
    rng = np.random.default_rng(seed)
    nblocks = max(1, m // block)
    rows_list, cols_list = [], []
    for bi in range(nblocks):
        r0 = bi * block
        c0 = int(r0 * n / m)
        bh = min(block, m - r0)
        bw = min(int(block * n / m) + block // 2, n - c0)
        if bw <= 0:
            continue
        cnt = int(fill * bh * bw)
        rows_list.append(r0 + rng.integers(0, bh, size=cnt))
        cols_list.append(c0 + rng.integers(0, bw, size=cnt))
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    return _dedup_rowwise(rows, cols, (m, n))
