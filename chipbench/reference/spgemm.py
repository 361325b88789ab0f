"""``C = A·B`` computed plainly, in blocks of rows, on one device.

Each block expands its intermediate products (row ``i``, ``k`` in ``A_i``,
``j`` in ``B_k``), sorts them by ``(i, j)`` and sums the products of each
``(i, j)``.  Sums are taken in float64 from the float32 inputs (each
product of two float32 values is exact in float64), so the reference's
own rounding is far below the float32 result it judges.  A block holds at
most ``budget`` products, so memory stays bounded whatever the rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BUDGET = 1 << 25          # products a block expands at once


class Matrix(NamedTuple):
    """A CSR matrix on the reference's device."""
    rpt: torch.Tensor     # (M + 1,) int64
    col: torch.Tensor     # (nnz,) int64
    val: torch.Tensor     # (nnz,) float32
    ncols: int

    @property
    def nrows(self) -> int:
        return self.rpt.shape[0] - 1


def take_rows(a: Matrix, rows) -> Matrix:
    """The matrix of ``a``'s rows ``rows`` (in that order, repeats kept)."""
    rows = torch.as_tensor(rows, dtype=torch.int64, device=a.rpt.device)
    lo, n = a.rpt[rows], torch.diff(a.rpt)[rows]
    rpt = torch.zeros(rows.shape[0] + 1, dtype=torch.int64, device=lo.device)
    torch.cumsum(n, 0, out=rpt[1:])
    total = int(rpt[-1])
    idx = (torch.repeat_interleave(lo - rpt[:-1], n, output_size=total)
           + torch.arange(total, device=lo.device))
    return Matrix(rpt, a.col[idx], a.val[idx], a.ncols)


def row_products(a: Matrix, b: Matrix) -> torch.Tensor:
    """Intermediate products of each row of ``A·B``: the paper's FLOP of a
    row, ``Σ_{k ∈ A_i} nnz(B_k)`` (int64)."""
    deg_b = torch.diff(b.rpt)
    per_entry = deg_b[a.col]
    csum = torch.zeros(a.col.shape[0] + 1, dtype=torch.int64,
                       device=a.col.device)
    torch.cumsum(per_entry, 0, out=csum[1:])
    return csum[a.rpt[1:]] - csum[a.rpt[:-1]]


def row_blocks(rowprod: torch.Tensor, budget: int = BUDGET) -> list:
    """``(r0, r1)`` ranges of rows holding at most ``budget`` products each
    (a single row over the budget is a block of its own)."""
    ends = torch.cumsum(rowprod, 0).cpu().tolist()
    blocks, r0, base = [], 0, 0
    for r, e in enumerate(ends):
        if e - base > budget and r > r0:
            blocks.append((r0, r))
            r0, base = r, ends[r - 1]
    if r0 < len(ends):
        blocks.append((r0, len(ends)))
    return blocks


def expand(a: Matrix, b: Matrix, r0: int, r1: int):
    """The intermediate products of rows ``[r0, r1)``: each one's row (from
    ``r0``), its A entry and its B entry (entry indices, int64)."""
    dev = a.col.device
    e0, e1 = int(a.rpt[r0]), int(a.rpt[r1])
    k = a.col[e0:e1]
    deg = b.rpt[k + 1] - b.rpt[k]
    n = int(deg.sum())
    ent = torch.repeat_interleave(torch.arange(e1 - e0, device=dev), deg,
                                  output_size=n)
    start = torch.cumsum(deg, 0) - deg
    b_ent = b.rpt[k][ent] + torch.arange(n, device=dev) - start[ent]
    row = torch.repeat_interleave(torch.arange(r1 - r0, device=dev),
                                  torch.diff(a.rpt[r0:r1 + 1]),
                                  output_size=e1 - e0)[ent]
    return row, ent + e0, b_ent


class Block(NamedTuple):
    """Rows ``[r0, r1)`` of C: per-row counts, then per entry the column,
    the sum and the sum of the products' magnitudes."""
    r0: int
    r1: int
    counts: torch.Tensor  # (r1 - r0,) int64
    col: torch.Tensor     # int64, ascending within a row
    val: torch.Tensor     # float64 (or the control's dtype)
    mag: torch.Tensor     # float64 Σ|a_ik·b_kj| of each entry


def product_block(a: Matrix, b: Matrix, r0: int, r1: int,
                  dtype=torch.float64) -> Block:
    """Rows ``[r0, r1)`` of ``A·B``.  ``dtype`` is the precision of the
    products and of their sums: float64 for the reference; a lower one
    (bfloat16) computes the control."""
    row, ea, eb = expand(a, b, r0, r1)
    col = b.col[eb]
    keys, order = torch.sort(row * b.ncols + col)
    prod = a.val[ea].to(dtype) * b.val[eb].to(dtype)
    del row, ea, eb, col
    uniq, inv = torch.unique_consecutive(keys, return_inverse=True)
    del keys
    prod = prod[order]
    val = torch.zeros(uniq.shape[0], dtype=dtype, device=uniq.device)
    val.index_add_(0, inv, prod)
    mag = torch.zeros(uniq.shape[0], dtype=torch.float64, device=uniq.device)
    mag.index_add_(0, inv, prod.abs().to(torch.float64))
    counts = torch.bincount(uniq // b.ncols, minlength=r1 - r0)
    return Block(r0, r1, counts, uniq % b.ncols, val, mag)


def blocks(a: Matrix, b: Matrix, budget: int = BUDGET,
           dtype=torch.float64):
    """Every row block of ``A·B`` in row order (a generator)."""
    for r0, r1 in row_blocks(row_products(a, b), budget):
        yield product_block(a, b, r0, r1, dtype)


def exact_row_counts(a: Matrix, b: Matrix, edges=None,
                     budget: int = BUDGET) -> torch.Tensor:
    """nnz of each row of ``A·B`` (int64, ``(M,)``), or with column
    ``edges`` (``P + 1`` ascending bounds) of each row restricted to each
    column range (``(M, P)``).  Only the pattern is read."""
    dev = a.col.device
    npan = 1 if edges is None else len(edges) - 1
    out = torch.zeros((a.nrows, npan), dtype=torch.int64, device=dev)
    if edges is not None:
        edges = torch.as_tensor(edges, dtype=torch.int64, device=dev)
    for r0, r1 in row_blocks(row_products(a, b), budget):
        row, _, eb = expand(a, b, r0, r1)
        uniq = torch.unique(row * b.ncols + b.col[eb])
        del row, eb
        pid = (torch.zeros_like(uniq) if edges is None else
               torch.searchsorted(edges, uniq % b.ncols, right=True) - 1)
        out[r0:r1] = torch.bincount((uniq // b.ncols) * npan + pid,
                                    minlength=(r1 - r0) * npan
                                    ).reshape(r1 - r0, npan)
    return out[:, 0] if edges is None else out
