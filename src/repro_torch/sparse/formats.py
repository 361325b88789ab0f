"""Host-side sparse matrix substrate (numpy).

The paper stores all matrices in CSR (rpt / col / val, Fig. 1).  This module is
the host representation used by the data layer, the oracle implementations and
the test-case factory; the device (torch) representation lives in
``repro_torch.core.csr``.

No scipy in this environment — everything is built on numpy primitives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSR:
    """Compressed Sparse Row matrix (host, numpy).

    Attributes mirror the paper's notation: ``rpt`` (row pointers, len M+1),
    ``col`` (column indices, sorted within a row), ``val`` (values).
    """

    rpt: np.ndarray  # int64 (M+1,)
    col: np.ndarray  # int32 (nnz,)
    val: np.ndarray  # float32 (nnz,)
    shape: tuple[int, int]

    # ------------------------------------------------------------------ #
    # basic properties
    # ------------------------------------------------------------------ #
    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.rpt[-1])

    @property
    def row_nnz(self) -> np.ndarray:
        """NNZ per row — ``NNZ(A_{i*})`` in the paper."""
        return np.diff(self.rpt)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: Optional[np.ndarray],
        shape: tuple[int, int],
        *,
        dedup: bool = True,
        validate: bool = True,
    ) -> "CSR":
        """Build CSR from COO triplets; duplicates are summed when ``dedup``.

        ``validate`` (opt-out) runs ``repro_torch.core.validate.validate_csr`` on
        the result so malformed triplets (out-of-range indices, non-finite
        values) raise a pinpointed ``OperandValidationError`` here instead
        of corrupting downstream kernels (DESIGN.md §9)."""
        from repro_torch.core.errors import OperandValidationError
        m, n = shape
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if vals is None:
            vals = np.ones(rows.shape[0], dtype=np.float32)
        vals = np.asarray(vals, dtype=np.float32)
        if rows.size:
            if rows.min() < 0 or rows.max() >= m:
                bad = int(np.flatnonzero((rows < 0) | (rows >= m))[0])
                raise OperandValidationError(
                    f"COO row index {int(rows[bad])} out of range [0, {m})",
                    field="row", index=bad, observed=int(rows[bad]),
                    planned=m)
            if cols.min() < 0 or cols.max() >= n:
                bad = int(np.flatnonzero((cols < 0) | (cols >= n))[0])
                raise OperandValidationError(
                    f"COO col index {int(cols[bad])} out of range [0, {n})",
                    field="col", index=bad, observed=int(cols[bad]),
                    planned=n)
        keys = rows * n + cols
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
        if dedup and keys.size:
            uniq, inv = np.unique(keys, return_inverse=True)
            summed = np.zeros(uniq.shape[0], dtype=np.float64)
            np.add.at(summed, inv, vals.astype(np.float64))
            keys, vals = uniq, summed.astype(np.float32)
        out_rows = (keys // n).astype(np.int64)
        out_cols = (keys % n).astype(np.int32)
        rpt = np.zeros(m + 1, dtype=np.int64)
        np.add.at(rpt, out_rows + 1, 1)
        np.cumsum(rpt, out=rpt)
        out = CSR(rpt=rpt, col=out_cols, val=vals, shape=(m, n))
        if validate:
            from repro_torch.core.validate import validate_csr
            validate_csr(out, name="from_coo", allow_duplicates=not dedup)
        return out

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        rows = np.repeat(np.arange(self.nrows), self.row_nnz)
        out[rows, self.col] = self.val
        return out

    # ------------------------------------------------------------------ #
    # the paper's dimension-matching reshape rule (Section VI-A)
    # ------------------------------------------------------------------ #
    def keep_left_cols(self, k: int) -> "CSR":
        """Keep the left ``k`` columns (paper: reshape A when K_A > rows(B))."""
        assert k <= self.ncols
        mask = self.col < k
        rows = np.repeat(np.arange(self.nrows), self.row_nnz)[mask]
        return CSR.from_coo(rows, self.col[mask], self.val[mask], (self.nrows, k), dedup=False)

    def keep_top_rows(self, k: int) -> "CSR":
        """Keep the top ``k`` rows (paper: reshape B when rows(B) > K_A)."""
        assert k <= self.nrows
        end = int(self.rpt[k])
        return CSR(
            rpt=self.rpt[: k + 1].copy(),
            col=self.col[:end].copy(),
            val=self.val[:end].copy(),
            shape=(k, self.ncols),
        )


def match_dims(a: CSR, b: CSR) -> tuple[CSR, CSR]:
    """Apply the paper's reshape rule so that ``a @ b`` is well-defined.

    'If the dimensions of the two input matrices are 10x10 and 5x5, we reshape
    the first matrix to a 10x5 matrix by keeping its left 5 columns.  If the
    dimensions are 5x5 and 10x10, we reshape the second to 5x10 by keeping
    its top 5 rows.'
    """
    if a.ncols == b.nrows:
        return a, b
    if a.ncols > b.nrows:
        return a.keep_left_cols(b.nrows), b
    return a, b.keep_top_rows(a.ncols)


def spgemm_dense_oracle(a: CSR, b: CSR) -> np.ndarray:
    """Tiny-scale dense oracle for numeric tests (O(M*K*N) memory)."""
    return a.to_dense() @ b.to_dense()
