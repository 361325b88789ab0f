"""Host-side CSR operand validation (DESIGN.md §9).

``validate_csr`` checks every invariant the kernels silently assume —
``rpt`` monotonicity and length, column bounds and intra-row sortedness /
duplicates, NaN/Inf values, dtype contracts — and raises a pinpointed
:class:`~repro_torch.core.errors.OperandValidationError` instead of letting a
malformed operand produce garbage output or an out-of-bounds read deep in a
CUDA kernel.

Wired into ``CSR.from_coo`` (opt-out via ``validate=
False``), ``plan_spgemm`` and ``SpgemmPlan.to_device``.  All checks are
vectorized numpy passes, O(nnz) — the same order as the host work planning
already does (structural sketch, FLOP counting).
"""
from __future__ import annotations

import numpy as np

from .errors import OperandValidationError


def _row_of(rpt: np.ndarray, entry: int) -> int:
    """Row owning flat entry index ``entry`` (for pinpointed errors)."""
    return int(np.searchsorted(rpt, entry, side="right") - 1)


def validate_csr(m, *, name: str = "operand", allow_duplicates: bool = False,
                 check_values: bool = True) -> None:
    """Validate one host CSR operand; raise ``OperandValidationError`` with
    the offending field and first bad row/entry in ``context`` on the first
    violated invariant.

    ``allow_duplicates`` permits repeated columns within a row (a
    ``from_coo(dedup=False)`` matrix is allowed to carry them); sortedness
    is still required.  ``check_values=False`` skips the NaN/Inf scan for
    callers whose values are allowed to be non-finite.
    """
    def fail(msg: str, **ctx):
        raise OperandValidationError(f"{name}: {msg}", operand=name, **ctx)

    shape = getattr(m, "shape", None)
    if shape is None or len(shape) != 2 or shape[0] < 0 or shape[1] < 0:
        fail(f"shape {shape!r} is not a valid 2-D matrix shape",
             field="shape", observed=list(shape) if shape else None)
    nrows, ncols = int(shape[0]), int(shape[1])

    rpt = np.asarray(m.rpt)
    col = np.asarray(m.col)
    val = np.asarray(m.val)
    if rpt.ndim != 1 or not np.issubdtype(rpt.dtype, np.integer):
        fail(f"rpt must be a 1-D integer array, got ndim={rpt.ndim} "
             f"dtype={rpt.dtype}", field="rpt")
    if rpt.size != nrows + 1:
        fail(f"rpt length {rpt.size} != nrows+1 = {nrows + 1}",
             field="rpt", observed=int(rpt.size), planned=nrows + 1)
    if int(rpt[0]) != 0:
        fail(f"rpt[0] must be 0, got {int(rpt[0])}", field="rpt", index=0,
             observed=int(rpt[0]))
    drop = np.flatnonzero(np.diff(rpt) < 0)
    if drop.size:
        r = int(drop[0])
        fail(f"rpt not monotone at row {r}: {int(rpt[r])} -> "
             f"{int(rpt[r + 1])}", field="rpt", row=r,
             observed=int(rpt[r + 1]))
    nnz = int(rpt[-1])
    if col.ndim != 1 or not np.issubdtype(col.dtype, np.integer):
        fail(f"col must be a 1-D integer array, got ndim={col.ndim} "
             f"dtype={col.dtype}", field="col")
    if col.size != nnz:
        fail(f"col length {col.size} != rpt[-1] = {nnz}", field="col",
             observed=int(col.size), planned=nnz)
    if val.ndim != 1 or not np.issubdtype(val.dtype, np.floating):
        fail(f"val must be a 1-D float array, got ndim={val.ndim} "
             f"dtype={val.dtype}", field="val")
    if val.size != nnz:
        fail(f"val length {val.size} != rpt[-1] = {nnz}", field="val",
             observed=int(val.size), planned=nnz)
    if nnz:
        bad = np.flatnonzero((col < 0) | (col >= ncols))
        if bad.size:
            e = int(bad[0])
            fail(f"col[{e}] = {int(col[e])} out of range [0, {ncols}) "
                 f"(row {_row_of(rpt, e)})", field="col", index=e,
                 row=_row_of(rpt, e), observed=int(col[e]), planned=ncols)
        # intra-row order: col must ascend within a row (strictly unless
        # duplicates are allowed); violations at row boundaries are fine
        d = np.diff(col.astype(np.int64))
        interior = np.ones(max(0, nnz - 1), dtype=bool)
        bnd = np.asarray(rpt[1:-1], dtype=np.int64)
        bnd = bnd[(bnd > 0) & (bnd < nnz)]  # empty rows repeat 0 / nnz
        interior[bnd - 1] = False           # last entry of each row
        bad = np.flatnonzero(interior &
                             ((d < 0) if allow_duplicates else (d <= 0)))
        if bad.size:
            e = int(bad[0])
            kind = "unsorted" if col[e + 1] < col[e] else "duplicate"
            fail(f"{kind} columns in row {_row_of(rpt, e)}: "
                 f"col[{e}]={int(col[e])}, col[{e + 1}]={int(col[e + 1])}",
                 field="col", index=e + 1, row=_row_of(rpt, e),
                 observed=int(col[e + 1]))
        if check_values:
            bad = np.flatnonzero(~np.isfinite(val))
            if bad.size:
                e = int(bad[0])
                fail(f"non-finite val[{e}] = {val[e]} "
                     f"(row {_row_of(rpt, e)})", field="val", index=e,
                     row=_row_of(rpt, e), observed=repr(float(val[e])))


def validate_pair(a, b) -> None:
    """Validate an SpGEMM operand pair, including A·B dimension compatibility."""
    validate_csr(a, name="a")
    validate_csr(b, name="b")
    if a.shape[1] != b.shape[0]:
        raise OperandValidationError(
            f"operand shapes {a.shape} x {b.shape} are incompatible for "
            "A·B (a.ncols must equal b.nrows)", operand="pair",
            field="shape", observed=list(a.shape) + list(b.shape))
