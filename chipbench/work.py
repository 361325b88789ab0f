"""The work a product needs, whatever implements it, and its roofline bound.

Operations: a multiply and an add per intermediate product (the paper's
FLOP, ``Σ_i Σ_{k ∈ A_i} nnz(B_k)``).  Bytes: A's and B's row pointers,
columns and values read once, and C's written once, as int32 pointers and
columns and float32 values, with ``nnz(C)`` the reference's exact count.
The bound is the larger of operations over the float32 peak and bytes over
the HBM rate.  These counts do not follow the program's choices (its
capacity slots, re-reads or kernels), so a program change leaves them as
they are."""
from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

PEAKS = Path(__file__).resolve().parent / "peaks.json"


class Work(NamedTuple):
    products: int
    ops: int
    bytes: int


def csr_bytes(nrows: int, nnz: int) -> int:
    """An int32 row pointer a row (and one more), an int32 column and a
    float32 value an entry."""
    return 4 * (nrows + 1) + 8 * nnz


def product_work(m: int, k: int, nnz_a: int, nnz_b: int, products: int,
                 nnz_c: int) -> Work:
    """The work of ``C = A·B`` with ``A`` ``m × k`` and ``C`` ``m × n``."""
    return Work(int(products), 2 * int(products),
                csr_bytes(m, nnz_a) + csr_bytes(k, nnz_b)
                + csr_bytes(m, nnz_c))


def peaks(kind: str) -> dict:
    """The data sheet's rates of the device named ``kind``."""
    table = json.loads(PEAKS.read_text())
    if kind not in table:
        raise KeyError(f"no peak rates for device {kind!r} in {PEAKS.name}")
    return table[kind]


def bound_seconds(w: Work, peak: dict) -> tuple[float, str]:
    """The least time the device could take, and which rate bounds it."""
    t_ops = w.ops / float(peak["float32_flop_per_s"])
    t_bytes = w.bytes / float(peak["hbm_bytes_per_s"])
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
