"""Algorithm 1: FLOP per output row, for one degree bucket's row list or
for all M rows.

Two wrappers, each launching an entry of the hand-written CUDA source
``csrc/flop_rows.cu`` on CUDA tensors and running its plain version on CPU
tensors:

* :func:`flop_rows` (plain :func:`flop_rows_plain`) over a row-id list;
  replaces ``src/repro/kernels/flop_per_row.py::flop_rows_pallas``
  (``_rows_kernel``);
* :func:`flop_per_row` (plain :func:`flop_per_row_plain`) over all M rows;
  replaces ``flop_per_row_pallas`` (``_kernel``).

Both read at most ``max_deg_a`` entries of each A row, as the TPU kernels
do.  On the H100 they are bound by bytes: 8 bytes read per A entry (column
id, B row length) and 8 or 12 per row (two row pointers, the row id of a
list), 4 written per row.  Narrow rows run one thread per row, wide ones
one warp per row, so a warp's reads of A's column ids are contiguous.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import CSRDevice, row_chunks
from . import _build

_LIB = "flop_rows"


def flop_rows_plain(a: CSRDevice, rownnz_b: torch.Tensor, rows: torch.Tensor,
                    *, max_deg_a: int) -> torch.Tensor:
    """Plain tensor-op version: an (R, max_deg_a) gather of A's columns and a
    row sum of B's row lengths, int32."""
    rows = rows.long()
    start = a.rpt[rows].long()
    deg = a.rpt[rows + 1].long() - start
    ia = torch.arange(max_deg_a, device=a.rpt.device)
    idx = (start[:, None] + ia[None, :]).clamp(0, a.capacity - 1)
    valid = ia[None, :] < deg[:, None]
    cols = a.col[idx].long().clamp(0, rownnz_b.shape[0] - 1)
    return torch.where(valid, rownnz_b[cols], 0).sum(dim=1, dtype=torch.int32)


def flop_rows(a: CSRDevice, rownnz_b: torch.Tensor, rows: torch.Tensor, *,
              max_deg_a: int) -> torch.Tensor:
    """floprC for the listed ``rows`` (int32 (R,)), reading at most
    ``max_deg_a`` entries per A row — the bucket's bound."""
    dev = _build.kernel_device(_LIB, a.rpt, a.col, rownnz_b, rows)
    if dev is None:
        return flop_rows_plain(a, rownnz_b, rows, max_deg_a=max_deg_a)
    out = torch.empty(rows.shape[0], dtype=torch.int32, device=dev)
    if rows.shape[0] == 0:
        return out
    i32 = torch.int32
    fn = _build.launcher(_LIB, "pipppiiipip")
    rc = fn(_build.require(_LIB, rows, i32, "rows"), rows.shape[0],
            *_build.require_csr(_LIB, a, "a"),
            _build.require(_LIB, rownnz_b, i32, "rownnz_b"),
            a.nrows, rownnz_b.shape[0], int(max_deg_a), out.data_ptr(),
            dev.index or 0, _build.stream_of(dev))
    _build.check(_LIB, rc)
    flop_rows.launches += 1
    return out


flop_rows.launches = 0


def flop_per_row_plain(a: CSRDevice, rownnz_b: torch.Tensor, *,
                       max_deg_a: int) -> torch.Tensor:
    """Plain tensor-op version: :func:`flop_rows_plain` over every row of A,
    in chunks that keep the ``(rows, max_deg_a)`` gather bounded."""
    dev = a.rpt.device
    parts = [torch.zeros(0, dtype=torch.int32, device=dev)]
    for lo, hi in row_chunks(a.nrows, max_deg_a):
        rows = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        parts.append(flop_rows_plain(a, rownnz_b, rows, max_deg_a=max_deg_a))
    return torch.cat(parts)


def flop_per_row(a: CSRDevice, rownnz_b: torch.Tensor, *,
                 max_deg_a: int) -> torch.Tensor:
    """floprC for all M rows of A (int32 (M,)), reading at most
    ``max_deg_a`` entries per row: exact when ``max_deg_a`` bounds A's
    row degrees, an undercount of wider rows otherwise (as in the JAX
    package)."""
    dev = _build.kernel_device(_LIB, a.rpt, a.col, rownnz_b)
    if dev is None:
        return flop_per_row_plain(a, rownnz_b, max_deg_a=max_deg_a)
    out = torch.empty(a.nrows, dtype=torch.int32, device=dev)
    if a.nrows == 0:
        return out
    fn = _build.launcher(_LIB, "pppiiipip", entry="flop_per_row")
    rc = fn(*_build.require_csr(_LIB, a, "a"),
            _build.require(_LIB, rownnz_b, torch.int32, "rownnz_b"),
            a.nrows, rownnz_b.shape[0], int(max_deg_a), out.data_ptr(),
            dev.index or 0, _build.stream_of(dev))
    _build.check(_LIB, rc)
    flop_per_row.launches += 1
    return out


flop_per_row.launches = 0
