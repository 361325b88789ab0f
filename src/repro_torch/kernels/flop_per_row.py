"""Algorithm 1 for one degree bucket: FLOP per listed output row.

``flop_rows`` launches the hand-written CUDA kernel ``csrc/flop_rows.cu`` on
CUDA tensors and runs :func:`flop_rows_plain` on CPU tensors.

Replaces ``src/repro/kernels/flop_per_row.py::flop_rows_pallas``
(``_rows_kernel``).  On the H100 the kernel is bound by bytes: 12 bytes read
per A entry (column id, B row length) and per row (two row pointers, the
row id), 4 written per row.  Narrow buckets run one thread per row, wide
ones one warp per row, so a warp's reads of A's column ids are contiguous.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import CSRDevice
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
