"""Algorithm 1: FLOP per output row, for one degree bucket's row list, for
all M rows of a binned plan at once, or for all M rows at one bound.

Three wrappers, each launching an entry of the hand-written CUDA source
``csrc/flop_rows.cu`` (one kernel body) on CUDA tensors and running its
plain version on CPU tensors:

* :func:`flop_rows` (plain :func:`flop_rows_plain`) over a row-id list at
  one bucket's bound; replaces
  ``src/repro/kernels/flop_per_row.py::flop_rows_pallas`` (``_rows_kernel``);
* :func:`flop_rows_buckets` (plain :func:`flop_rows_buckets_plain`): what
  ``flop_rows_pallas`` gives bucket by bucket, for every row of a binned
  plan in one launch, in row order — the binned predictor's floprC;
* :func:`flop_per_row` (plain :func:`flop_per_row_plain`) over all M rows;
  replaces ``flop_per_row_pallas`` (``_kernel``).

Each reads at most its row's bound of A entries, as the TPU kernels do.  On
the H100 they are bound by bytes: 8 bytes read per A entry (column id, B row
length) and 8 or 12 per row (two row pointers, the row id of a list or the
bucket id), 4 written per row.  In the first two, rows whose bound is at
most :data:`FLOP_NARROW` run one thread per row, wider ones one warp per
row, so a warp's reads of A's column ids are contiguous.  The all-rows
kernel gives each warp a run of consecutive rows (as many as hold about 256
entries on average, 32 at most, fewer where a hub row at the bound would
hold the warp up) and streams their entries as one coalesced range,
summing each row's share by a prefix scan across the warp.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.csr import CSRDevice, row_chunks
from . import _build

_LIB = "flop_rows"
# csrc/flop_rows.cu: rows whose bound is at most this take one thread each
# (the kernel's thread part skips the others, which flop_tables lists)
FLOP_NARROW = _build.source_define(_LIB, "FLOP_NARROW")


class FlopTables(NamedTuple):
    """A binned plan's tables for :func:`flop_rows_buckets` on one device
    (built by :func:`flop_tables`): one int32 tensor holding the row →
    bucket map, each bucket's bound on A's rows, and the ascending rows
    whose bound is past :data:`FLOP_NARROW`, in that order."""

    packed: torch.Tensor
    n_rows: int
    n_buckets: int

    @property
    def row_bucket(self) -> torch.Tensor:
        return self.packed[:self.n_rows]

    @property
    def deg_a(self) -> torch.Tensor:
        return self.packed[self.n_rows:self.n_rows + self.n_buckets]

    @property
    def wide(self) -> torch.Tensor:
        return self.packed[self.n_rows + self.n_buckets:]


def flop_tables(row_bucket, deg_a, device) -> FlopTables:
    """:class:`FlopTables` from a plan's row → bucket map and its buckets'
    ``deg_a`` bounds (host arrays), uploaded to ``device`` in one copy."""
    row_bucket = np.asarray(row_bucket, dtype=np.int32)
    deg_a = np.asarray(deg_a, dtype=np.int32)
    wide = np.flatnonzero(deg_a[row_bucket] > FLOP_NARROW).astype(np.int32)
    packed = torch.from_numpy(np.concatenate([row_bucket, deg_a, wide]))
    return FlopTables(packed.to(device), row_bucket.size, deg_a.size)


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


def flop_rows_buckets_plain(a: CSRDevice, rownnz_b: torch.Tensor,
                            tables: FlopTables) -> torch.Tensor:
    """Plain tensor-op version: :func:`flop_rows_plain` over each bucket's
    rows at its bound, scattered into row order."""
    out = torch.zeros(tables.row_bucket.shape[0], dtype=torch.int32,
                      device=tables.row_bucket.device)
    for b, deg_a in enumerate(tables.deg_a.tolist()):
        rows = torch.nonzero(tables.row_bucket == b)[:, 0]
        if rows.numel():
            out[rows] = flop_rows_plain(a, rownnz_b, rows, max_deg_a=deg_a)
    return out


def flop_rows_buckets(a: CSRDevice, rownnz_b: torch.Tensor,
                      tables: FlopTables) -> torch.Tensor:
    """floprC for every row of a binned plan (int32 (M,), row order) in one
    launch, row ``i`` reading at most ``tables.deg_a[tables.row_bucket[i]]``
    entries of A — its bucket's bound."""
    dev = _build.kernel_device(_LIB, a.rpt, a.col, rownnz_b, tables.packed)
    if dev is None:
        return flop_rows_buckets_plain(a, rownnz_b, tables)
    n, nb = tables.n_rows, tables.n_buckets
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    i32 = torch.int32
    base = _build.require(_LIB, tables.packed, i32, "tables")
    if tables.packed.shape[0] < n + nb:
        raise RuntimeError(f"{_LIB}: tables hold {tables.packed.shape[0]} "
                           f"ints for {n} rows and {nb} buckets")
    fn = _build.launcher(_LIB, "pipipipppiipip", entry="flop_rows_buckets")
    rc = fn(base, n, base + 4 * n, nb, base + 4 * (n + nb),
            tables.packed.shape[0] - n - nb, *_build.require_csr(_LIB, a, "a"),
            _build.require(_LIB, rownnz_b, i32, "rownnz_b"), a.nrows,
            rownnz_b.shape[0], out.data_ptr(), dev.index or 0,
            _build.stream_of(dev))
    _build.check(_LIB, rc)
    flop_rows_buckets.launches += 1
    return out


flop_rows_buckets.launches = 0


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
    fn = _build.launcher(_LIB, "pppiiiqpip", entry="flop_per_row")
    rc = fn(*_build.require_csr(_LIB, a, "a"),
            _build.require(_LIB, rownnz_b, torch.int32, "rownnz_b"),
            a.nrows, rownnz_b.shape[0], int(max_deg_a), a.col.shape[0],
            out.data_ptr(), dev.index or 0, _build.stream_of(dev))
    _build.check(_LIB, rc)
    flop_per_row.launches += 1
    return out


flop_per_row.launches = 0
