"""Algorithm 2 (ESC symbolic) over sampled rows: one hand-written CUDA
kernel, ``csrc/esc_symbolic.cu``, behind four wrappers.

Each wrapper launches the kernel on CUDA tensors and runs its plain version
on CPU tensors:

* :func:`fused_flop_symbolic` → ``(z*, f*, flop per sampled row)``: the
  sampled distinct-column count, the sampled FLOP and Algorithm 1's FLOP
  of each sampled row, at one bucket's degree bounds.  Replaces
  ``src/repro/kernels/spgemm_symbolic.py::fused_flop_symbolic_pallas``
  (``_fused_kernel``);
* :func:`fused_flop_symbolic_buckets`: the same outputs for the sampled
  rows of every ESC bucket of a binned prediction in one launch, each row
  at its own bucket's bounds (a :class:`SampleTable`) — what the TPU kernel
  gives bucket by bucket;
* :func:`exact_row_counts_esc`: the same launch over every row of an ESC
  bucket in its per-row count mode → each row's distinct columns, the
  re-planning loop's exact-symbolic fallback (the JAX package counts them
  outside Pallas, ``repro.core.predictor.exact_row_counts``);
* :func:`sampled_symbolic` → ``(z*, f*)`` with f* the count of *gathered*
  products (each B row read to at most ``max_deg_b`` entries), at the
  global degree bounds of the paper's predictor: one launch over the
  sampled rows as given, each taking a warp or a block by its own FLOP on
  the card.  Replaces ``sampled_symbolic_pallas`` (``_kernel``).

On the H100 the kernel is bound by bytes: a row's product columns (4 bytes
each from B, plus A's row and B's row lengths) are gathered and counted on
chip.  It gives a short row one warp and a long one a block, by a bound on
each row's products (its FLOP, or ``DA·DB`` without one); a long row
counts by bitmask when its column extent fits shared memory, and a row
that neither fits as a bitmask nor as keys in the card's 227 KB of shared
memory counts in its block's global scratch slice: by bitmask when its
extent fits the slice, else by a sort.  A row whose products pass
the bound it was given (a FLOP below them) still counts right, by presence
bits in a global spill bitmask.  z* and f* are exact integers, added per
row with integer atomics.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.csr import CSRDevice
from repro_torch.core.predictor import (count_distinct_sorted,
                                        distinct_per_row, sampled_counts)
from . import _build
from .flop_per_row import flop_rows_plain

_LIB = "esc_symbolic"


def fused_flop_symbolic_plain(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                              *, max_deg_a: int, max_deg_b: int,
                              rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: gather, sort and count (z*), and Algorithm 1
    over the same rows (FLOP per row and f* = its sum)."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    z, _ = sampled_counts(a, b, rows, max_deg_a, max_deg_b, rownnz_b)
    flop = flop_rows_plain(a, rownnz_b, rows, max_deg_a=max_deg_a)
    return z, flop.sum(dtype=torch.int32), flop


def _fused_launch(a: CSRDevice, b: CSRDevice, rownnz_b: torch.Tensor, dev,
                  rows: torch.Tensor, n_long: int, max_deg_a: int,
                  max_deg_b: int, short_bound: int, long_bound: int,
                  max_deg_a_long: int, gathered: bool = False,
                  row_flop: torch.Tensor | None = None,
                  z_out: torch.Tensor | None = None):
    """One launch of ``csrc/esc_symbolic.cu`` over ``rows`` (its first
    ``n_long`` the long rows): an int32 ``(S,)`` tensor of row ids, every
    row at ``max_deg_a``/``max_deg_b`` and in place, or a
    :class:`SampleTable`'s ``(4, S)`` samples (each row's own bounds and
    place).  With ``row_flop`` (int32 ``(S,)``, beside an ``(S,)`` tensor
    of rows) ``n_long`` is ``S`` or 0 and each row is long or short by
    ``min(row_flop, max_deg_a·max_deg_b)`` on the card.  Returns ``(z*,
    f*, FLOP per row in the caller's order)``, int32 views of one buffer
    that the kernel fills, f* the rows' FLOP or, with ``gathered``, their
    gathered products; the buffer also holds the spill lock and bitmask
    (one word per 32 of B's columns) of rows past their bound.  With
    ``z_out`` (int32 ``(S,)``) the kernel also writes each row's distinct
    columns there, in the caller's order (the per-row count mode)."""
    s = rows.shape[-1]
    spill_words = max(1, -(-b.ncols // 32))
    res = torch.empty(3 + spill_words + s, dtype=torch.int32, device=dev)
    if rownnz_b.shape[0] != b.nrows:
        raise RuntimeError(f"{_LIB}: rownnz_b has {rownnz_b.shape[0]} "
                           f"entries for {b.nrows} rows of B")
    i32 = torch.int32
    shape = _build.symbolic_shape(_build.max_smem(_LIB, dev), short_bound,
                                  long_bound, max_deg_a_long, n_long,
                                  b.ncols)
    scratch = (torch.empty(shape.long_blocks * shape.slice_bytes,
                           dtype=torch.uint8, device=dev)
               if shape.slice_bytes else None)
    if rows.dim() == 2:
        if rows.shape[0] != 4 or rows.dtype != i32 or not rows.is_contiguous():
            raise RuntimeError(f"{_LIB}: samples must be a contiguous "
                               f"(4, S) int32 tensor")
        base = rows.data_ptr()
        ptrs = [base + 4 * s * k for k in range(4)]
    else:
        ptrs = [_build.require(_LIB, rows, i32, "rows"), None, None, None]
    flop_ptr = (None if row_flop is None else
                _build.require(_LIB, row_flop, i32, "row_flop"))
    fn = _build.launcher(_LIB, "pppppiiiiiipppppiiiipqipiippip")
    rc = fn(*ptrs, flop_ptr, s, n_long,
            shape.long_blocks, int(max_deg_a), int(max_deg_b),
            int(max_deg_a_long), *_build.require_csr(_LIB, a, "a"),
            *_build.require_csr(_LIB, b, "b"),
            _build.require(_LIB, rownnz_b, i32, "rownnz_b"), a.nrows,
            rownnz_b.shape[0], shape.warp_keys, shape.smem_keys,
            scratch.data_ptr() if scratch is not None else None,
            shape.slice_bytes, shape.smem_bytes, res.data_ptr(),
            spill_words, int(gathered),
            res.data_ptr() + 4 * (3 + spill_words),
            None if z_out is None else _build.require(_LIB, z_out, i32,
                                                      "z_out"),
            dev.index or 0, _build.stream_of(dev))
    _build.check(_LIB, rc)
    return res[0], res[1], res[3 + spill_words:]


def _empty_counts(dev):
    zero = torch.zeros(2, dtype=torch.int32, device=dev)
    return zero[0], zero[1], zero[2:]


def fused_flop_symbolic(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                        max_deg_a: int, max_deg_b: int,
                        rownnz_b: torch.Tensor | None = None):
    """(z* int32, f* int32, FLOP per sampled row int32 (S,)) for ``rows`` at
    the bucket's degree bounds; the bound on a row's products is
    ``max_deg_a·max_deg_b``."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_LIB, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               rows)
    if dev is None:
        return fused_flop_symbolic_plain(a, b, rows, max_deg_a=max_deg_a,
                                         max_deg_b=max_deg_b,
                                         rownnz_b=rownnz_b)
    s = rows.shape[0]
    if not s:
        return _empty_counts(dev)
    bound = int(max_deg_a) * int(max_deg_b)
    long = bound > _build.SYM_WARP_MAX
    out = _fused_launch(a, b, rownnz_b, dev, rows, s if long else 0,
                        max_deg_a, max_deg_b, 0 if long else bound, bound,
                        max_deg_a)
    fused_flop_symbolic.launches += 1
    return out


fused_flop_symbolic.launches = 0


class SampleTable(NamedTuple):
    """The sampled rows of one :func:`fused_flop_symbolic_buckets` launch,
    on one device (built by :func:`sample_table`), long rows first, and the
    host-side bounds that size the launch."""

    samples: torch.Tensor   # int32 (4, S): each sample's row of A, its
    #                         bucket's bounds deg_a and deg_b, and its
    #                         place in the caller's order
    n_long: int             # the first n_long rows take a block each
    short_bound: int        # most products of a short row (0: none)
    long_bound: int         # most products of a long row (0: none)
    max_deg_a_long: int     # largest deg_a among the long rows


def sample_table(rows, deg_a, deg_b, row_flop, device) -> SampleTable:
    """:class:`SampleTable` of the sampled ``rows`` (host int arrays, one
    entry a sample, duplicates kept) at their buckets' bounds ``deg_a`` and
    ``deg_b``, with ``row_flop`` each row's FLOP at ``deg_a`` or a bound on
    it (Algorithm 1's floprC does): a row's products are at most
    ``min(row_flop, deg_a·deg_b)``, which sizes its workspace (a row past
    it counts in the kernel's spill bitmask, slower but exact).  Rows past
    :data:`_build.SYM_WARP_MAX` products go first, each to a block; the
    rest to a warp each.  One upload to ``device``."""
    rows = np.asarray(rows, dtype=np.int32)
    deg_a = np.asarray(deg_a, dtype=np.int32)
    deg_b = np.asarray(deg_b, dtype=np.int32)
    bound = np.minimum(np.asarray(row_flop, dtype=np.int64),
                       deg_a.astype(np.int64) * deg_b)
    long = bound > _build.SYM_WARP_MAX
    order = np.argsort(~long, kind="stable")
    packed = np.stack([rows, deg_a, deg_b, np.arange(rows.size,
                                                     dtype=np.int32)])
    samples = torch.from_numpy(np.ascontiguousarray(packed[:, order]))
    peak = lambda x: int(x.max()) if x.size else 0
    return SampleTable(samples.to(device), n_long=int(long.sum()),
                       short_bound=peak(bound[~long]),
                       long_bound=peak(bound[long]),
                       max_deg_a_long=peak(deg_a[long]))


def fused_flop_symbolic_buckets_plain(a: CSRDevice, b: CSRDevice,
                                      table: SampleTable, *,
                                      rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: :func:`fused_flop_symbolic_plain` over the
    rows of each ``(deg_a, deg_b)`` pair, the FLOP put back in the caller's
    order."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    rows, deg_a, deg_b, out = table.samples
    flop = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    z = torch.zeros((), dtype=torch.int32, device=rows.device)
    for da, db in sorted(set(map(tuple, table.samples[1:3].T.tolist()))):
        sel = torch.nonzero((deg_a == da) & (deg_b == db))[:, 0]
        zb, _, fl = fused_flop_symbolic_plain(
            a, b, rows[sel], max_deg_a=da, max_deg_b=db, rownnz_b=rownnz_b)
        z = z + zb
        flop[out[sel].long()] = fl
    return z, flop.sum(dtype=torch.int32), flop


def fused_flop_symbolic_buckets(a: CSRDevice, b: CSRDevice,
                                table: SampleTable, *,
                                rownnz_b: torch.Tensor | None = None):
    """(z* int32, f* int32, FLOP per sample int32 (S,), in the caller's
    order) for the table's rows, each at its own bucket's bounds, in one
    launch."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_LIB, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               table.samples)
    if dev is None:
        return fused_flop_symbolic_buckets_plain(a, b, table,
                                                 rownnz_b=rownnz_b)
    if not table.samples.shape[1]:
        return _empty_counts(dev)
    out = _fused_launch(a, b, rownnz_b, dev, table.samples, table.n_long, 0,
                        0, table.short_bound, table.long_bound,
                        table.max_deg_a_long)
    fused_flop_symbolic_buckets.launches += 1
    return out


fused_flop_symbolic_buckets.launches = 0


def exact_row_counts_esc_plain(a: CSRDevice, b: CSRDevice,
                               table: SampleTable, *,
                               rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: gather, sort and count each row over the
    rows of each ``(deg_a, deg_b)`` pair (``predictor.distinct_per_row``),
    the counts put back in the caller's order."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    rows, deg_a, deg_b, out = table.samples
    z = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    for da, db in sorted(set(map(tuple, table.samples[1:3].T.tolist()))):
        sel = torch.nonzero((deg_a == da) & (deg_b == db))[:, 0]
        z[out[sel].long()] = distinct_per_row(
            a, b, rows[sel], da, db, rownnz_b, count_distinct_sorted)
    return z


def exact_row_counts_esc(a: CSRDevice, b: CSRDevice, table: SampleTable, *,
                         rownnz_b: torch.Tensor | None = None):
    """Each listed row's distinct product columns, int32 ``(S,)`` in the
    caller's order, at its own bounds: kernel 2's launch of
    :func:`fused_flop_symbolic_buckets` in its per-row count mode, over
    every row of an ESC bucket (the re-planning loop's exact-symbolic
    fallback, ``predictor.exact_row_counts``) instead of a sample."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_LIB, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               table.samples)
    if dev is None:
        return exact_row_counts_esc_plain(a, b, table, rownnz_b=rownnz_b)
    s = table.samples.shape[1]
    z = torch.empty(s, dtype=torch.int32, device=dev)
    if not s:
        return z
    _fused_launch(a, b, rownnz_b, dev, table.samples, table.n_long, 0, 0,
                  table.short_bound, table.long_bound, table.max_deg_a_long,
                  z_out=z)
    exact_row_counts_esc.launches += 1
    return z


exact_row_counts_esc.launches = 0


def sampled_symbolic_plain(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                           *, max_deg_a: int, max_deg_b: int,
                           rownnz_b: torch.Tensor | None = None):
    """Plain tensor-op version: gather, sort and count (z*), and count the
    gathered products (f*)."""
    return sampled_counts(a, b, rows, max_deg_a, max_deg_b, rownnz_b)


def sampled_symbolic(a: CSRDevice, b: CSRDevice, rows: torch.Tensor, *,
                     max_deg_a: int, max_deg_b: int,
                     rownnz_b: torch.Tensor | None = None,
                     row_flop: torch.Tensor | None = None):
    """(z* int32, f* int32) for ``rows`` at the given degree bounds, f* the
    gathered products, in one launch of the fused kernel with nothing read
    back.

    ``row_flop`` (int32 (S,), optional) bounds each sampled row's gathered
    products — Algorithm 1's FLOP of the rows at ``max_deg_a`` does — so
    each row takes a warp or a block by its own products, decided on the
    card; without it every row is bounded by ``max_deg_a·max_deg_b``.  A
    long row counts by presence bits over its column extent, in shared
    memory sized for B's columns or, where they do not fit there, in its
    block's scratch slice, so that the blocks still count side by side;
    only a short row past its hint counts in the kernel's global spill
    bitmask."""
    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    dev = _build.kernel_device(_LIB, a.rpt, a.col, b.rpt, b.col, rownnz_b,
                               rows)
    if dev is None:
        return sampled_symbolic_plain(a, b, rows, max_deg_a=max_deg_a,
                                      max_deg_b=max_deg_b, rownnz_b=rownnz_b)
    s = rows.shape[0]
    if not s:
        return _empty_counts(dev)[:2]
    if row_flop is not None and row_flop.shape != rows.shape:
        raise RuntimeError(f"{_LIB}: row_flop has shape "
                           f"{tuple(row_flop.shape)} for {s} rows")
    bound = int(max_deg_a) * int(max_deg_b)
    short = min(bound, _build.SYM_WARP_MAX)
    # a long row's workspace is a bitmask of B's columns beside its table,
    # in shared memory or else in its block's scratch slice: every long
    # row's column extent fits it, so none sorts or spills
    out = _fused_launch(a, b, rownnz_b, dev, rows,
                        s if bound > short else 0, max_deg_a, max_deg_b,
                        short, -(-b.ncols // 32), max_deg_a, gathered=True,
                        row_flop=row_flop)
    sampled_symbolic.launches += 1
    return out[0], out[1]


sampled_symbolic.launches = 0
