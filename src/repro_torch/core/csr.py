"""Device-side (torch) CSR with capacity-padded index arrays.

The device CSR is *capacity-padded* like the JAX package's: ``col`` / ``val``
have length ``cap >= nnz``; entries past ``nnz`` are padding (column
:data:`COL_SENTINEL`, value 0).  A plan pads every operand to a pow2
capacity, so one executor serves every matrix that fits it.

Entry points run on the CUDA card unless the caller asks for the CPU:
:func:`resolve_device` raises when no card is present and no device was
named, and never moves work to the host on its own.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.formats import CSR

# Sentinel for padded column slots: larger than any real column index so that
# sorted buffers push padding to the tail and adjacent-unique never counts it.
COL_SENTINEL = int(np.iinfo(np.int32).max)

# Lanes (row × product slots) one chunk of a plain, tensor-op pass expands at
# once: bounds the plain versions' temporaries on the card and the host.
PLAIN_CHUNK_LANES = 1 << 22


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one named, else the CUDA card.

    With no device named and no CUDA card present this raises — the port
    never falls back to the host on its own; pass ``device="cpu"`` to run
    the plain versions there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain versions on the host")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class CSRDevice:
    """Padded CSR on a torch device."""

    rpt: torch.Tensor  # int32 (M+1,)
    col: torch.Tensor  # int32 (cap,), padded with COL_SENTINEL
    val: torch.Tensor  # float32 (cap,), padded with 0
    shape: tuple[int, int]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.rpt.device

    @property
    def nnz(self) -> torch.Tensor:
        return self.rpt[-1]

    @property
    def row_nnz(self) -> torch.Tensor:
        return torch.diff(self.rpt)


def row_chunks(n_rows: int, width: int, lanes: int = PLAIN_CHUNK_LANES):
    """``(lo, hi)`` row ranges of at most ``lanes // width`` rows each."""
    step = max(1, lanes // max(1, int(width)))
    for lo in range(0, n_rows, step):
        yield lo, min(n_rows, lo + step)


def expand_products(a: CSRDevice, b: CSRDevice, rows: torch.Tensor,
                    max_deg_a: int, max_deg_b: int, *,
                    rownnz_b: torch.Tensor | None = None,
                    with_values: bool = False):
    """Expand the intermediate-product columns of ``rows`` of ``C = A·B`` into
    an ``(S, max_deg_a·max_deg_b)`` buffer — the shared gather of the plain
    versions of both phases.

    Returns ``(cols, vals, valid)``:

      * ``cols``  — int32, padded with :data:`COL_SENTINEL`;
      * ``vals``  — float32 value products (``a_ik·b_kj``), 0 on padding —
        ``None`` unless ``with_values``;
      * ``valid`` — bool mask of real (non-padding) product slots.

    Only the first ``max_deg_a`` entries of an A row and the first
    ``max_deg_b`` of a B row are read, as in the JAX package.
    """
    s = rows.shape[0]
    dev = a.rpt.device
    rows = rows.long()
    start_a = a.rpt[rows].long()
    deg_a = a.rpt[rows + 1].long() - start_a                              # (S,)
    ia = torch.arange(max_deg_a, device=dev)
    idx_a = (start_a[:, None] + ia[None, :]).clamp(0, a.capacity - 1)
    valid_a = ia[None, :] < deg_a[:, None]
    ks = torch.where(valid_a, a.col[idx_a], 0).long()                     # (S, DA)

    if rownnz_b is None:
        rownnz_b = torch.diff(b.rpt)
    deg_b = torch.where(valid_a, rownnz_b[ks], 0)
    ib = torch.arange(max_deg_b, device=dev)
    idx_b = (b.rpt[ks].long()[:, :, None] + ib).clamp(0, b.capacity - 1)
    valid = valid_a[:, :, None] & (ib < deg_b[:, :, None])
    cols = torch.where(valid, b.col[idx_b], COL_SENTINEL)
    f = max_deg_a * max_deg_b
    vals = None
    if with_values:
        av = torch.where(valid_a, a.val[idx_a], 0.0)
        vals = torch.where(valid, av[:, :, None] * b.val[idx_b],
                           0.0).reshape(s, f)
    return cols.reshape(s, f), vals, valid.reshape(s, f)


def pad_row_ids(rows: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad a row-id list to a multiple of ``multiple`` by repeating the LAST
    listed row (padded outputs are sliced off by the caller).

    Repeating the last row — not row 0 — matters under degree binning: the
    list is then a bucket, and row 0 of the matrix may exceed the bucket's
    degree envelope while a repeated member row cannot.
    """
    r = rows.shape[0]
    pad_r = (-(-r // multiple)) * multiple
    rows = rows.to(torch.int32)
    if pad_r == r:
        return rows
    return torch.cat([rows, rows[-1:].expand(pad_r - r)])


def to_device(host: CSR, capacity: int | None = None,
              device=None) -> CSRDevice:
    """Upload a host CSR at ``capacity`` slots (default: its nnz)."""
    dev = resolve_device(device)
    cap = int(capacity if capacity is not None else host.nnz)
    if cap < host.nnz:
        from .errors import PlanMismatchError
        raise PlanMismatchError(
            f"device capacity {cap} is smaller than the operand's nnz "
            f"{host.nnz}", observed=int(host.nnz), planned=cap)
    col = np.full(cap, COL_SENTINEL, dtype=np.int32)
    val = np.zeros(cap, dtype=np.float32)
    col[: host.nnz] = host.col
    val[: host.nnz] = host.val
    return CSRDevice(
        rpt=torch.from_numpy(np.asarray(host.rpt, dtype=np.int32)).to(dev),
        col=torch.from_numpy(col).to(dev),
        val=torch.from_numpy(val).to(dev),
        shape=tuple(host.shape),
    )


def to_host(dev: CSRDevice) -> CSR:
    rpt = dev.rpt.cpu().numpy().astype(np.int64)
    nnz = int(rpt[-1])
    return CSR(rpt=rpt, col=dev.col[:nnz].cpu().numpy().astype(np.int32),
               val=dev.val[:nnz].cpu().numpy().astype(np.float32),
               shape=dev.shape)
