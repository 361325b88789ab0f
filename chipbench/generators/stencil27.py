"""The 27-point Laplacian's pattern on an ``n³`` grid in natural order.

hypre's ``ij`` test driver builds this operator for ``-27pt -n n n n``
(HPCG's operator is the same stencil): one row per grid point ``x + n·y +
n²·z``, a column for each of the up to 27 points at offsets in
``{-1, 0, 1}³`` that lie inside the grid.  Made on the device in one pass
over the offsets, so columns ascend within a row.  The labels are the
grid's own (no permutation): the natural order is part of the deployment.
"""
from __future__ import annotations

import torch

from chipbench.generators import Pattern

KEYS = ("n",)


def make(cfg: dict, seed: int, device, member: int = 0,
         labels_index: int | None = None) -> Pattern:
    """The stencil on ``cfg["n"]``³ points.  It does not depend on
    ``seed``, ``member`` or ``labels_index``: one member, natural labels."""
    n = int(cfg["n"])
    m = n ** 3
    r = torch.arange(m, dtype=torch.int64, device=device)
    x, y, z = r % n, (r // n) % n, r // (n * n)
    cols = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((x + dx >= 0) & (x + dx < n) & (y + dy >= 0)
                      & (y + dy < n) & (z + dz >= 0) & (z + dz < n))
                cols.append(torch.where(ok, r + dx + n * dy + n * n * dz, -1))
    grid = torch.stack(cols, dim=1)
    del cols
    keep = grid >= 0
    rpt = torch.zeros(m + 1, dtype=torch.int64, device=device)
    rpt[1:] = torch.cumsum(keep.sum(dim=1), 0)
    return Pattern(rpt, grid[keep].to(torch.int32), None)


def closed_forms(n: int) -> dict:
    """nnz(A), the products of A·A and nnz(A·A) of the stencil on ``n``³
    points: per axis a point has 3 neighbours (2 at a face), so the counts
    are cubes of the one-axis counts."""
    return dict(nnz_a=(3 * n - 2) ** 3, products=(9 * n - 10) ** 3,
                nnz_c=(5 * n - 6) ** 3)
