"""Algorithm 1 on device: FLOP per output row (the upper-bound method), in torch.

floprC[i] = sum_{j in [A.rpt[i], A.rpt[i+1])} ( B.rpt[A.col[j]+1] - B.rpt[A.col[j]] )

One gather of B's row lengths per nonzero of A, then row sums read off a
prefix sum at A's row pointers.  This is also the oracle for the port's
per-bucket FLOP kernel (``kernels.flop_per_row``).
"""
from __future__ import annotations

import torch

from .csr import CSRDevice


def flop_per_row(a: CSRDevice, b: CSRDevice) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (floprC int32 (M,), total_flop int32 scalar).

    Counts are int32 as in the JAX package: exact below 2^31 products."""
    assert a.ncols == b.nrows, (a.shape, b.shape)
    rownnz_b = torch.diff(b.rpt)                                    # (K,)
    pos = torch.arange(a.capacity, device=a.rpt.device)
    valid = pos < a.nnz
    safe_col = torch.where(valid, a.col, 0).long()
    contrib = torch.where(valid, rownnz_b[safe_col], 0).long()
    cs = torch.cat([contrib.new_zeros(1), torch.cumsum(contrib, 0)])
    floprc = (cs[a.rpt[1:].long()] - cs[a.rpt[:-1].long()]).to(torch.int32)
    return floprc, floprc.sum(dtype=torch.int32)
