"""Frozen copies of the paper's sampling rule and of its eq. 4.

They mirror the sampled-compression-ratio predictor of the paper
("Predicting the Output Structure of Sparse Matrix Multiplication with
Sampled Compression Ratio"), Algorithm 2, as the system under test
implements it.  The benchmark draws the sample itself with
:func:`sample_rows` and hands the same rows to the program and to
:func:`eq4`."""
from __future__ import annotations

import numpy as np
import torch

SAMPLE_FRACTION = 0.003
SAMPLE_CAP = 300


def sample_num(m: int) -> int:
    """Algorithm 2, line 1: 0.3% of the rows, at least 1, at most 300."""
    return max(1, min(int(SAMPLE_FRACTION * m), SAMPLE_CAP))


def sample_rows(m: int, seed: int) -> np.ndarray:
    """Algorithm 2, lines 2-3: ``rid = ⌊M · rand⌋``, drawn with
    replacement (int64 row ids in ``[0, M)``)."""
    rand = np.random.default_rng(seed).random(sample_num(m))
    return (m * rand).astype(np.int64).clip(0, m - 1)


def eq4(flopr: torch.Tensor, z_star: int, f_star: int,
        dtype=torch.float64) -> tuple[torch.Tensor, float]:
    """Eq. 4: ``r* = f*/z*``, ``nnzr*(C) = floprC / r*`` and ``Z* = F/r*``.

    ``f*`` and ``z*`` are the sampled rows' products and distinct outputs
    (a row drawn twice counts twice), ``flopr`` each row's products.
    Returns the predicted row sizes (in ``dtype``) and total, computed in
    ``dtype``'s arithmetic: float64 for the reference, a lower precision
    for the control.  Where the sample has no products (``f* = 0``) the
    program plans every row at its products, the safe upper bound, and so
    does this copy."""
    if int(f_star) == 0:
        return flopr.to(dtype), float(flopr.sum())
    r = (torch.tensor(float(f_star), dtype=dtype)
         / torch.tensor(float(max(int(z_star), 1)), dtype=dtype))
    structure = flopr.to(dtype) / r.to(flopr.device)
    return structure, float(flopr.sum().double().cpu() / r.double())
