"""Quickstart: the paper in 40 lines, on the CUDA card.

Predict the output structure of C = A·B with the sampled compression ratio
(eq. 4), compare against the reference design (eq. 2) and the exact symbolic
phase, then run the numeric SpGEMM into buffers sized by the prediction —
Algorithm 1, the sampled symbolic pass and the numeric phase each through
their CUDA kernel (their plain versions with ``--device cpu``).

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import csr, oracle, predictor, spgemm
from repro_torch.sparse import random as sprand


def run(n: int = 4000, *, device=None, rows=None, out=print) -> dict:
    """The quickstart flow on an ``n``×``n`` banded matrix (bandwidth 40,
    30 entries a row, generator seed 0).  ``rows`` (host ids) replaces the
    drawn sample when given.  Returns what it computed; raises if the
    allocation did not hold the exact result."""
    dev = csr.resolve_device(device)
    # A banded FEM-like matrix: compression ratio ≈ 8 (products collide
    # heavily), exactly the regime where the upper-bound method
    # over-allocates 8×.
    A = sprand.banded(n, n, 40, 30, seed=0)
    Ad = csr.to_device(A, device=dev)
    mda = int(A.row_nnz.max())

    # --- exact (the expensive symbolic phase the paper avoids) ---
    nnzr, Z = oracle.exact_structure(A, A)
    flopr, F = oracle.flop_per_row(A, A)
    out(f"matrix: {A.nrows}x{A.ncols}, nnz={A.nnz:,}")
    out(f"exact:   FLOP={F:,}  NNZ(C)={Z:,}  CR={F/Z:.2f}")

    # --- the paper's method: sample 0.3% of rows, predict CR from f*/z* ---
    if rows is None:
        s = predictor.static_sample_num(A.nrows)      # min(0.003·M, 300)
        gen = torch.Generator(device=dev).manual_seed(0)
        rows_d = predictor.draw_sample_rows(gen, A.nrows, s)
    else:
        rows_d = torch.from_numpy(np.asarray(rows, dtype=np.int32)).to(dev)
        s = rows_d.shape[0]
    pred = predictor.proposed_predict(Ad, Ad, rows_d, mda, mda,
                                      use_kernel=True)
    e2 = (float(pred.nnz_total) - Z) / Z
    out(f"proposed (eq.4):  Z2*={float(pred.nnz_total):,.0f}  "
        f"CR*={float(pred.compression_ratio):.2f}  error={e2*100:+.2f}%  "
        f"({s} sampled rows)")

    # --- reference design (eq. 2) on the same samples, for contrast ---
    ref = predictor.reference_predict(Ad, Ad, rows_d, mda, mda,
                                      use_kernel=True)
    e1 = (float(ref.nnz_total) - Z) / Z
    out(f"reference (eq.2): Z1*={float(ref.nnz_total):,.0f}  "
        f"error={e1*100:+.2f}%")

    # --- allocate from the prediction and run the numeric phase ---
    plan = predictor.AllocationPlan.from_prediction(
        pred.structure.cpu().numpy(), flopr, safety=1.5)
    out(f"allocation: {plan.row_capacity} slots/row "
        f"(upper-bound method would use {int(flopr.max())})")
    res = spgemm.spgemm(Ad, Ad, row_capacity=plan.row_capacity,
                        max_deg_a=mda, max_deg_b=mda, use_kernel=True)
    nnz, overflow = int(res.row_nnz.sum()), int(res.overflow)
    out(f"numeric phase: nnz={nnz:,} (exact {Z:,}), overflow={overflow}")
    if overflow != 0 or nnz != Z:
        raise RuntimeError("the predicted allocation did not hold the exact "
                           "result")
    out("OK — predicted allocation held the exact result.")
    return dict(rows=rows_d.cpu().numpy(), pred=pred, ref=ref, plan=plan,
                out=res, exact_nnz=Z, exact_row_nnz=nnzr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    run(device=ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
