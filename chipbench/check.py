"""What decides ``correct``: the program's results against the reference.

Numbers compared, each against its limit in ``limits.json``:

- ``overflow_calls``: calls of the window whose overflow count was not 0.
- ``row_count_diff``: rows of the checked products whose number of entries
  differs from the reference's (a truncated or padded row).
- ``col_diff``: entries, in rows of the right length, whose column differs.
- ``val_err``: the largest ``|c − c_ref| / Σ|a_ik·b_kj|`` over the checked
  entries: the error of a sum measured against the magnitude of its terms,
  which float32 summation in any order keeps near its rounding unit.
- ``pred_gap`` (where the window plans): the largest gap between the plan's
  predicted row sizes and eq. 4 recomputed from the reference's exact
  counts of the same sampled rows, relative to the row's size (at least 1).
- ``failed``: calls that raised, or whose kept output never came back.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from chipbench.reference import spgemm as ref

LIMITS = Path(__file__).resolve().parent / "limits.json"


@dataclasses.dataclass
class Readings:
    overflow_calls: int = 0
    row_count_diff: int = 0
    col_diff: int = 0
    val_err: float = 0.0
    pred_gap: float | None = None
    checked: int = 0


def port_blocks(csr, device):
    """Row blocks of a host CSR (the program's result), on ``device``:
    ``(r0, r1) -> (counts, col, val)``."""
    rpt = np.asarray(csr.rpt, dtype=np.int64)

    def block(r0, r1):
        lo, hi = int(rpt[r0]), int(rpt[r1])
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return (t(np.diff(rpt[r0:r1 + 1])), t(csr.col[lo:hi]).to(torch.int64),
                t(csr.val[lo:hi]))
    return block


def control_blocks(a: ref.Matrix, b: ref.Matrix, dtype=torch.bfloat16):
    """Row blocks of the control: the reference itself, its products and
    sums in ``dtype``, put where the program's result would be."""
    def block(r0, r1):
        blk = ref.product_block(a, b, r0, r1, dtype)
        return blk.counts, blk.col, blk.val
    return block


def compare(candidate, a: ref.Matrix, b: ref.Matrix, r: Readings,
            budget: int = ref.BUDGET) -> int:
    """Compare ``candidate``'s row blocks with the reference's; add to
    ``r``.  Returns nnz of the reference's ``A·B``."""
    total = 0
    for blk in ref.blocks(a, b, budget):
        counts, col, val = candidate(blk.r0, blk.r1)
        total += int(blk.counts.sum())
        same = counts == blk.counts
        r.row_count_diff += int((~same).sum())
        if not bool(same.all()):
            # keep only the entries of rows of the right length, which line
            # up one to one
            row_ref = torch.repeat_interleave(same, blk.counts)
            row_got = torch.repeat_interleave(same, counts)
            col, val = col[row_got], val[row_got]
            ref_col, ref_val, mag = (blk.col[row_ref], blk.val[row_ref],
                                     blk.mag[row_ref])
        else:
            ref_col, ref_val, mag = blk.col, blk.val, blk.mag
        if not ref_col.numel():
            continue
        r.col_diff += int((col != ref_col).sum())
        err = (val.double() - ref_val.double()).abs() / mag.clamp_min(1e-300)
        r.val_err = max(r.val_err, float(err.max()))
    return total


def prediction_gap(got: np.ndarray, want: np.ndarray, r: Readings) -> None:
    """Add one plan's predicted row sizes against eq. 4's to ``r``."""
    got = np.asarray(got, np.float64)
    rel = np.abs(got - want) / np.maximum(want, 1.0)
    gap = (float(rel.max()) if np.isfinite(rel).all() else float("inf")
           ) if want.size else 0.0
    r.pred_gap = gap if r.pred_gap is None else max(r.pred_gap, gap)


def limits() -> dict:
    return json.loads(LIMITS.read_text())


def numbers(r: Readings, failed: int) -> tuple[dict, bool]:
    """Every number compared, beside its limit, and whether all hold."""
    lim = limits()
    vals = dict(failed=failed, overflow_calls=r.overflow_calls,
                row_count_diff=r.row_count_diff, col_diff=r.col_diff,
                val_err=r.val_err)
    if r.pred_gap is not None:
        vals["pred_gap"] = r.pred_gap
    out = {k: dict(value=v, limit=lim[k]) for k, v in vals.items()}
    ok = r.checked > 0 and all(v["value"] <= v["limit"] for v in out.values())
    return out, ok
