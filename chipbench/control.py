"""The control: the reference, computed a precision lower, in the program's
place.  Its readings are the upper ends that the limits in ``limits.json``
are set below.

    python3 -m chipbench.control --workload <name> --seeds 1,2,3

For each seed it builds the inputs of the window's first call as a run
does, at the cell's own size, and compares, by the run's own comparison:
the reference's product with its products and sums in bfloat16 (the
configuration states float32; nothing here multiplies matrices, so TF32
does not apply), and where the traffic plans, eq. 4 in bfloat16.  The
benchmark's own runs never run it."""
from __future__ import annotations

import argparse
import json
import sys

import torch

from chipbench import check, loops
from chipbench.cell import Cell
from chipbench.reference import predict as ref_predict
from chipbench.reference import spgemm as ref


def readings(cfg: dict, mix: dict, seed: int, device,
             dtype=torch.bfloat16) -> dict:
    """The control's numbers for call 0 of run ``seed``."""
    kind = loops.load(mix)
    cell = Cell(cfg, mix, seed, device)
    member, labels = kind.inputs(cell, 0)
    a, pat = cell.operand(0, member, labels)
    r = check.Readings()
    check.compare(check.control_blocks(a, a, dtype), a, a, r)
    out = dict(row_count_diff=r.row_count_diff, col_diff=r.col_diff,
               val_err=r.val_err)
    if kind.PLANS:
        rows = cell.sample_rows(member, pat)
        rowprod = ref.row_products(a, a)
        z = int(ref.exact_row_counts(ref.take_rows(a, rows), a).sum())
        f = int(rowprod[torch.as_tensor(rows, device=a.rpt.device)].sum())
        low, _ = ref_predict.eq4(rowprod, z, f, dtype)
        want, _ = ref_predict.eq4(rowprod, z, f)
        check.prediction_gap(low.double().cpu().numpy(),
                             want.cpu().numpy(), r)
        out["pred_gap"] = r.pred_gap
    return out


def main(argv=None) -> int:
    from chipbench import run as runmod
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = json.loads((runmod.ROOT / "BENCHMARK.json").read_text())
    _, cfg, mix = runmod.load_cell(bench, args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(dict(workload=args.workload, seed=int(s),
                              **readings(cfg, mix, int(s), args.device))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
