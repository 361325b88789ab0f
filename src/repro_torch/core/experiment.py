"""The paper's Section VI accuracy experiment: 625 test cases, with the
sampled counts taken on the device.

For every (A, B) pair of the 25-matrix suite (dimension-matched with the
paper's reshape rule) we compute, on the SAME sampled rows (the proposed
method 'utilizes the same information computed by the reference design'):

  e1 = (Z1* - Z)/Z   reference design        (eq. 2)
  ef = (F* - F)/F    symmetric FLOP predictor (eq. 3)
  e2 = (Z2* - Z)/Z   proposed sampled-CR      (eq. 4)
  e3 = (Z3* - Z)/Z   k-min-hash baseline      (Section III)

and verify the identity  e2 == (e1 - ef)/(1 + ef)  (eq. 5) per case.

The sampled counts z* and f* come from the global-pad symbolic kernel
(``kernels.ops.sampled_symbolic``) and F from the all-rows FLOP kernel
(``kernels.ops.flop_per_row``), both at the pair's global degree bounds,
where they are exact, on the named device (the CUDA card by default; on a
CPU device their plain versions run).  The exact Z and the k-min-hash stay
on the host, as in the JAX package, whose seeds, case order and float64
arithmetic this module keeps: on equal integers every field of a case is
equal.

Paper's results to compare against: mean |e1| = 8.12%, mean |e2| = 1.56%,
worst |e1| = 158%, worst |e2| = 25%, proposed better on 81.4% of cases,
corr(e1, ef) = 97.01%.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.sparse import suite as suite_mod
from repro_torch.sparse.formats import CSR, match_dims
from . import csr, oracle

SUBSET_PER_FAMILY_PAIR = 3      # 5 families × 5 families × 3 = 75 cases


def sampled_counts(a: CSR, b: CSR, rows: np.ndarray,
                   device=None) -> tuple[int, int, int]:
    """(z*, f*, F) of A·B on ``rows`` through the kernels, at the global
    degree bounds (no truncation: f* is the sampled rows' FLOP)."""
    dev = csr.resolve_device(device)
    from repro_torch.kernels import ops as kops
    ad, bd = csr.to_device(a, device=dev), csr.to_device(b, device=dev)
    da = max(1, int(a.row_nnz.max(initial=0)))
    db = max(1, int(b.row_nnz.max(initial=0)))
    rows_d = torch.from_numpy(np.asarray(rows, dtype=np.int32)).to(dev)
    floprc = kops.flop_per_row(ad, bd, max_deg_a=da)
    z, f = kops.sampled_symbolic(ad, bd, rows_d, da, db,
                                 row_flop=floprc[rows_d.long()])
    return int(z), int(f), int(floprc.sum(dtype=torch.int64))


def run_case(a: CSR, b: CSR, seed: int, k_minhash: int = 64, *,
             device=None) -> dict:
    """One test case: the JAX package's fields, from the device's counts."""
    _, z_exact = oracle.exact_structure(a, b)
    rows = oracle.sample_rows(a.nrows, seed)
    p = rows.size / a.nrows
    z_star, f_star, total_flop = sampled_counts(a, b, rows, device)

    z1 = z_star / p                                        # reference design
    f_pred = f_star / p                                    # symmetric F*
    r_star = f_star / max(z_star, 1)                       # sampled CR
    z2 = total_flop / r_star                               # proposed

    owner, col = oracle.expand_products(a, b, rows)        # k-min-hash
    keys = owner * np.int64(b.ncols) + col
    hv = np.unique(oracle._hash01(keys, seed))
    if hv.size <= k_minhash:
        z3s = float(hv.size)
    else:
        z3s = k_minhash / hv[k_minhash - 1]
    z3 = z3s / p

    e1 = (z1 - z_exact) / z_exact
    ef = (f_pred - total_flop) / total_flop
    e2 = (z2 - z_exact) / z_exact
    e3 = (z3 - z_exact) / z_exact
    # eq. 5 identity (must hold to float precision)
    e2_eq5 = (e1 - ef) / (1 + ef)
    return dict(
        sample_num=int(rows.size), flop=int(total_flop), nnz=int(z_exact),
        cr=total_flop / z_exact, e1=e1, ef=ef, e2=e2, e3=e3,
        eq5_resid=abs(e2 - e2_eq5),
    )


def aggregate(cases: list[dict]) -> dict:
    e1 = np.array([c["e1"] for c in cases])
    ef = np.array([c["ef"] for c in cases])
    e2 = np.array([c["e2"] for c in cases])
    e3 = np.array([c["e3"] for c in cases])
    better = np.abs(e2) < np.abs(e1)
    corr = float(np.corrcoef(e1, ef)[0, 1])
    return dict(
        n_cases=len(cases),
        mean_abs_e1=float(np.abs(e1).mean()), worst_abs_e1=float(np.abs(e1).max()),
        mean_abs_ef=float(np.abs(ef).mean()), worst_abs_ef=float(np.abs(ef).max()),
        mean_abs_e2=float(np.abs(e2).mean()), worst_abs_e2=float(np.abs(e2).max()),
        mean_abs_e3=float(np.abs(e3).mean()), worst_abs_e3=float(np.abs(e3).max()),
        proposed_better_frac=float(better.mean()),
        corr_e1_ef=corr,
        max_eq5_resid=float(max(c["eq5_resid"] for c in cases)),
        paper=dict(mean_abs_e1=0.0812, mean_abs_e2=0.0156, worst_abs_e1=1.58,
                   worst_abs_e2=0.25, proposed_better_frac=0.814, corr_e1_ef=0.9701),
    )


def subset_pairs() -> list[tuple[str, str]]:
    """75 deterministic (A, B) suite pairs: for each ordered family pair,
    3 evenly-spaced picks from the full product of that pair's matrices."""
    fams: dict[str, list[str]] = {}
    for e in suite_mod.SUITE:
        fams.setdefault(e.family, []).append(e.name)
    pairs = []
    for fa in fams:
        for fb in fams:
            prod = [(na, nb) for na in fams[fa] for nb in fams[fb]]
            for k in range(SUBSET_PER_FAMILY_PAIR):
                pairs.append(prod[(k * len(prod)) // SUBSET_PER_FAMILY_PAIR])
    return pairs


def run_subset(seed: int = 2022, *, device=None) -> dict:
    """The 75-case regression subset with the SAME per-case seeds as the
    full sweep (``seed + 625-enumeration-index``), so each subset case
    reproduces its counterpart in :func:`run_all`."""
    names = [e.name for e in suite_mod.SUITE]
    cases = []
    for na, nb in subset_pairs():
        i = names.index(na) * len(names) + names.index(nb)
        am, bm = match_dims(suite_mod.get_matrix(na),
                            suite_mod.get_matrix(nb))
        c = run_case(am, bm, seed=seed + i, device=device)
        c["A"], c["B"] = na, nb
        cases.append(c)
    return dict(aggregate=aggregate(cases), cases=cases, seed=seed)


def run_all(seed: int = 2022, out_path: str | None = None, names=None,
            verbose=True, *, device=None) -> dict:
    """The full sweep (625 cases with the default names).  The result is
    written to ``out_path`` only when the caller names one."""
    cases = []
    t0 = time.time()
    for i, (na, nb, a, b) in enumerate(suite_mod.iter_cases(names)):
        c = run_case(a, b, seed=seed + i, device=device)
        c["A"], c["B"] = na, nb
        cases.append(c)
        if verbose and (i + 1) % 25 == 0:
            agg = aggregate(cases)
            print(f"[{i+1:4d}] {time.time()-t0:7.1f}s  mean|e1|={agg['mean_abs_e1']*100:.2f}% "
                  f"mean|e2|={agg['mean_abs_e2']*100:.2f}%", flush=True)
    result = dict(aggregate=aggregate(cases), cases=cases, seed=seed)
    if out_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path + ".tmp", "w") as f:
            json.dump(result, f)
        os.replace(out_path + ".tmp", out_path)  # atomic commit
    if verbose:
        print(json.dumps(result["aggregate"], indent=2))
    return result
