"""A run with the timed path broken underneath must come out not correct,
and the control (the reference a precision lower) must fail a limit.
Every case drives the whole of a run on the host at a small size, past the
harness's look for a card."""
import json
from pathlib import Path

import pytest
import torch

from chipbench import check, control, driver, run, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"graph500_s16": dict(scale=8, edgefactor=8),
         "hypre_27pt_128": dict(n=6)}
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_cell(name):
    cell, cfg, mix = run.load_cell(BENCH, name)
    cfg.update(SMALL[cell["config"]])
    return cfg, mix


def one_run(name, seed=2**32 + 17):
    cfg, mix = small_cell(name)
    out = driver.run(cfg, mix, seed, 0.3, False, "cpu", 0.0,
                     peak=work.peaks("NVIDIA H100 80GB HBM3"))
    return run.result_line(BENCH, name, out, False, {})


def blocks_of(out):
    """Every (col, val, row_nnz) block of an execute result."""
    from repro_torch.core.spgemm import PanelSpgemmOut
    if isinstance(out, PanelSpgemmOut):
        return [(c, v, n) for bc, bv, bn in zip(out.cols, out.vals,
                                                out.row_nnz)
                for c, v, n in zip(bc, bv, bn)]
    return [(out.col, out.val, out.row_nnz)]


def stale(execute):
    """A step that returns its state unchanged: every call after the
    first returns the first call's result."""
    first = []

    def broken(*a, **k):
        out = execute(*a, **k)
        if not first:
            first.append(out)
        return first[0]
    return broken


def half_left_out(execute):
    """Half of the rows left out: the first half of every block's rows
    come back empty."""
    from repro_torch.core.csr import COL_SENTINEL

    def broken(*a, **k):
        out = execute(*a, **k)
        for col, val, n in blocks_of(out):
            h = (col.shape[0] + 1) // 2
            col[:h] = COL_SENTINEL
            val[:h] = 0
            n[:h] = 0
        return out
    return broken


def altered(execute):
    """One answer altered where it is produced: one kept value moved."""
    from repro_torch.core.csr import COL_SENTINEL

    def broken(*a, **k):
        out = execute(*a, **k)
        for col, val, _ in blocks_of(out):
            kept = torch.nonzero(col != COL_SENTINEL)
            if kept.numel():
                val[tuple(kept[0])] += 1.0
                break
        return out
    return broken


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line = one_run(name)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault", [stale, half_left_out, altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(name, fault, monkeypatch):
    from repro_torch.core import plan as plan_mod
    monkeypatch.setattr(plan_mod, "execute", fault(plan_mod.execute))
    line = one_run(name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(name):
    cfg, mix = small_cell(name)
    lim = check.limits()
    for seed in (3, 4, 5):
        got = control.readings(cfg, mix, seed, "cpu")
        over = [k for k, v in got.items() if v > lim[k]]
        assert over, got
        assert got["val_err"] > lim["val_err"]
        if "pred_gap" in got:
            assert got["pred_gap"] > lim["pred_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit_at_the_cell_size(name, cuda_device):
    _, cfg, mix = run.load_cell(BENCH, name)
    got = control.readings(cfg, mix, 2**31 + 3, cuda_device)
    assert got["val_err"] > check.limits()["val_err"]
