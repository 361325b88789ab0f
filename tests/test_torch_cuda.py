"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode).  The module imports no JAX, so it also runs where
only the port is installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import binning, csr, plan
from repro_torch.kernels import flop_per_row as flop_k
from repro_torch.kernels import spgemm_numeric as num_k
from repro_torch.kernels import spgemm_symbolic as sym_k
from repro_torch.sparse import random as sprand

torch.set_num_threads(1)

VAL_RTOL = 1e-5      # run sums are taken in another order
VAL_ATOL_REL = 1e-6  # × the row's largest |value|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _valued(m, seed):
    m.val[:] = np.random.default_rng(seed).standard_normal(m.nnz).astype(
        np.float32)
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [1.2, 1.6])
def test_kernels_match_plain_versions_on_every_bucket(card, alpha):
    """Hub buckets reach 2^21 product lanes, past shared memory: both the
    shared-memory and the global-scratch workspace paths run."""
    m = _valued(sprand.power_law(3000, 3000, 40, alpha, seed=5), 6)
    bp = binning.build_plan(m, m, route="esc")
    ad = csr.to_device(m, device=card)
    rnb = torch.diff(ad.rpt)
    sample = np.random.default_rng(0).integers(0, m.nrows, 300)
    for bk, sub in zip(bp.buckets, bp.subset(sample)):
        rows = torch.from_numpy(bk.rows).to(card)
        kw = dict(a=ad, rownnz_b=rnb, rows=rows, max_deg_a=bk.deg_a)
        assert torch.equal(flop_k.flop_rows(**kw),
                           flop_k.flop_rows_plain(**kw))
        if sub.size:
            kw = dict(a=ad, b=ad, rows=torch.from_numpy(sub).to(card),
                      max_deg_a=bk.deg_a, max_deg_b=bk.deg_b)
            got = sym_k.fused_flop_symbolic(**kw)
            want = sym_k.fused_flop_symbolic_plain(**kw)
            assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
            assert torch.equal(got[2], want[2])
        kw = dict(a=ad, b=ad, rows=rows, max_deg_a=bk.deg_a,
                  max_deg_b=bk.deg_b, row_capacity=64)
        got = num_k.spgemm_numeric(**kw)
        want = num_k.spgemm_numeric_plain(**kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        assert int(got[3]) == int(want[3])
        vmax = want[1].abs().amax(dim=1, keepdim=True)
        assert bool(((got[1] - want[1]).abs()
                     <= VAL_RTOL * want[1].abs() + VAL_ATOL_REL * vmax).all())


@pytest.mark.cuda
def test_plan_on_the_card_matches_the_plan_on_the_host(card):
    m = _valued(sprand.rmat(2000, 2000, 16000, seed=13), 7)
    rows = np.random.default_rng(1).integers(0, m.nrows, 60)
    outs = []
    for dev, use_kernel in ((card, True), ("cpu", False)):
        p = plan.plan_spgemm(m, m, route="esc", use_kernel=use_kernel,
                             sample_rows=rows, device=dev)
        outs.append(plan.execute(p, m, m))
    got, want = outs
    assert torch.equal(got.col.cpu(), want.col)
    assert torch.equal(got.row_nnz.cpu(), want.row_nnz)
    assert int(got.overflow) == int(want.overflow)
    np.testing.assert_allclose(got.val.cpu().numpy(), want.val.numpy(),
                               rtol=VAL_RTOL, atol=1e-5)


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches_only(card):
    m = sprand.erdos_renyi(500, 500, 4, seed=3)
    ad = csr.to_device(m, device=card)
    rows = torch.arange(100, dtype=torch.int32, device=card)
    before = num_k.spgemm_numeric.launches
    num_k.spgemm_numeric_plain(ad, ad, rows, max_deg_a=16, max_deg_b=16,
                               row_capacity=32)
    assert num_k.spgemm_numeric.launches == before
    num_k.spgemm_numeric(ad, ad, rows, max_deg_a=16, max_deg_b=16,
                         row_capacity=32)
    assert num_k.spgemm_numeric.launches == before + 1
