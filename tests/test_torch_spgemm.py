"""Parity of the port's numeric phase (ESC route) with the JAX package's jnp
twins: ``col``, ``row_nnz`` and ``overflow`` match exactly, ``val`` to
rtol 1e-5 with atol 1e-6 × the row's largest |value| (run sums are taken in
another order).  The whole slice, executor included, is held against the JAX
package on all five families in test_torch_plan.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binning as jbinning
from repro.core import csr as jcsr
from repro.core import flop as jflop
from repro.core import predictor as jpred
from repro.core import spgemm as jspgemm
from repro.sparse import suite as jsuite
from repro.sparse.formats import spgemm_dense_oracle
from repro_torch import convert
from repro_torch.core import binning as tbinning
from repro_torch.core import predictor as tpred
from repro_torch.core import spgemm as tspgemm
from repro_torch.core.errors import PlanMismatchError
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

VAL_RTOL = 1e-5
VAL_ATOL_REL = 1e-6


def _valued(jm, seed):
    """A mini-suite matrix with random values (the generators emit ones)."""
    jm.val[:] = np.random.default_rng(seed).standard_normal(jm.nnz).astype(
        np.float32)
    return jm


_MINI = {n: _valued(m, i) for i, (n, m) in
         enumerate(jsuite.mini_suite(scale=200))}


def _pair(jm):
    jd = jcsr.to_device(jm, capacity=tbinning.ceil_pow2(jm.nnz))
    td = convert.csr_device_from_numpy(np.asarray(jd.rpt), np.asarray(jd.col),
                                       np.asarray(jd.val), jd.shape,
                                       device="cpu")
    return jd, td


def _plans(jm):
    """The JAX bucket plan and the port's copy built from the same host
    arrays (their equality is pinned in test_torch_csr.py)."""
    host = CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)
    return (jbinning.build_plan(jm, jm, route="esc"),
            tbinning.build_plan(host, host, route="esc"))


def _assert_out_matches(got, want):
    np.testing.assert_array_equal(got.col.numpy(), np.asarray(want.col))
    np.testing.assert_array_equal(got.row_nnz.numpy(),
                                  np.asarray(want.row_nnz))
    assert int(got.overflow) == int(want.overflow)
    g, w = got.val.numpy(), np.asarray(want.val)
    vmax = np.abs(w).max(axis=1, keepdims=True) if w.size else 0.0
    assert (np.abs(g - w) <= VAL_RTOL * np.abs(w) + VAL_ATOL_REL * vmax).all()


@pytest.mark.parametrize("row_capacity", [8, 64])
@pytest.mark.parametrize("family", ["mini_pl", "mini_band"])
def test_spgemm_rows_matches_jax(family, row_capacity):
    jm = _MINI[family]
    jd, td = _pair(jm)
    rows = np.random.default_rng(5).integers(0, jm.nrows, 50).astype(np.int32)
    da = int(jm.row_nnz.max())
    want = jspgemm.spgemm_rows(jd, jd, jnp.asarray(rows),
                               row_capacity=row_capacity, max_deg_a=da,
                               max_deg_b=da, block_rows=16)
    got = tspgemm.spgemm_rows(td, td, torch.from_numpy(rows),
                              row_capacity=row_capacity, max_deg_a=da,
                              max_deg_b=da)
    _assert_out_matches(got, want)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", ["mini_band", "mini_fem"])
def test_spgemm_binned_matches_jax_and_the_dense_oracle(family, use_kernel):
    jm = _MINI[family]
    jd, td = _pair(jm)
    jplan, tplan = _plans(jm)
    rows = np.random.default_rng(1).integers(0, jm.nrows, 40)
    jp = jpred.proposed_predict_binned(jd, jd, jnp.asarray(rows), jplan)
    alloc_j = jpred.BinnedAllocationPlan.from_prediction(
        jplan, np.asarray(jp.structure),
        np.asarray(jflop.flop_per_row(jd, jd)[0]), safety=1.3)
    alloc_t = tpred.BinnedAllocationPlan(
        bucket_capacities=alloc_j.bucket_capacities,
        row_capacity=alloc_j.row_capacity,
        total_capacity=alloc_j.total_capacity, safety=alloc_j.safety)
    want = jspgemm.spgemm_binned(jd, jd, jplan, alloc=alloc_j)
    got = tspgemm.spgemm_binned(td, td, tplan, alloc=alloc_t,
                                use_kernel=use_kernel)
    _assert_out_matches(got, want)
    if int(got.overflow) == 0:
        np.testing.assert_allclose(
            tspgemm.dense_of(got, jm.ncols).numpy(),
            spgemm_dense_oracle(jm, jm), rtol=1e-5, atol=1e-5)


def test_spgemm_binned_uniform_capacity_overflow_matches_jax():
    jm = _MINI["mini_band"]
    jd, td = _pair(jm)
    jplan, tplan = _plans(jm)
    want = jspgemm.spgemm_binned(jd, jd, jplan, alloc=16)
    got = tspgemm.spgemm_binned(td, td, tplan, alloc=16, use_kernel=True)
    assert int(got.overflow) > 0
    _assert_out_matches(got, want)


def test_routed_spgemm_rows_refuses_unported_routes():
    _, td = _pair(_MINI["mini_er"])
    rows = torch.arange(8, dtype=torch.int32)
    for use_kernel in (False, True):
        with pytest.raises(PlanMismatchError, match="not ported yet"):
            tspgemm.routed_spgemm_rows(td, td, rows, row_capacity=8, deg_a=4,
                                       deg_b=4, route="spa",
                                       use_kernel=use_kernel)
