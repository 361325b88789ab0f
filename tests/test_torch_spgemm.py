"""Parity of the port's numeric phase (ESC, SPA and BIN routes) with the JAX
package's jnp twins: ``col``, ``row_nnz`` and ``overflow`` match exactly,
``val`` to rtol 1e-5 with atol 1e-6 × the row's largest |value| (run sums
are taken in another order).  The whole slice, executor included, is held against the JAX
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


def _plans(jm, route="esc"):
    """The JAX bucket plan and the port's copy built from the same host
    arrays (their equality is pinned in test_torch_csr.py)."""
    host = CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)
    return (jbinning.build_plan(jm, jm, route=route),
            tbinning.build_plan(host, host, route=route))


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


def _assert_binned_matches_jax(family, use_kernel, route):
    jm = _MINI[family]
    jd, td = _pair(jm)
    jplan, tplan = _plans(jm, route)
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
    if route == "auto":      # these families plan every row on SPA
        assert tplan.route_rows()["spa"] == jm.nrows
    _assert_out_matches(got, want)
    if int(got.overflow) == 0:
        np.testing.assert_allclose(
            tspgemm.dense_of(got, jm.ncols).numpy(),
            spgemm_dense_oracle(jm, jm), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", ["mini_band", "mini_fem"])
def test_spgemm_binned_matches_jax_and_the_dense_oracle(family, use_kernel):
    _assert_binned_matches_jax(family, use_kernel, "esc")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", ["mini_band", "mini_fem"])
def test_auto_spgemm_binned_matches_jax_and_the_dense_oracle(family,
                                                            use_kernel):
    _assert_binned_matches_jax(family, use_kernel, "auto")


def test_spgemm_binned_uniform_capacity_overflow_matches_jax():
    jm = _MINI["mini_band"]
    jd, td = _pair(jm)
    jplan, tplan = _plans(jm)
    want = jspgemm.spgemm_binned(jd, jd, jplan, alloc=16)
    got = tspgemm.spgemm_binned(td, td, tplan, alloc=16, use_kernel=True)
    assert int(got.overflow) > 0
    _assert_out_matches(got, want)


@pytest.mark.parametrize("row_capacity", [8, 64])
@pytest.mark.parametrize("family", ["mini_pl", "mini_band"])
def test_spgemm_rows_spa_and_bin_match_jax(family, row_capacity):
    jm = _MINI[family]
    jd, td = _pair(jm)
    rows = np.random.default_rng(6).integers(0, jm.nrows, 50).astype(np.int32)
    da = int(jm.row_nnz.max())
    kw = dict(row_capacity=row_capacity, max_deg_a=da, max_deg_b=da)
    for span in (0, 256):
        want = jspgemm.spgemm_rows_spa(jd, jd, jnp.asarray(rows),
                                       block_rows=16, span=span, **kw)
        got = tspgemm.spgemm_rows_spa(td, td, torch.from_numpy(rows),
                                      span=span, **kw)
        _assert_out_matches(got, want)
    want = jspgemm.spgemm_rows_bin(jd, jd, jnp.asarray(rows), block_rows=16,
                                   tile_n=128, n_tiles=2, **kw)
    got = tspgemm.spgemm_rows_bin(td, td, torch.from_numpy(rows), tile_n=128,
                                  n_tiles=2, **kw)
    _assert_out_matches(got, want)


@pytest.mark.parametrize("col_offset", [False, True])
@pytest.mark.parametrize("row_capacity", [3, 16])
def test_compact_dense_matches_jax(row_capacity, col_offset):
    """Capacity below a row's nnz drops its last columns but keeps the true
    nnz; a sum that cancels to 0.0 stays an entry."""
    rng = np.random.default_rng(11)
    present = rng.random((5, 24)) < 0.4
    present[0] = False                           # an empty row
    acc = np.where(present, rng.standard_normal((5, 24)), 0.0).astype(
        np.float32)
    acc[1, np.flatnonzero(present[1])[:2]] = 0.0  # cancelled sums
    off = (100 * np.arange(5)).astype(np.int32) if col_offset else None
    want = jspgemm.compact_dense(jnp.asarray(acc), jnp.asarray(present),
                                 row_capacity,
                                 col_offset=None if off is None
                                 else jnp.asarray(off))
    got = tspgemm.compact_dense(torch.from_numpy(acc),
                                torch.from_numpy(present), row_capacity,
                                col_offset=None if off is None
                                else torch.from_numpy(off))
    _assert_out_matches(tspgemm.SpGEMMOut(*got), jspgemm.SpGEMMOut(*want))
    assert int(got[2][1]) == int(present[1].sum())   # zeros still count
    if row_capacity == 3:
        assert int(got[3]) > 0


def test_routed_spgemm_rows_refuses_unported_routes():
    """The routes once refused here run, plain and through the kernel
    wrappers, and give what the JAX package's dispatch gives — including
    its rule that a BIN bucket without a bin layout runs ESC."""
    jm = _MINI["mini_pl"]
    jd, td = _pair(jm)
    rows = np.random.default_rng(8).integers(0, jm.nrows, 40).astype(np.int32)
    da = int(jm.row_nnz.max())
    for route, tile_n, n_tiles in ((r, t, n) for r in ("spa", "bin")
                                   for t, n in ((0, 0), (128, 4))):
        kw = dict(row_capacity=16, deg_a=da, deg_b=da, block_rows=8,
                  route=route, tile_n=tile_n, n_tiles=n_tiles, span=512)
        want = jspgemm.routed_spgemm_rows(jd, jd, jnp.asarray(rows), **kw)
        for use_kernel in (False, True):
            got = tspgemm.routed_spgemm_rows(td, td, torch.from_numpy(rows),
                                             use_kernel=use_kernel, **kw)
            _assert_out_matches(got, want)


