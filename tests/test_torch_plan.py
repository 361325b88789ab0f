"""The slice as a whole: ``plan_spgemm`` → ``execute`` → ``reassemble`` in
the port against the JAX package on all five mini families (same operands,
same sample rows), with the default ``route="auto"``, and forced ESC, SPA
and BIN, and against the dense oracle;
plus the executor cache, the options the port refuses, and the rule that
the plan runs on the CUDA card unless the CPU is asked for."""
import numpy as np
import pytest
import torch

from repro.core import plan as jplan_mod
from repro.sparse import suite as jsuite
from repro.sparse.formats import spgemm_dense_oracle
from repro_torch.core import csr as tcsr
from repro_torch.core import plan as tplan_mod
from repro_torch.core.errors import (CapacityExhaustedError,
                                     PlanMismatchError)
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

FAMILIES = ("mini_er", "mini_pl", "mini_rmat", "mini_band", "mini_fem")
VAL_RTOL = 1e-5
VAL_ATOL_REL = 1e-6


def _valued(jm, seed):
    jm.val[:] = np.random.default_rng(seed).standard_normal(jm.nnz).astype(
        np.float32)
    return jm


_MINI = {n: _valued(m, 10 + i) for i, (n, m) in
         enumerate(jsuite.mini_suite(scale=200))}


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _rows(jm, n=40):
    return np.random.default_rng(2).integers(0, jm.nrows, n)


def _assert_slice_matches_jax(family, route, use_kernel):
    jm = _MINI[family]
    tm = _host(jm)
    rows = _rows(jm)
    # a safety factor wide enough that no row overflows on any family, so
    # the reassembled product can be held against the dense oracle
    jp = jplan_mod.plan_spgemm(jm, jm, route=route, sample_rows=rows,
                               safety=4.0)
    jout = jplan_mod.execute(jp, jm, jm)
    tp = tplan_mod.plan_spgemm(tm, tm, route=route, use_kernel=use_kernel,
                               sample_rows=rows, safety=4.0, device="cpu")
    tout = tplan_mod.execute(tp, tm, tm)
    # the same executor key (routes, tiles and spans included), bar the
    # use_kernel flag at index 3
    assert tp.key[:3] + tp.key[4:] == jp.key[:3] + jp.key[4:]
    assert tp.binning.route_rows() == jp.binning.route_rows()
    assert tp.alloc.bucket_capacities == jp.alloc.bucket_capacities
    np.testing.assert_array_max_ulp(np.float32(tp.predicted_nnz),
                                    np.float32(jp.predicted_nnz), maxulp=1)
    np.testing.assert_array_max_ulp(np.float32(tp.compression_ratio),
                                    np.float32(jp.compression_ratio),
                                    maxulp=1)
    np.testing.assert_array_equal(tp.structure, np.asarray(jp.structure))
    np.testing.assert_array_equal(tout.col.numpy(), np.asarray(jout.col))
    np.testing.assert_array_equal(tout.row_nnz.numpy(),
                                  np.asarray(jout.row_nnz))
    assert int(tout.overflow) == int(jout.overflow) == 0
    w = np.asarray(jout.val)
    vmax = np.abs(w).max(axis=1, keepdims=True)
    assert (np.abs(tout.val.numpy() - w)
            <= VAL_RTOL * np.abs(w) + VAL_ATOL_REL * vmax).all()
    tc = tplan_mod.reassemble(tp, tout)
    jc = jplan_mod.reassemble(jp, jout)
    np.testing.assert_array_equal(tc.rpt, jc.rpt)
    np.testing.assert_array_equal(tc.col, jc.col)
    np.testing.assert_allclose(tc.to_dense(), spgemm_dense_oracle(jm, jm),
                               rtol=1e-5, atol=1e-5)
    return tp


@pytest.mark.parametrize("family", FAMILIES)
def test_plan_execute_reassemble_matches_jax(family):
    _assert_slice_matches_jax(family, "esc", use_kernel=True)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_auto_route_plan_execute_reassemble_matches_jax(family, use_kernel):
    """The default route: band and fem plan all SPA, pl and rmat partly
    BIN, er all ESC."""
    tp = _assert_slice_matches_jax(family, "auto", use_kernel)
    routes = tp.binning.route_rows()
    if family in ("mini_band", "mini_fem"):
        assert routes["spa"] == tp.shape_a[0]
    if family in ("mini_pl", "mini_rmat"):
        assert routes["bin"] > 0 and routes["esc"] > 0


def test_plain_and_kernel_paths_agree_and_share_the_cache():
    tm = _host(_MINI["mini_pl"])
    cache = tplan_mod.PlanCache()
    outs = []
    for use_kernel in (False, True):
        p = tplan_mod.plan_spgemm(tm, tm, route="esc", use_kernel=use_kernel,
                                  sample_rows=_rows(tm), device="cpu")
        outs.append(tplan_mod.execute(p, tm, tm, cache=cache))
        tplan_mod.execute(p, tm, tm, cache=cache)
    assert cache.stats() == dict(size=2, hits=2, misses=2, traces=2)
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)


def test_overflow_is_counted_like_jax_and_refused_by_reassemble():
    jm = _MINI["mini_band"]
    tm = _host(jm)
    rows = _rows(jm)
    jp = jplan_mod.plan_spgemm(jm, jm, route="esc", sample_rows=rows,
                               safety=0.2)
    tp = tplan_mod.plan_spgemm(tm, tm, route="esc", sample_rows=rows,
                               safety=0.2, device="cpu")
    jout = jplan_mod.execute(jp, jm, jm)
    tout = tplan_mod.execute(tp, tm, tm)
    assert int(tout.overflow) == int(jout.overflow) > 0
    np.testing.assert_array_equal(tout.row_nnz.numpy(),
                                  np.asarray(jout.row_nnz))
    with pytest.raises(CapacityExhaustedError):
        tplan_mod.reassemble(tp, tout)
    c = tplan_mod.reassemble(tp, tout, on_overflow="ignore")
    assert c.nnz == int((tout.col != tcsr.COL_SENTINEL).sum())


@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("num_shards", 4), ("n_panels", 2),
    ("template", "auto"), ("pop_quant", True), ("retry_safety", 1.5),
    ("retry_policy", object()), ("dispatch_budget", object())])
def test_unported_options_are_refused(option, value):
    tm = _host(_MINI["mini_er"])
    with pytest.raises(PlanMismatchError, match="not ported yet"):
        tplan_mod.plan_spgemm(tm, tm, route="esc", device="cpu",
                              **{option: value})


@pytest.mark.parametrize("route", ["spa", "bin"])
def test_spa_and_bin_plans_are_refused(route):
    """Forced SPA and BIN plans, once refused, run and give what the JAX
    package gives, plain and through the kernel wrappers."""
    for family in ("mini_band", "mini_pl"):
        for use_kernel in (False, True):
            tp = _assert_slice_matches_jax(family, route, use_kernel)
            assert tp.binning.route_rows()[route] == tp.shape_a[0]


def test_operands_must_match_the_plan():
    tm = _host(_MINI["mini_fem"])
    p = tplan_mod.plan_spgemm(tm, tm, route="esc", device="cpu",
                              sample_rows=_rows(tm))
    wrong_cap = tcsr.to_device(tm, device="cpu")          # unpadded
    with pytest.raises(PlanMismatchError):
        tplan_mod.execute(p, wrong_cap, tm)
    other = _host(_MINI["mini_band"])
    with pytest.raises(PlanMismatchError):
        tplan_mod.execute(p, tm, other)


def test_plan_raises_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = _host(_MINI["mini_er"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplan_mod.plan_spgemm(tm, tm, route="esc", use_kernel=True)
