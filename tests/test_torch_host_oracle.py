"""The port's host oracles against the JAX package's.

* ``core.moe_capacity``: the numpy functions (``predict_dispatch_capacity``,
  ``predict_group_capacity``, ``exact_dispatch_blocks``) equal JAX's on
  ``tests/test_moe.py``'s capacity cases, field for field; the torch twin
  ``predict_dispatch_capacity_torch`` equals ``predict_dispatch_capacity_jnp``
  on the same explicit group sample (blocks* and CR* in float32, bit for
  bit; flopr_e exactly), and its sampled counts equal the numpy plan's z*
  and f*.
* ``core.oracle``: ``stratified_predict``, ``upper_bound_predict`` and
  ``spgemm`` equal JAX's on ``tests/test_oracle.py``'s cases.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moe_capacity as jmc
from repro.core import oracle as joracle
from repro.sparse import random as sprand
from repro.sparse.formats import CSR as JCSR
from repro_torch.core import moe_capacity as tmc
from repro_torch.core import oracle as toracle
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)


def _zipf_ids():
    """``test_dispatch_capacity_prediction_accuracy``'s skewed routing."""
    rng = np.random.default_rng(0)
    tokens, k, e = 200_000, 8, 64
    p = (np.arange(1, e + 1) ** -0.8)
    p /= p.sum()
    return rng.choice(e, size=(tokens, k), p=p), e


def _uniform_ids():
    """``test_dispatch_capacity_jnp_matches_numpy``'s routing."""
    rng = np.random.default_rng(2)
    tokens, k, e = 4096, 2, 16
    return rng.integers(0, e, size=(tokens, k)), e


# (ids, group size, seed, sample_fraction)
CASES = {
    "zipf-512": (_zipf_ids, 512, 1, 0.003),
    "zipf-64": (_zipf_ids, 64, 3, 0.05),
    "uniform-256": (_uniform_ids, 256, 0, 0.5),
}


def _assert_plan_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b and type(a) is type(b), f.name


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_capacity_functions_match_jax(case):
    make, group, seed, frac = CASES[case]
    ids, e = make()
    _assert_plan_equal(
        tmc.predict_dispatch_capacity(ids, e, group, seed=seed,
                                      sample_fraction=frac),
        jmc.predict_dispatch_capacity(ids, e, group, seed=seed,
                                      sample_fraction=frac))
    assert tmc.predict_group_capacity(ids, e, group, seed=seed,
                                      sample_fraction=frac) == \
        jmc.predict_group_capacity(ids, e, group, seed=seed,
                                   sample_fraction=frac)
    assert tmc.exact_dispatch_blocks(ids, group) == \
        jmc.exact_dispatch_blocks(ids, group)
    plan = tmc.predict_dispatch_capacity(ids, e, group, seed=seed,
                                         sample_fraction=frac)
    assert plan.block_buffer_size() == jmc.predict_dispatch_capacity(
        ids, e, group, seed=seed, sample_fraction=frac).block_buffer_size()


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_twin_matches_jnp_twin(case):
    make, group, seed, frac = CASES[case]
    ids, e = make()
    gids = tmc.dispatch_sample_groups(ids.shape[0], group, seed, frac)
    jb, jcr, jflop = jmc.predict_dispatch_capacity_jnp(
        jnp.asarray(ids, jnp.int32), e, group, jnp.asarray(gids, jnp.int32))
    tids = torch.from_numpy(ids.astype(np.int32))
    tb, tcr, tflop = tmc.predict_dispatch_capacity_torch(
        tids, e, group, torch.from_numpy(gids))
    assert tb.dtype == tcr.dtype == torch.float32
    assert tflop.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tcr.numpy(), np.asarray(jcr))
    np.testing.assert_array_equal(tflop.numpy(), np.asarray(jflop))
    # the twin's sample is the numpy plan's: z* and f* exactly
    plan = tmc.predict_dispatch_capacity(ids, e, group, seed=seed,
                                         sample_fraction=frac)
    z, f = tmc.sampled_dispatch_counts_torch(tids, group,
                                             torch.from_numpy(gids))
    assert (int(z), f) == (plan.exact_sample_blocks, plan.sampled_assignments)
    assert float(tb) == pytest.approx(plan.predicted_blocks, rel=1e-6)


# --------------------------------------------------------------------------- #
# host oracle
# --------------------------------------------------------------------------- #
def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _rand_pair(seed, m=60, k=50, n=40, da=4, db=5):
    return (sprand.erdos_renyi(m, k, da, seed),
            sprand.erdos_renyi(k, n, db, seed + 1))


def _mixed_cr():
    """``test_stratified_predict_differentiates_mixed_cr``'s matrix."""
    m = 2000
    top = sprand.banded(m // 2, m, 40, 24, seed=1)
    bot = sprand.erdos_renyi(m // 2, m, 5, seed=2)
    rows = np.concatenate([np.repeat(np.arange(m // 2), top.row_nnz),
                           np.repeat(np.arange(m // 2, m), bot.row_nnz)])
    a = JCSR.from_coo(rows, np.concatenate([top.col, bot.col]),
                      np.concatenate([top.val, bot.val]), (m, m), dedup=False)
    return a, a


PAIRS = {"er-5": lambda: _rand_pair(5), "er-9": lambda: _rand_pair(9),
         "er-11": lambda: _rand_pair(11),
         "er-200": lambda: _rand_pair(3, m=200), "mixed-cr": _mixed_cr}


def _assert_prediction_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_oracle_predictors_match_jax(pair):
    a, b = PAIRS[pair]()
    ta, tb = _host(a), _host(b)
    for seed, segs, per in ((0, 64, 8), (1, 16, 8), (2, 5, 3)):
        _assert_prediction_equal(
            toracle.stratified_predict(ta, tb, seed=seed, num_segments=segs,
                                       per_segment=per),
            joracle.stratified_predict(a, b, seed=seed, num_segments=segs,
                                       per_segment=per))
    _assert_prediction_equal(toracle.upper_bound_predict(ta, tb),
                             joracle.upper_bound_predict(a, b))


@pytest.mark.parametrize("chunk_flop", [1 << 23, 64])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_oracle_spgemm_matches_jax(pair, chunk_flop):
    a, b = PAIRS[pair]()
    got = toracle.spgemm(_host(a), _host(b), chunk_flop=chunk_flop)
    want = joracle.spgemm(a, b, chunk_flop=chunk_flop)
    assert isinstance(got, CSR) and got.shape == want.shape
    np.testing.assert_array_equal(got.rpt, want.rpt)
    np.testing.assert_array_equal(got.col, want.col)
    np.testing.assert_array_equal(got.val, want.val)
