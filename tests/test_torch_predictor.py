"""Parity of the port's predictor (the paper's method, eq. 4, and the
reference design, eq. 2) with the JAX package: the same operands, the same
bucket plan and the same explicit sample rows go to both.  Integer counts
(z*, f*, floprC) and capacities match exactly; the float32 eq. 4 chain to
1 ulp (JAX's jitted chain may round differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binning as jbinning
from repro.core import csr as jcsr
from repro.core import flop as jflop
from repro.core import predictor as jpred
from repro.sparse import random as jrand
from repro.sparse import suite as jsuite
from repro_torch import convert
from repro_torch.core import binning as tbinning
from repro_torch.core import predictor as tpred
from repro_torch.core.csr import COL_SENTINEL
from repro_torch.core.errors import PlanMismatchError

torch.set_num_threads(1)

FAMILIES = ("mini_er", "mini_pl", "mini_rmat", "mini_band", "mini_fem")
_MINI = dict(jsuite.mini_suite(scale=200))


def _case(jm, route="esc", samples=40, seed=0):
    """JAX and port operands, the JAX bucket plan carried across, and
    explicit sample rows (with replacement)."""
    cap = tbinning.ceil_pow2(jm.nnz)
    jd = jcsr.to_device(jm, capacity=cap)
    td = convert.csr_device_from_numpy(np.asarray(jd.rpt), np.asarray(jd.col),
                                       np.asarray(jd.val), jd.shape,
                                       device="cpu")
    jplan = jbinning.build_plan(jm, jm, route=route)
    tplan = convert.binning_plan_from_numpy(
        [dict(rows=np.asarray(b.rows), deg_a=b.deg_a, deg_b=b.deg_b,
              block_rows=b.block_rows, route=b.route, tile_n=b.tile_n,
              n_tiles=b.n_tiles, span=b.span) for b in jplan.buckets],
        global_deg_a=jplan.global_deg_a, global_deg_b=jplan.global_deg_b)
    rows = np.random.default_rng(seed).integers(
        0, jm.nrows, samples).astype(np.int32)
    return jd, td, jplan, tplan, rows


def _assert_pred_matches(tp, jp):
    for what in ("sampled_nnz", "sampled_flop", "total_flop"):
        assert int(getattr(tp, what)) == int(getattr(jp, what)), what
    for what in ("nnz_total", "compression_ratio", "structure"):
        got = np.asarray(getattr(tp, what).numpy(), dtype=np.float32)
        want = np.asarray(getattr(jp, what), dtype=np.float32)
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_count_distinct_sorted_matches_jax():
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 12, size=(6, 32)).astype(np.int32)
    cols[rng.random(cols.shape) < 0.3] = COL_SENTINEL
    cols[2] = COL_SENTINEL                       # an all-padding row
    got = tpred.count_distinct_sorted(torch.from_numpy(cols))
    want = jpred.count_distinct_sorted(jnp.asarray(cols))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_binned_symbolic_counts_match_jax(family, use_kernel):
    jd, td, jplan, tplan, rows = _case(_MINI[family])
    zj, fj = jpred.binned_symbolic_counts(jd, jd, jnp.asarray(rows), jplan)
    zt, ft = tpred.binned_symbolic_counts(td, td, torch.from_numpy(rows),
                                          tplan, use_kernel=use_kernel)
    assert zt.dtype == torch.int32 and ft.dtype == torch.int32
    assert (int(zt), int(ft)) == (int(zj), int(fj))


@pytest.mark.parametrize("family", FAMILIES)
def test_proposed_predict_binned_matches_jax(family):
    jd, td, jplan, tplan, rows = _case(_MINI[family])
    jp = jpred.proposed_predict_binned(jd, jd, jnp.asarray(rows), jplan)
    for use_kernel in (False, True):
        tp = tpred.proposed_predict_binned(td, td, torch.from_numpy(rows),
                                           tplan, use_kernel=use_kernel)
        _assert_pred_matches(tp, jp)


def test_proposed_predict_binned_matches_jax_pallas_kernels():
    """The JAX side through its Pallas kernels (interpret mode): the
    per-bucket FLOP kernel and the fused symbolic kernel."""
    jm = jrand.power_law(96, 96, 3, 1.6, seed=9)
    jd, td, jplan, tplan, rows = _case(jm, samples=24, seed=4)
    jp = jpred.proposed_predict_binned(jd, jd, jnp.asarray(rows), jplan,
                                       use_kernel=True)
    tp = tpred.proposed_predict_binned(td, td, torch.from_numpy(rows), tplan,
                                       use_kernel=True)
    _assert_pred_matches(tp, jp)


@pytest.mark.parametrize("family", ["mini_pl", "mini_fem"])
def test_reference_predict_binned_matches_jax(family):
    jd, td, jplan, tplan, rows = _case(_MINI[family])
    jp = jpred.reference_predict_binned(jd, jd, jnp.asarray(rows), jplan)
    tp = tpred.reference_predict_binned(td, td, torch.from_numpy(rows), tplan)
    _assert_pred_matches(tp, jp)


@pytest.mark.parametrize("family", ["mini_er", "mini_band"])
def test_global_pad_predictors_match_jax(family):
    jm = _MINI[family]
    jd, td, _, _, rows = _case(jm)
    da = int(jm.row_nnz.max())
    jrows, trows = jnp.asarray(rows), torch.from_numpy(rows)
    _assert_pred_matches(tpred.proposed_predict(td, td, trows, da, da),
                         jpred.proposed_predict(jd, jd, jrows, da, da))
    _assert_pred_matches(tpred.reference_predict(td, td, trows, da, da),
                         jpred.reference_predict(jd, jd, jrows, da, da))


@pytest.mark.parametrize("pow2", [False, True])
@pytest.mark.parametrize("family", ["mini_pl", "mini_rmat", "mini_fem"])
def test_allocation_plans_match_jax(family, pow2):
    jd, td, jplan, tplan, rows = _case(_MINI[family])
    jp = jpred.proposed_predict_binned(jd, jd, jnp.asarray(rows), jplan)
    tp = tpred.proposed_predict_binned(td, td, torch.from_numpy(rows), tplan)
    flopr = np.asarray(jflop.flop_per_row(jd, jd)[0], dtype=np.int64)
    ja = jpred.BinnedAllocationPlan.from_prediction(
        jplan, np.asarray(jp.structure), flopr, safety=1.3, pow2=pow2)
    ta = tpred.BinnedAllocationPlan.from_prediction(
        tplan, tp.structure.numpy(), flopr, safety=1.3, pow2=pow2)
    assert ta.bucket_capacities == ja.bucket_capacities
    assert (ta.row_capacity, ta.total_capacity) == \
        (ja.row_capacity, ja.total_capacity)


def test_spa_buckets_are_refused():
    jd, td, jplan, tplan, rows = _case(_MINI["mini_band"], route="spa")
    for use_kernel in (False, True):
        with pytest.raises(PlanMismatchError, match="not ported yet"):
            tpred.binned_symbolic_counts(td, td, torch.from_numpy(rows),
                                         tplan, use_kernel=use_kernel)
