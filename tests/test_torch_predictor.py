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


@pytest.mark.parametrize("span", [0, 8, 64])
def test_count_distinct_dense_matches_jax(span):
    """Equal to the sorted count while the span covers the extent; a span
    too narrow drops the same columns in both packages."""
    rng = np.random.default_rng(4)
    cols = (rng.integers(0, 30, size=(7, 40)) + 50 * np.arange(7)[:, None]
            ).astype(np.int32)
    cols[rng.random(cols.shape) < 0.3] = COL_SENTINEL
    cols[5] = COL_SENTINEL
    got = tpred.count_distinct_dense(torch.from_numpy(cols), 400, span)
    want = jpred.count_distinct_dense(jnp.asarray(cols), 400, span)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if span != 8:
        np.testing.assert_array_equal(
            got.numpy(), tpred.count_distinct_sorted(
                torch.from_numpy(cols)).numpy())


@pytest.mark.parametrize("route", ["auto", "spa", "bin"])
@pytest.mark.parametrize("family", FAMILIES)
def test_routed_binned_symbolic_counts_match_jax(family, route):
    """Each bucket counts on its route (the bitmask on SPA and BIN), and
    the totals equal JAX's and the all-ESC totals, plain and through the
    kernel wrappers."""
    jd, td, jplan, tplan, rows = _case(_MINI[family], route=route)
    zj, fj = jpred.binned_symbolic_counts(jd, jd, jnp.asarray(rows), jplan)
    ze, fe = tpred.binned_symbolic_counts(td, td, torch.from_numpy(rows),
                                          _case(_MINI[family])[3])
    for use_kernel in (False, True):
        zt, ft = tpred.binned_symbolic_counts(td, td, torch.from_numpy(rows),
                                              tplan, use_kernel=use_kernel)
        assert (int(zt), int(ft)) == (int(zj), int(fj)) == (int(ze), int(fe))


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


def _assert_predict_matches_jax_pallas_kernels(jm, route):
    jd, td, jplan, tplan, rows = _case(jm, route=route, samples=24, seed=4)
    jp = jpred.proposed_predict_binned(jd, jd, jnp.asarray(rows), jplan,
                                       use_kernel=True)
    tp = tpred.proposed_predict_binned(td, td, torch.from_numpy(rows), tplan,
                                       use_kernel=True)
    _assert_pred_matches(tp, jp)
    return tplan


def test_proposed_predict_binned_matches_jax_pallas_kernels():
    """The JAX side through its Pallas kernels (interpret mode): the
    per-bucket FLOP kernel and the fused symbolic kernel."""
    _assert_predict_matches_jax_pallas_kernels(
        jrand.power_law(96, 96, 3, 1.6, seed=9), "esc")


def test_auto_route_predict_binned_matches_jax_pallas_kernels():
    """A banded matrix's auto-routed SPA buckets: the JAX side through its
    bitmask symbolic Pallas kernel (interpret mode)."""
    tplan = _assert_predict_matches_jax_pallas_kernels(
        jrand.banded(96, 96, 12, 8, seed=9), "auto")
    assert tplan.route_rows()["spa"] > 0


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


def test_spa_buckets_predict_what_jax_predicts():
    """SPA buckets predict what the JAX package predicts, plain and through
    the kernel wrappers."""
    jd, td, jplan, tplan, rows = _case(_MINI["mini_band"], route="spa")
    jp = jpred.proposed_predict_binned(jd, jd, jnp.asarray(rows), jplan)
    for use_kernel in (False, True):
        tp = tpred.proposed_predict_binned(td, td, torch.from_numpy(rows),
                                           tplan, use_kernel=use_kernel)
        _assert_pred_matches(tp, jp)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", ["mini_er", "mini_band"])
def test_global_pad_predictors_match_jax_pallas_kernel(family, use_kernel):
    """The paper's predictor at global bounds against JAX's
    ``proposed_predict(use_kernel=True)``, whose sampled symbolic pass runs
    in its Pallas kernel (interpret mode); the reference design against
    JAX's ``reference_predict``.  On the CPU the port's kernel path runs
    the plain versions of the FLOP and symbolic kernels."""
    jm = _MINI[family]
    jd, td, _, _, rows = _case(jm)
    da = int(jm.row_nnz.max())
    jrows, trows = jnp.asarray(rows), torch.from_numpy(rows)
    jp = jpred.proposed_predict(jd, jd, jrows, da, da, use_kernel=True)
    tp = tpred.proposed_predict(td, td, trows, da, da, use_kernel=use_kernel)
    _assert_pred_matches(tp, jp)
    _assert_pred_matches(
        tpred.reference_predict(td, td, trows, da, da, use_kernel=use_kernel),
        jpred.reference_predict(jd, jd, jrows, da, da))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_global_pad_equals_binned_predictor(family, use_kernel):
    """One pad at the global bounds and one pad per degree bucket count the
    same integers, so the port's two predictors agree bit for bit — the
    float eq. 4 chain included (the JAX package's jitted global one may
    round 1 ulp apart, fault R2)."""
    jm = _MINI[family]
    _, td, _, tplan, rows = _case(jm)
    da = int(jm.row_nnz.max())
    trows = torch.from_numpy(rows)
    g = tpred.proposed_predict(td, td, trows, da, da, use_kernel=use_kernel)
    b = tpred.proposed_predict_binned(td, td, trows, tplan,
                                      use_kernel=use_kernel)
    for what in g._fields:
        assert torch.equal(getattr(g, what), getattr(b, what)), what


@pytest.mark.parametrize("m", [1, 150, 4000, 333_334, 10**7])
def test_static_sample_num_matches_jax(m):
    assert tpred.static_sample_num(m) == jpred.static_sample_num(m)
    assert (tpred.SAMPLE_FRACTION, tpred.SAMPLE_CAP) == \
        (jpred.SAMPLE_FRACTION, jpred.SAMPLE_CAP)


def test_draw_sample_rows_is_seeded_int32_in_range():
    """The same generator seed draws the same rows (not JAX's: the streams
    differ), int32 in [0, M)."""
    draw = lambda seed: tpred.draw_sample_rows(
        torch.Generator().manual_seed(seed), 1000, 300)
    rows = draw(0)
    assert rows.dtype == torch.int32 and rows.shape == (300,)
    assert int(rows.min()) >= 0 and int(rows.max()) <= 999
    assert torch.equal(rows, draw(0)) and not torch.equal(rows, draw(1))
    assert int(tpred.draw_sample_rows(torch.Generator().manual_seed(0), 1,
                                      5).max()) == 0
