"""Parity of the port's substrate with the JAX package: the copied host
modules (sparse generators, oracle, binning, validation), the device CSR,
the shared product gather, Algorithm 1, the numpy converters, and the rule
that entry points run on the CUDA card unless the CPU is asked for."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binning as jbinning
from repro.core import csr as jcsr
from repro.core import flop as jflop
from repro.core import oracle as joracle
from repro.core import profiles as jprofiles
from repro.sparse import random as jrand
from repro.sparse import suite as jsuite
from repro_torch import convert
from repro_torch.core import binning as tbinning
from repro_torch.core import csr as tcsr
from repro_torch.core import flop as tflop
from repro_torch.core import oracle as toracle
from repro_torch.core import plan as tplan
from repro_torch.core import validate as tvalidate
from repro_torch.core.errors import OperandValidationError, PlanMismatchError
from repro_torch.sparse import formats as tformats
from repro_torch.sparse import suite as tsuite

torch.set_num_threads(1)

FAMILIES = ("mini_er", "mini_pl", "mini_rmat", "mini_band", "mini_fem")
_MINI = dict(jsuite.mini_suite(scale=200))


def _host(jm):
    """The port's host CSR holding the same arrays as a JAX-side one."""
    return tformats.CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _dev(jd):
    return convert.csr_device_from_numpy(np.asarray(jd.rpt),
                                         np.asarray(jd.col),
                                         np.asarray(jd.val), jd.shape,
                                         device="cpu")


@pytest.fixture
def no_route_profile():
    """JAX's auto routing consults a process-wide measured profile; the
    port's copy is the analytic model, so compare with none active."""
    prev = jprofiles.active()
    jprofiles.set_active(None)
    yield
    jprofiles.set_active(prev)


@pytest.mark.parametrize("family", FAMILIES)
def test_suite_copy_builds_identical_matrices(family):
    tm = dict(tsuite.mini_suite(scale=200))[family]
    jm = _MINI[family]
    assert tm.shape == jm.shape
    np.testing.assert_array_equal(tm.rpt, jm.rpt)
    np.testing.assert_array_equal(tm.col, jm.col)
    np.testing.assert_array_equal(tm.val, jm.val)


@pytest.mark.parametrize("family", FAMILIES)
def test_oracle_copy_matches(family):
    jm = _MINI[family]
    tm = _host(jm)
    f_t, tot_t = toracle.flop_per_row(tm, tm)
    f_j, tot_j = joracle.flop_per_row(jm, jm)
    np.testing.assert_array_equal(f_t, f_j)
    assert tot_t == tot_j
    s_t, n_t = toracle.exact_structure(tm, tm, chunk_flop=1 << 12)
    s_j, n_j = joracle.exact_structure(jm, jm)
    np.testing.assert_array_equal(s_t, s_j)
    assert n_t == n_j
    np.testing.assert_array_equal(toracle.sample_rows(jm.nrows, 7),
                                  joracle.sample_rows(jm.nrows, 7))


@pytest.mark.parametrize("route", ["esc", "auto", "spa", "bin"])
@pytest.mark.parametrize("family", FAMILIES)
def test_build_plan_copy_matches(family, route, no_route_profile):
    jm = _MINI[family]
    tm = _host(jm)
    jp = jbinning.build_plan(jm, jm, route=route)
    tp = tbinning.build_plan(tm, tm, route=route)
    assert (tp.nrows, tp.global_deg_a, tp.global_deg_b) == \
        (jp.nrows, jp.global_deg_a, jp.global_deg_b)
    np.testing.assert_array_equal(tp.row_bucket, jp.row_bucket)
    assert len(tp.buckets) == len(jp.buckets)
    for bt, bj in zip(tp.buckets, jp.buckets):
        np.testing.assert_array_equal(bt.rows, bj.rows)
        assert bt.signature == bj.signature
        assert (bt.n_tiles, bt.block_rows) == (bj.n_tiles, bj.block_rows)
    assert tp.stats() == jp.stats()


def test_binning_plan_from_numpy_rebuilds_the_jax_plan():
    jm = _MINI["mini_pl"]
    jp = jbinning.build_plan(jm, jm, route="esc")
    tp = convert.binning_plan_from_numpy(
        [dict(rows=np.asarray(b.rows), deg_a=b.deg_a, deg_b=b.deg_b,
              block_rows=b.block_rows, route=b.route, tile_n=b.tile_n,
              n_tiles=b.n_tiles, span=b.span) for b in jp.buckets],
        global_deg_a=jp.global_deg_a, global_deg_b=jp.global_deg_b)
    np.testing.assert_array_equal(tp.row_bucket, jp.row_bucket)
    np.testing.assert_array_equal(tp.inverse_perm(), jp.inverse_perm())
    assert tp.stats() == jp.stats()
    rows = joracle.sample_rows(jm.nrows, 3)
    for st, sj in zip(tp.subset(rows), jp.subset(rows)):
        np.testing.assert_array_equal(st, sj)


def test_to_device_pads_and_round_trips():
    jm = _MINI["mini_band"]
    tm = _host(jm)
    cap = tm.nnz + 13
    td = tcsr.to_device(tm, capacity=cap, device="cpu")
    jd = jcsr.to_device(jm, capacity=cap)
    assert td.capacity == cap and td.rpt.dtype == torch.int32
    np.testing.assert_array_equal(td.col.numpy(), np.asarray(jd.col))
    np.testing.assert_array_equal(td.val.numpy(), np.asarray(jd.val))
    assert (td.col[tm.nnz:] == tcsr.COL_SENTINEL).all()
    back = tcsr.to_host(td)
    np.testing.assert_array_equal(back.rpt, tm.rpt)
    np.testing.assert_array_equal(back.col, tm.col)
    with pytest.raises(PlanMismatchError):
        tcsr.to_device(tm, capacity=tm.nnz - 1, device="cpu")


@pytest.mark.parametrize("with_values", [False, True])
def test_expand_products_matches_jax(with_values):
    a = jrand.power_law(150, 120, 4, 1.6, seed=21)
    b = jrand.erdos_renyi(120, 90, 5, seed=22)
    ja, jb = jcsr.to_device(a, capacity=a.nnz + 5), jcsr.to_device(b)
    ta, tb = _dev(ja), _dev(jb)
    rows = np.array([0, 7, 7, 149, 33, 64], dtype=np.int32)
    da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
    jc, jv, jval = jcsr.expand_products(ja, jb, jnp.asarray(rows), da, db,
                                        with_values=with_values)
    tc, tv, tval = tcsr.expand_products(ta, tb, torch.from_numpy(rows), da,
                                        db, with_values=with_values)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    if with_values:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,multiple", [(5, 8), (8, 8), (9, 4), (1, 16)])
def test_pad_row_ids_repeats_the_last_row(n, multiple):
    rows = np.arange(3, 3 + n, dtype=np.int32)
    got = tcsr.pad_row_ids(torch.from_numpy(rows), multiple)
    want = jcsr.pad_row_ids(jnp.asarray(rows), multiple)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", ["mini_pl", "mini_fem"])
def test_flop_per_row_matches_jax(family):
    jm = _MINI[family]
    jd = jcsr.to_device(jm, capacity=jm.nnz + 7)
    f_j, tot_j = jflop.flop_per_row(jd, jd)
    f_t, tot_t = tflop.flop_per_row(_dev(jd), _dev(jd))
    assert f_t.dtype == torch.int32
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert int(tot_t) == int(tot_j)


def test_validate_copy_raises_the_ports_error():
    good = _host(_MINI["mini_er"])
    tvalidate.validate_pair(good, good)
    bad = tformats.CSR(rpt=good.rpt, col=good.col.copy(), val=good.val,
                       shape=good.shape)
    bad.col[1] = good.ncols + 4
    with pytest.raises(OperandValidationError) as e:
        tvalidate.validate_csr(bad, name="a")
    assert e.value.context["field"] == "col"
    with pytest.raises(OperandValidationError):
        tformats.CSR.from_coo(np.array([0]), np.array([9]), None, (2, 3))


def test_entry_points_raise_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _host(_MINI["mini_er"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcsr.to_device(m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplan.plan_spgemm(m, m, route="esc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.csr_device_from_numpy(m.rpt, m.col, m.val, m.shape)
    assert tcsr.to_device(m, device="cpu").device.type == "cpu"
