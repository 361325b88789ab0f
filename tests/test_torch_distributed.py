"""Distributed plans in the port (``plan_spgemm(mesh=..., num_shards=...)``)
against the JAX package, on the families of ``tests/test_distributed.py``.

* Planning without devices (``num_shards=4``): the partition bounds, every
  bucket's shard table (``table``, ``valid``, ``capacity``), the per-shard
  capacities, the executor key and, at ``n_panels=2``, the panel gather's
  arrays and ``comm_stats`` equal JAX's exactly.
* A one-shard mesh against JAX's ``jax.make_mesh((1,), ("data",))``
  in-process: ``rpt``, ``col``, every bucket's ``row_nnz`` block and
  ``shard_overflow`` exactly, ``val`` within rtol 1e-5 plus 1e-6 × the
  row's largest |value|.
* A four-shard mesh of CPU devices: whole-B and panels equal the port's
  single-device run bit for bit and JAX's single-device run to the
  contract above; re-planning at ``safety=0`` re-runs exactly the
  overflowing units; the plan cache serves a revalued pair with no new
  executor.
* The mesh itself: ``make_mesh``'s checks and its executor-key
  fingerprint.

On the CPU ``use_kernel`` runs the kernel wrappers' plain versions."""
import functools

import numpy as np
import pytest
import torch

from repro.core import plan as jplan_mod
from repro.sparse import random as sprand
from repro_torch.core import plan as tplan_mod
from repro_torch.core.errors import PlanMismatchError
from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.sparse.formats import CSR, spgemm_dense_oracle

torch.set_num_threads(1)

VAL_RTOL = 1e-5
VAL_ATOL_REL = 1e-6

FAMILIES = {
    "er": (sprand.erdos_renyi(500, 500, 4, seed=25),
           sprand.erdos_renyi(500, 500, 3, seed=26)),
    "pl": (sprand.power_law(700, 700, 5, 1.5, seed=21),
           sprand.power_law(700, 700, 4, 1.6, seed=22)),
    "rmat": (sprand.rmat(500, 500, 2500, seed=31),
             sprand.rmat(500, 500, 2000, seed=32)),
    "band": (sprand.banded(600, 600, 18, 16, seed=5),
             sprand.banded(600, 600, 12, 20, seed=6)),
    "fem": (sprand.banded(400, 400, 40, 30, seed=51),
            sprand.banded(400, 400, 32, 28, seed=52)),
}
NAMES = sorted(FAMILIES)
MESH4 = make_mesh((4,), ("data",), devices=["cpu"] * 4)


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _pair(family):
    a, b = FAMILIES[family]
    return _host(a), _host(b)


def _bitwise(c, want):
    np.testing.assert_array_equal(c.rpt, want.rpt)
    np.testing.assert_array_equal(c.col, want.col)
    np.testing.assert_array_equal(c.val.view(np.int32),
                                  want.val.view(np.int32))


def _close(c, want):
    """rpt/col exactly, val within rtol plus atol × the row's max |val|."""
    np.testing.assert_array_equal(c.rpt, want.rpt)
    np.testing.assert_array_equal(c.col, want.col)
    lens = np.diff(want.rpt)
    vmax = np.zeros(want.nrows, dtype=np.float32)
    if want.nnz:
        vmax[lens > 0] = np.maximum.reduceat(np.abs(want.val),
                                             want.rpt[:-1][lens > 0])
    tol = VAL_RTOL * np.abs(want.val) + VAL_ATOL_REL * np.repeat(vmax, lens)
    assert (np.abs(c.val - want.val) <= tol).all()


@functools.lru_cache(maxsize=None)
def _jax_single(family):
    """JAX's single-device product on the default sample rows."""
    a, b = FAMILIES[family]
    p = jplan_mod.plan_spgemm(a, b, safety=2.0)
    return jplan_mod.reassemble(p, jplan_mod.execute(p, a, b))


@functools.lru_cache(maxsize=None)
def _port_single(family):
    a, b = _pair(family)
    p = tplan_mod.plan_spgemm(a, b, safety=2.0, device="cpu")
    return tplan_mod.reassemble(p, tplan_mod.execute(p, a, b))


@pytest.mark.parametrize("pop_quant", [False, True])
@pytest.mark.parametrize("n_panels", [0, 2])
@pytest.mark.parametrize("family", NAMES)
def test_shard_tables_match_jax(family, n_panels, pop_quant):
    a, b = FAMILIES[family]
    jp = jplan_mod.plan_spgemm(a, b, num_shards=4, safety=1.3,
                               n_panels=n_panels, pop_quant=pop_quant)
    tp = tplan_mod.plan_spgemm(_host(a), _host(b), num_shards=4, safety=1.3,
                               n_panels=n_panels, pop_quant=pop_quant,
                               device="cpu")
    assert tp.distributed and tp.num_shards == jp.num_shards == 4
    np.testing.assert_array_equal(np.asarray(tp.partition.bounds),
                                  np.asarray(jp.partition.bounds))
    assert len(tp.shard_tables) == len(jp.shard_tables)
    for t, jt in zip(tp.shard_tables, jp.shard_tables):
        np.testing.assert_array_equal(t.table, jt.table)
        np.testing.assert_array_equal(t.valid, jt.valid)
        assert t.capacity == jt.capacity and t.rows_pb == jt.rows_pb
    np.testing.assert_array_equal(tp.shard_capacities, jp.shard_capacities)
    assert tp.key == jp.key
    assert tp.shard_slots() == jp.shard_slots()
    if n_panels:
        assert tp.row_shards == jp.row_shards == 2
        np.testing.assert_array_equal(tp.panel_caps, jp.panel_caps)
        g, jg = tp._panel_gather, jp._panel_gather
        assert (g.nref, g.ecap) == (jg.nref, jg.ecap)
        for f in ("a_col", "g_rpt", "g_col", "g_idx", "ref_nnz"):
            np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
        assert tp.comm_stats() == jp.comm_stats()
    st, jst = tp.stats(), jp.stats()
    for k in ("num_shards", "imbalance", "shard_slots",
              "bucket_rows_per_shard", "shard_bucket_capacities"):
        assert st[k] == jst[k]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", NAMES)
def test_one_shard_mesh_matches_jax(family, use_kernel):
    import jax
    a, b = FAMILIES[family]
    jp = jplan_mod.plan_spgemm(a, b, mesh=jax.make_mesh((1,), ("data",)),
                               safety=2.0)
    jout = jplan_mod.execute(jp, a, b)
    tp = tplan_mod.plan_spgemm(
        _host(a), _host(b), safety=2.0, use_kernel=use_kernel,
        mesh=make_mesh((1,), ("data",), devices=["cpu"]))
    tout = tplan_mod.execute(tp, _host(a), _host(b))
    # the same key but the use_kernel flag at index 3
    assert tp.key[:3] + tp.key[4:] == jp.key[:3] + jp.key[4:]
    np.testing.assert_array_equal(tout.shard_overflow,
                                  np.asarray(jout.shard_overflow))
    for n, jn in zip(tout.row_nnz, jout.row_nnz):
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    _close(tplan_mod.reassemble(tp, tout), jplan_mod.reassemble(jp, jout))


@pytest.mark.parametrize("n_panels", [0, 2])
@pytest.mark.parametrize("family", NAMES)
def test_four_shard_cpu_mesh_is_the_single_device_run(family, n_panels):
    a, b = _pair(family)
    p = tplan_mod.plan_spgemm(a, b, mesh=MESH4, safety=2.0,
                              n_panels=n_panels)
    assert p.device == torch.device("cpu")
    out = tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
    assert isinstance(out, tplan_mod.DistSpgemmOut)
    assert out.cols[0].shape[0] == 4 and int(out.shard_overflow.sum()) == 0
    c = tplan_mod.reassemble(p, out)
    _bitwise(c, _port_single(family))
    _close(c, _jax_single(family))
    np.testing.assert_allclose(c.to_dense(), spgemm_dense_oracle(a, b),
                               rtol=1e-4, atol=1e-4)


def _true_need(family):
    """Each row's true output nnz (an ample single-device run)."""
    a, b = _pair(family)
    p = tplan_mod.plan_spgemm(a, b, safety=64.0, device="cpu")
    out = tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
    assert int(out.overflow) == 0
    return out.row_nnz.numpy().astype(np.int64), tplan_mod.reassemble(p, out)


@pytest.mark.parametrize("n_panels", [0, 2])
@pytest.mark.parametrize("family", NAMES)
def test_replan_dist_reruns_only_overflowing_units(family, n_panels):
    """``tests/test_replan.py``'s distributed pin on four CPU shards: at
    ``safety=0`` with ``retry_safety=1.5`` exactly the buckets whose true
    need passed their shard capacity re-run (whole-B: a bucket over every
    shard; panels: a (bucket × panel) unit), and the product is the ample
    run's; the bumped plan then runs without a retry."""
    a, b = _pair(family)
    need, want = _true_need(family)
    p = tplan_mod.plan_spgemm(a, b, mesh=MESH4, safety=0.0,
                              retry_safety=1.5, n_panels=n_panels)
    caps0 = [t.capacity for t in p.shard_tables]
    cache = tplan_mod.PlanCache()
    out = tplan_mod.execute(p, a, b, cache=cache)
    c = tplan_mod.reassemble(p, out)
    _bitwise(c, want)
    if not n_panels:
        over = {i for i, bk in enumerate(p.binning.buckets)
                if bk.n_rows and need[bk.rows].max() > caps0[i]}
        got = {e["bucket"] for e in p.retry_events}
    else:
        nnz = [n.numpy() for n in out.row_nnz]
        over = {(i, q) for i, t in enumerate(p.shard_tables)
                for q in range(n_panels)
                if np.where(t.valid[q::n_panels], nnz[i][q::n_panels],
                            0).max() > caps0[i]}
        got = {(e["bucket"], e["panel"]) for e in p.retry_events}
    assert over and got == over and p.retries >= 1
    builds = cache.traces
    again = tplan_mod.execute(p, a, b, cache=cache)
    assert p.retry_events == [] and int(again.shard_overflow.sum()) == 0
    _bitwise(tplan_mod.reassemble(p, again), want)
    assert cache.traces == builds + 1     # the bumped plan's one new key


def _revalue(m, seed):
    rng = np.random.default_rng(seed)
    return CSR(rpt=m.rpt.copy(), col=m.col.copy(),
               val=rng.standard_normal(m.nnz).astype(np.float32),
               shape=m.shape)


@pytest.mark.parametrize("n_panels", [0, 2])
def test_plan_cache_serves_a_revalued_pair(n_panels):
    """``tests/test_distributed.py``'s serving contract: a pair of the same
    structure and new values keeps the plan key and builds no executor."""
    a, b = _pair("band")
    cache = tplan_mod.PlanCache()
    p1 = tplan_mod.plan_spgemm(a, b, mesh=MESH4, safety=2.0,
                               n_panels=n_panels)
    tplan_mod.execute(p1, a, b, cache=cache)
    builds = cache.traces
    a2, b2 = _revalue(a, 91), _revalue(b, 92)
    p2 = tplan_mod.plan_spgemm(a2, b2, mesh=MESH4, safety=2.0,
                               n_panels=n_panels)
    assert p2.key == p1.key
    c2 = tplan_mod.reassemble(p2, tplan_mod.execute(p2, a2, b2, cache=cache))
    assert cache.traces == builds and cache.hits >= 1
    np.testing.assert_allclose(c2.to_dense(), spgemm_dense_oracle(a2, b2),
                               rtol=1e-4, atol=1e-4)


def test_num_shards_plans_without_devices_and_runs_on_a_mesh():
    """``num_shards`` alone plans without a mesh; ``execute`` then takes
    one (and refuses to run without)."""
    a, b = _pair("pl")
    p = tplan_mod.plan_spgemm(a, b, num_shards=4, safety=2.0, device="cpu")
    assert p.mesh is None
    with pytest.raises(PlanMismatchError, match="needs a mesh"):
        tplan_mod.execute(p, a, b)
    c = tplan_mod.reassemble(p, tplan_mod.execute(p, a, b, mesh=MESH4))
    _bitwise(c, _port_single("pl"))


def test_make_mesh():
    m = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    assert isinstance(m, Mesh) and m.shape["data"] == 4 == len(m.devices)
    assert m.axis_names == ("data",) and m.distinct_devices() == [
        torch.device("cpu")]
    # a repeated-device mesh never shares an executor key with one whose
    # positions are distinct devices
    one = Mesh([torch.device("cuda", 0)] * 4)
    four = Mesh([torch.device("cuda", i) for i in range(4)])
    assert one.key() != four.key() and one.key() != m.key()
    with pytest.raises(PlanMismatchError):
        make_mesh((2,), ("data",), devices=["cpu"])
    with pytest.raises(PlanMismatchError):
        make_mesh((2, 2), ("x", "y"), devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(PlanMismatchError, match="CUDA cards"):
            make_mesh((1,), ("data",))
    a, b = _pair("er")
    with pytest.raises(PlanMismatchError) as err:
        tplan_mod.plan_spgemm(a, b, mesh=m, axis="model")
    assert err.value.context["field"] == "mesh"
