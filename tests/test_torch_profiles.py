"""Measured route profiles (``core/profiles.py``) in the port against the JAX
package.

The port's copy keeps JAX's file format and its cold-start rules, so:

* under one profile, ``build_plan(route="auto")`` gives every bucket the
  same ``route``, ``tile_n`` and ``n_tiles`` in both packages on the five
  mini families (the structural gates apply under any profile; a profile
  that covers every surviving candidate replaces the analytic costs);
* a file written by either package loads in the other on the host (both
  call the host's device kind ``"cpu"``);
* the load fallbacks — corrupt, missing, stale version, empty cells, wrong
  device kind — give the same ``status()`` (warning text included) and the
  same analytic pricing in both;
* ``route_seconds``, ``unit_seconds`` and ``throughput`` agree on a grid;
* ``microbenchmark(quick=True, device="cpu")`` covers every route with
  positive times (the plain versions on the host; its times are not
  compared with JAX's)."""
import json

import numpy as np
import pytest
import torch

from repro.core import binning as jbinning
from repro.core import plan as jplan_mod
from repro.core import profiles as jprofiles
from repro.sparse import suite as jsuite
from repro_torch.core import binning as tbinning
from repro_torch.core import plan as tplan_mod
from repro_torch.core import profiles as tprofiles
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

FAMILIES = ("mini_er", "mini_pl", "mini_rmat", "mini_band", "mini_fem")
_MINI = dict(jsuite.mini_suite(scale=200))


@pytest.fixture(autouse=True)
def _no_active_profile():
    """Profiles are opt-in module state in both packages: every test starts
    and ends cold."""
    jprofiles.clear()
    tprofiles.clear()
    yield
    jprofiles.clear()
    tprofiles.clear()


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _cell(route, width, span, numeric_s, symbolic_s=0.0, rows=512):
    return dict(route=route, width=width, span=span, rows=rows,
                numeric_s=numeric_s, symbolic_s=symbolic_s)


def _grid(esc, spa, bin_):
    """Cells for every route over widths 4–16384 and spans 64–65536, each
    route's per-row seconds a function of (width, span)."""
    cells = []
    for w in (4, 64, 1024, 16384):
        for s in (64, 1024, 65536):
            for route, f in (("esc", esc), ("spa", spa), ("bin", bin_)):
                cells.append(_cell(route, w, s, f(w, s), 0.1 * f(w, s)))
    return cells


# (name, cells): each flips some buckets away from the analytic choice
PROFILES = {
    "esc_cheap": _grid(lambda w, s: 1e-7 * w, lambda w, s: 1e-6 * w,
                       lambda w, s: 1e-6 * w),
    "spa_cheap": _grid(lambda w, s: 1e-5 * w, lambda w, s: 1e-8 * w,
                       lambda w, s: 1e-6 * w),
    "bin_cheap": _grid(lambda w, s: 1e-5 * w, lambda w, s: 1e-5 * w,
                       lambda w, s: 1e-8 * w),
    "span_bound": _grid(lambda w, s: 2e-9 * w * np.log2(w + 1),
                        lambda w, s: 1e-10 * w * s,
                        lambda w, s: 4e-11 * w * s + 1e-9 * w),
}


def _profiles(cells, kind="cpu", version=None, flops=3e7, bps=9e7):
    doc = dict(version=(jprofiles.PROFILE_VERSION if version is None
                        else version),
               device_kind=kind, flops=flops, bytes_per_s=bps, cells=cells)
    return (jprofiles.RouteProfile.from_json(doc),
            tprofiles.RouteProfile.from_json(doc))


def _routes(plan):
    return [(bk.route, bk.tile_n, bk.n_tiles) for bk in plan.buckets]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_auto_routes_match_jax_under_a_profile(name):
    jp, tp = _profiles(PROFILES[name])
    flipped = 0
    for family in FAMILIES:
        jm = _MINI[family]
        tm = _host(jm)
        analytic = _routes(tbinning.build_plan(tm, tm, route="auto"))
        jprofiles.set_active(jp)
        tprofiles.set_active(tp)
        try:
            want = _routes(jbinning.build_plan(jm, jm, route="auto"))
            got = _routes(tbinning.build_plan(tm, tm, route="auto"))
        finally:
            jprofiles.clear()
            tprofiles.clear()
        assert got == want, family
        flipped += sum(g != a for g, a in zip(got, analytic))
        # forced routes never consult the profile
        tprofiles.set_active(tp)
        assert _routes(tbinning.build_plan(tm, tm, route="esc")) == [
            ("esc", 0, 0)] * len(got)
        tprofiles.clear()
    assert flipped, f"profile {name} changed no bucket's route"


def test_plan_routes_and_stats_match_jax_under_a_profile():
    """A whole plan under an active profile: the same routes by rows, the
    same profile provenance in ``stats()``."""
    jp, tp = _profiles(PROFILES["bin_cheap"])
    jm = _MINI["mini_rmat"]
    tm = _host(jm)
    rows = np.arange(0, jm.nrows, 7)
    jprofiles.set_active(jp)
    tprofiles.set_active(tp)
    jplan = jplan_mod.plan_spgemm(jm, jm, sample_rows=rows)
    tplan = tplan_mod.plan_spgemm(tm, tm, sample_rows=rows, device="cpu")
    assert tplan.stats()["route_rows"] == jplan.stats()["route_rows"]
    assert tplan.stats()["route_rows"]["bin"] > 0
    assert tplan.stats()["route_profile"] == jplan.stats()["route_profile"]
    assert tplan.stats()["route_profile"]["source"] == "measured"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_written_by_either_package_loads_in_the_other(tmp_path,
                                                              writer):
    jp, tp = _profiles(PROFILES["span_bound"])
    path = tmp_path / "prof.json"
    (jprofiles if writer == "jax" else tprofiles).save(
        jp if writer == "jax" else tp, path)
    got = tprofiles.load(path, device="cpu")
    want = jprofiles.load(path)
    assert got is not None and want is not None
    assert got.to_json() == want.to_json() == jp.to_json()
    assert tprofiles.status() == jprofiles.status()
    assert tprofiles.status()["source"] == "measured"
    assert tprofiles.throughput() == jprofiles.throughput() == (3e7, 9e7)


def _write(kind, tmp_path):
    path = tmp_path / f"{kind}.json"
    if kind == "corrupt":
        path.write_text("{not json")
    elif kind == "not_a_dict":
        path.write_text("[]")
    elif kind == "stale":
        jprofiles.save(_profiles(PROFILES["esc_cheap"],
                                 version=jprofiles.PROFILE_VERSION + 1)[0],
                       path)
    elif kind == "empty":
        jprofiles.save(_profiles([])[0], path)
    elif kind == "wrong_device":
        jprofiles.save(_profiles(PROFILES["esc_cheap"],
                                 kind="TPU v5 lite")[0], path)
    return path


@pytest.mark.parametrize("kind", ["corrupt", "not_a_dict", "missing",
                                  "stale", "empty", "wrong_device"])
def test_load_fallbacks_match_jax(tmp_path, kind):
    path = _write(kind, tmp_path)
    # a good profile first: a failed load deactivates it in both
    jp, tp = _profiles(PROFILES["esc_cheap"])
    jprofiles.set_active(jp)
    tprofiles.set_active(tp)
    with pytest.warns(jprofiles.ProfileLoadWarning):
        assert jprofiles.load(path) is None
    with pytest.warns(tprofiles.ProfileLoadWarning):
        assert tprofiles.load(path, device="cpu") is None
    assert tprofiles.active() is None
    st = tprofiles.status()
    assert st == jprofiles.status()
    assert st["source"] == "analytic" and st["warning"]
    assert tprofiles.throughput() == jprofiles.throughput() == (
        tprofiles.ANALYTIC_FLOPS, tprofiles.ANALYTIC_BYTES_PER_S)
    tm = _host(_MINI["mini_er"])
    rp = tplan_mod.plan_spgemm(tm, tm, route="esc",
                               device="cpu").stats()["route_profile"]
    assert rp == st
    # a good load afterwards clears the warning
    good = tmp_path / "good.json"
    tprofiles.save(tp, good)
    assert tprofiles.load(good, device="cpu") is not None
    assert tprofiles.status()["warning"] is None


def test_a_card_profile_does_not_load_on_the_host(tmp_path):
    """The device kind gates a profile: one measured on a card is stale on
    the host (and one measured on the host is stale on a card)."""
    _, tp = _profiles(PROFILES["esc_cheap"], kind="NVIDIA H100 80GB HBM3")
    path = tmp_path / "card.json"
    tprofiles.save(tp, path)
    with pytest.warns(tprofiles.ProfileLoadWarning, match="device kind"):
        assert tprofiles.load(path, device="cpu") is None
    assert tprofiles.device_kind("cpu") == "cpu"


def test_pricing_matches_jax_on_a_grid():
    jp, tp = _profiles(PROFILES["span_bound"] + [_cell("esc", 7, 3, 1e-3)])
    grid = [(w, s) for w in (1, 3, 16, 100, 4096, 70000)
            for s in (1, 50, 1024, 100000)]
    for r in ("esc", "spa", "bin"):
        for w, s in grid:
            assert tp.route_seconds(r, w, s) == jp.route_seconds(r, w, s)
            assert tp.route_seconds(r, w, s, sym_weight=0.5) \
                == jp.route_seconds(r, w, s, sym_weight=0.5)
    partial, tpartial = _profiles([_cell("esc", 64, 64, 1e-6)])
    assert tpartial.route_seconds("bin", 8, 8) is None
    for jprof, tprof in ((None, None), (jp, tp), (partial, tpartial)):
        jprofiles.set_active(jprof)
        tprofiles.set_active(tprof)
        assert tprofiles.throughput() == jprofiles.throughput()
        for r in ("esc", "spa", "bin"):
            for w, s in grid:
                for rows in (0, 1, 300, 123457):
                    assert tprofiles.unit_seconds(r, w, s, rows) \
                        == jprofiles.unit_seconds(r, w, s, rows)
        assert tprofiles.status() == jprofiles.status()


def test_choose_route_matches_jax_on_a_grid():
    """``choose_route`` itself, past the mini families' bounds: structural
    gates, the coverage rule and the measured comparison."""
    for cells in list(PROFILES.values()) + [[_cell("esc", 64, 64, 1e-9)]]:
        jp, tp = _profiles(cells)
        for da, db, ncols, span in ((2, 2, 2000, 64), (12, 12, 2000, 64),
                                    (32, 32, 100_000, 4096),
                                    (128, 128, 100_000, 4096),
                                    (8, 8, 512, 512), (40, 30, 300, 256),
                                    (300, 200, 1_000_000, 1 << 20)):
            for jprof, tprof in ((None, None), (jp, tp)):
                assert tbinning.choose_route(da, db, ncols, span,
                                             profile=tprof) \
                    == jbinning.choose_route(da, db, ncols, span,
                                             profile=jprof)


def test_quick_microbenchmark_on_the_host(tmp_path):
    prof = tprofiles.microbenchmark(quick=True, device="cpu")
    assert prof.version == tprofiles.PROFILE_VERSION
    assert prof.device_kind == "cpu"
    assert {c["route"] for c in prof.cells} == set(tbinning.ROUTES)
    assert len(prof.cells) == 3 * len(tprofiles.QUICK_GRID)
    assert all(c["numeric_s"] > 0 and c["symbolic_s"] > 0
               for c in prof.cells)
    assert prof.flops > 0 and prof.bytes_per_s > 0
    path = tmp_path / "measured.json"
    tprofiles.save(prof, path)
    assert json.loads(path.read_text())["device_kind"] == "cpu"
    loaded = tprofiles.load(path, device="cpu")
    assert loaded is not None and loaded.to_json() == prof.to_json()
    assert tprofiles.status()["source"] == "measured"
    # and the JAX package reads it as its own host profile
    assert jprofiles.load(path, activate=False).to_json() == prof.to_json()
