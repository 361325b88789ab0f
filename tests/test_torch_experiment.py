"""Parity of the port's accuracy experiment (the paper's Section VI), its
host oracles and its quickstart flow with the JAX package.

The port takes z*, f* and F from its kernels (their plain versions on the
CPU) and the rest from the same host float64 arithmetic as the JAX package,
so on equal integers every field of a case is equal.  The 75-case subset
itself runs on the card (``chip_smoke.py``); here three small
dimension-matched pairs stand in for it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import experiment as jexp
from repro.core import oracle as joracle
from repro.core import predictor as jpred
from repro.core import spgemm as jspgemm
from repro.sparse import formats as jformats
from repro.sparse import random as jrand
from repro_torch import quickstart
from repro_torch.core import experiment as texp
from repro_torch.core import oracle as toracle
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)


def _host(jm):
    """The port's host CSR of a JAX-package one (the same arrays)."""
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _pairs():
    """Three small pairs from the generators, reshaped by JAX's
    match_dims (the paper's rule) as the experiment reshapes suite pairs."""
    specs = [
        (jrand.erdos_renyi(2400, 2400, 4, seed=1),
         jrand.banded(1800, 1800, 10, 12, seed=2)),
        (jrand.power_law(2000, 2000, 5, 1.6, seed=3),
         jrand.rmat(2500, 2500, 12_000, seed=4)),
        (jrand.banded(2200, 2200, 16, 20, seed=5),
         jrand.erdos_renyi(2600, 2600, 3, seed=6)),
    ]
    return [jformats.match_dims(a, b) for a, b in specs]


_PAIRS = _pairs()


def test_subset_pairs_match_jax():
    assert texp.subset_pairs() == jexp.subset_pairs()
    assert len(texp.subset_pairs()) == 75


@pytest.mark.parametrize("seed", [0, 7, 2022 + 311])
def test_hash01_matches_jax(seed):
    keys = np.random.default_rng(seed).integers(0, 1 << 40, 5000,
                                                dtype=np.int64)
    np.testing.assert_array_equal(toracle._hash01(keys, seed),
                                  joracle._hash01(keys, seed))
    assert toracle._MERSENNE == joracle._MERSENNE


@pytest.mark.parametrize("i", range(3))
def test_run_case_matches_jax_field_for_field(i):
    ja, jb = _PAIRS[i]
    seed = 2022 + 17 * i
    want = jexp.run_case(ja, jb, seed=seed)
    got = texp.run_case(_host(ja), _host(jb), seed=seed, device="cpu")
    assert got == want


def test_aggregate_matches_jax():
    seeds = [2022 + 17 * i for i in range(3)]
    want = [jexp.run_case(a, b, seed=s) for (a, b), s in zip(_PAIRS, seeds)]
    got = [texp.run_case(_host(a), _host(b), seed=s, device="cpu")
           for (a, b), s in zip(_PAIRS, seeds)]
    assert texp.aggregate(got) == jexp.aggregate(want)


def test_sampled_counts_equal_the_host_oracles():
    """The kernels' z*, f* and F at global bounds are the host oracle's
    exact sampled NNZ, the sampled rows' FLOP and the total FLOP."""
    ja, jb = _PAIRS[1]
    a, b = _host(ja), _host(jb)
    rows = toracle.sample_rows(a.nrows, seed=5)
    floprc, total = toracle.flop_per_row(a, b)
    assert texp.sampled_counts(a, b, rows, device="cpu") == (
        toracle.exact_sampled_nnz(a, b, rows), int(floprc[rows].sum()),
        total)


@pytest.mark.parametrize("method", ["proposed_predict", "reference_predict",
                                    "minhash_predict"])
def test_host_predictors_match_jax(method):
    ja, jb = _PAIRS[0]
    want = getattr(joracle, method)(ja, jb, seed=3)
    got = getattr(toracle, method)(_host(ja), _host(jb), seed=3)
    for f in ("nnz_total", "compression_ratio", "sampled_flop",
              "sampled_nnz", "sample_num", "total_flop"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.structure, want.structure)
    rows = toracle.sample_rows(ja.nrows, 3)
    assert toracle.exact_sampled_nnz(_host(ja), _host(jb), rows) == \
        joracle.exact_sampled_nnz(ja, jb, rows)


def test_run_all_writes_only_where_told(tmp_path, monkeypatch):
    """``run_all`` returns the sweep and writes it only to a path the
    caller names (here over a two-matrix stand-in for the suite)."""
    from repro_torch.sparse import suite as tsuite
    mats = {"x": _host(_PAIRS[0][0]), "y": _host(_PAIRS[2][1])}
    monkeypatch.setattr(tsuite, "get_matrix", mats.__getitem__)
    res = texp.run_all(names=["x", "y"], verbose=False, device="cpu")
    assert res["aggregate"]["n_cases"] == 4 and not any(tmp_path.iterdir())
    out = tmp_path / "sweep.json"
    texp.run_all(names=["x", "y"], out_path=str(out), verbose=False,
                 device="cpu")
    assert out.exists() and [p.name for p in tmp_path.iterdir()] == [
        "sweep.json"]


def test_quickstart_flow_matches_jax():
    """The quickstart at a reduced size with explicit sample rows: its
    prediction, allocation and numeric phase equal the JAX package's
    quickstart flow on the same rows."""
    n = 600
    a = jrand.banded(n, n, 40, 30, seed=0)
    rows = np.random.default_rng(9).integers(0, n, 12).astype(np.int32)
    lines = []
    got = quickstart.run(n, device="cpu", rows=rows, out=lines.append)
    assert lines[-1].startswith("OK")
    ad = jcsr.to_device(a)
    mda = int(a.row_nnz.max())
    jrows = jnp.asarray(rows)
    jp = jpred.proposed_predict(ad, ad, jrows, mda, mda)
    jr = jpred.reference_predict(ad, ad, jrows, mda, mda)
    for tp, wp in ((got["pred"], jp), (got["ref"], jr)):
        assert int(tp.sampled_nnz) == int(wp.sampled_nnz)
        assert int(tp.sampled_flop) == int(wp.sampled_flop)
        np.testing.assert_array_max_ulp(tp.nnz_total.numpy(),
                                        np.asarray(wp.nnz_total), maxulp=1)
    flopr, _ = joracle.flop_per_row(a, a)
    plan = jpred.AllocationPlan.from_prediction(np.asarray(jp.structure),
                                                flopr, safety=1.5)
    assert (got["plan"].row_capacity, got["plan"].total_capacity) == \
        (plan.row_capacity, plan.total_capacity)
    want = jspgemm.spgemm(ad, ad, row_capacity=plan.row_capacity,
                          max_deg_a=mda, max_deg_b=mda)
    np.testing.assert_array_equal(got["out"].col.numpy(),
                                  np.asarray(want.col))
    np.testing.assert_array_equal(got["out"].row_nnz.numpy(),
                                  np.asarray(want.row_nnz))
    assert int(got["out"].overflow) == int(want.overflow) == 0
