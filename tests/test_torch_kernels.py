"""The port's three kernels against the JAX package's Pallas kernels (run in
interpret mode, as tests/test_kernels.py runs them) and against its jnp
twins, on tiny inputs.  On the CPU each wrapper runs its plain version;
the CUDA kernels themselves are held against those plain versions on a card
by tests/test_torch_cuda.py and by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import spgemm as jspgemm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import random as jrand
from repro_torch import convert
from repro_torch.core.errors import PlanMismatchError
from repro_torch.kernels import flop_per_row as tflop_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spgemm_numeric as tnum_k
from repro_torch.kernels import spgemm_symbolic as tsym_k

torch.set_num_threads(1)

VAL_RTOL = 1e-5      # run sums are taken in another order
VAL_ATOL_REL = 1e-6  # × the row's largest |value|


def _pair(a, b, extra=3):
    """The same operands on both sides: JAX device CSRs (capacity-padded)
    and the port's CSRDevice built from their numpy arrays."""
    ja = jcsr.to_device(a, capacity=a.nnz + extra)
    jb = jcsr.to_device(b, capacity=b.nnz + extra)
    conv = lambda d: convert.csr_device_from_numpy(
        np.asarray(d.rpt), np.asarray(d.col), np.asarray(d.val), d.shape,
        device="cpu")
    return ja, jb, conv(ja), conv(jb)


def _operands(seed):
    a = jrand.power_law(120, 100, 3, 1.6, seed=seed)
    b = jrand.erdos_renyi(100, 90, 3, seed=seed + 1)
    return a, b


def _assert_vals_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    vmax = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want)
            <= VAL_RTOL * np.abs(want) + VAL_ATOL_REL * vmax).all()


@pytest.mark.parametrize("seed,narrow", [(41, False), (43, True)])
def test_flop_rows_matches_pallas_and_jnp(seed, narrow):
    a, b = _operands(seed)
    ja, jb, ta, tb = _pair(a, b)
    deg = np.diff(a.rpt)
    rows = np.flatnonzero(deg <= 2) if narrow else np.arange(a.nrows)
    rows = rows.astype(np.int32)[:256]
    da = int(deg[rows].max())
    want_pallas = jops.flop_rows(ja, jb, jnp.asarray(rows), max_deg_a=da,
                                 block_rows=32)
    want_jnp = jref.flop_rows_ref(ja, jb, jnp.asarray(rows))
    got = tflop_k.flop_rows(ta, torch.diff(tb.rpt), torch.from_numpy(rows),
                            max_deg_a=da)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jnp))
    np.testing.assert_array_equal(
        tref.flop_rows_ref(ta, tb, torch.from_numpy(rows)).numpy(),
        got.numpy())


def test_fused_flop_symbolic_matches_pallas_and_jnp():
    samples = 37            # not a multiple of the Pallas block: padded rows
    a, b = _operands(51)
    ja, jb, ta, tb = _pair(a, b)
    rows = np.random.default_rng(samples).integers(
        0, a.nrows, samples).astype(np.int32)
    da = int(np.diff(a.rpt)[rows].max())
    db = int(b.row_nnz.max())
    zp, fp, flp = jops.fused_flop_symbolic(ja, jb, jnp.asarray(rows), da, db,
                                           block_samples=8)
    zr, fr, flr = jref.fused_flop_symbolic_ref(ja, jb, jnp.asarray(rows), da,
                                               db)
    z, f, fl = tsym_k.fused_flop_symbolic(ta, tb, torch.from_numpy(rows),
                                          max_deg_a=da, max_deg_b=db)
    assert (int(z), int(f)) == (int(zp), int(fp)) == (int(zr), int(fr))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(flp))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(flr))
    zt, ft, flt = tref.fused_flop_symbolic_ref(ta, tb, torch.from_numpy(rows),
                                               da, db)
    assert (int(zt), int(ft)) == (int(z), int(f))
    np.testing.assert_array_equal(flt.numpy(), fl.numpy())


@pytest.mark.parametrize("row_capacity", [4, 16])
def test_spgemm_numeric_matches_pallas_and_jnp(row_capacity):
    a = jrand.erdos_renyi(100, 100, 3, seed=61)
    b = jrand.erdos_renyi(100, 90, 3, seed=62)
    a.val[:] = np.random.default_rng(1).standard_normal(a.nnz)
    b.val[:] = np.random.default_rng(2).standard_normal(b.nnz)
    ja, jb, ta, tb = _pair(a, b)
    rows = np.arange(0, 64, dtype=np.int32)
    da = int(np.diff(a.rpt)[rows].max())
    db = int(b.row_nnz.max())
    want = jops.spgemm_numeric(ja, jb, jnp.asarray(rows), max_deg_a=da,
                               max_deg_b=db, row_capacity=row_capacity,
                               block_rows=8)
    twin = jspgemm.spgemm_rows(ja, jb, jnp.asarray(rows),
                               row_capacity=row_capacity, max_deg_a=da,
                               max_deg_b=db, block_rows=16)
    got = tnum_k.spgemm_numeric(ta, tb, torch.from_numpy(rows), max_deg_a=da,
                                max_deg_b=db, row_capacity=row_capacity)
    for ref in (want, twin):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        assert int(got[3]) == int(ref[3])
        _assert_vals_close(got[1].numpy(), ref[1])
    if row_capacity == 4:
        assert int(got[3]) > 0      # the small capacity truly truncates
    oracle = tref.spgemm_numeric_ref(ta, tb, torch.from_numpy(rows), da, db,
                                     row_capacity)
    np.testing.assert_array_equal(oracle[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("route", ["spa", "bin", "nope"])
def test_ops_refuse_unported_and_unknown_routes(route):
    a, b = _operands(71)
    _, _, ta, tb = _pair(a, b)
    rows = torch.arange(4, dtype=torch.int32)
    with pytest.raises(PlanMismatchError):
        tops.fused_flop_symbolic_routed(ta, tb, rows, max_deg_a=4,
                                        max_deg_b=4, route=route)
    with pytest.raises(PlanMismatchError):
        tops.spgemm_numeric_routed(ta, tb, rows, max_deg_a=4, max_deg_b=4,
                                   row_capacity=8, route=route)


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor that lies neither on the CPU nor on a CUDA card gets no
    plain fallback: the wrappers raise."""
    a, b = _operands(81)
    _, _, ta, tb = _pair(a, b)
    meta = lambda d: type(d)(rpt=d.rpt.to("meta"), col=d.col.to("meta"),
                             val=d.val.to("meta"), shape=d.shape)
    ma, mb = meta(ta), meta(tb)
    rows = torch.arange(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        tflop_k.flop_rows(ma, torch.diff(mb.rpt), rows, max_deg_a=4)
    with pytest.raises(RuntimeError):
        tsym_k.fused_flop_symbolic(ma, mb, rows, max_deg_a=4, max_deg_b=4)
    with pytest.raises(RuntimeError):
        tnum_k.spgemm_numeric(ma, mb, rows, max_deg_a=4, max_deg_b=4,
                              row_capacity=8)
