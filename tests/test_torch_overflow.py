"""The overflow error of ``reassemble`` against the JAX package's.

An R-MAT 512×512 · 512×4096 product planned at ``safety=1.3`` from 40
fixed sample rows drops entries for capacity.  Each package plans and
executes its own; the ``CapacityExhaustedError`` that ``reassemble``
raises must carry JAX's message and ``context`` for a single-device
output, a column-panel output and a distributed output (a one-shard mesh
in each package), and ``on_overflow="ignore"`` returns the truncated
matrix in both.  On the CPU ``use_kernel`` runs the kernel wrappers'
plain versions."""
import numpy as np
import pytest
import torch

from repro.core import errors as jerrors
from repro.core import plan as jplan_mod
from repro.sparse import random as sprand
from repro_torch.core import errors as terrors
from repro_torch.core import plan as tplan_mod
from repro_torch.core.mesh import make_mesh
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

A = sprand.rmat(512, 512, 2048, seed=3)
B = sprand.rmat(512, 4096, 4096, seed=4)
ROWS = np.random.default_rng(0).choice(512, 40, replace=False).astype(np.int64)


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _jax_run(kind):
    kw = dict(safety=1.3, sample_rows=ROWS)
    if kind == "panels":
        kw["n_panels"] = 3
    if kind == "mesh":
        import jax
        kw["mesh"] = jax.make_mesh((1,), ("data",))
    p = jplan_mod.plan_spgemm(A, B, **kw)
    return p, jplan_mod.execute(p, A, B)


def _port_run(kind):
    a, b = _host(A), _host(B)
    kw = dict(safety=1.3, sample_rows=ROWS, use_kernel=True)
    if kind == "panels":
        kw["n_panels"] = 3
    if kind == "mesh":
        kw["mesh"] = make_mesh((1,), ("data",), devices=["cpu"])
    else:
        kw["device"] = "cpu"
    p = tplan_mod.plan_spgemm(a, b, **kw)
    return p, tplan_mod.execute(p, a, b)


@pytest.mark.parametrize("kind", ["local", "panels", "mesh"])
def test_overflow_error_matches_jax(kind):
    jp, jout = _jax_run(kind)
    tp, tout = _port_run(kind)
    with pytest.raises(jerrors.CapacityExhaustedError) as jexc:
        jplan_mod.reassemble(jp, jout)
    with pytest.raises(terrors.CapacityExhaustedError) as texc:
        tplan_mod.reassemble(tp, tout)
    assert jexc.value.context["observed"] > 0
    assert str(texc.value) == str(jexc.value)
    assert texc.value.context == jexc.value.context
    assert "per shard: [" in str(texc.value)
    got = tplan_mod.reassemble(tp, tout, on_overflow="ignore")
    want = jplan_mod.reassemble(jp, jout, on_overflow="ignore")
    np.testing.assert_array_equal(got.rpt, want.rpt)
    np.testing.assert_array_equal(got.col, want.col)
    with pytest.raises(terrors.PlanMismatchError):
        tplan_mod.reassemble(tp, tout, on_overflow="warn")
