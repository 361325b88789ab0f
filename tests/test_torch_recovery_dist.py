"""Shard-loss recovery in the port (``core/recovery.py``'s distributed half)
against the JAX package, on the families of ``tests/test_recovery.py``.

The JAX side runs once, in a subprocess with four host devices (the
device count must be set before JAX starts, as ``tests/test_recovery.py``
does): shard 2 of a 4-way mesh is lost on every family (whole-B), and
device 1 of a 2-panel plan on the banded family.  The port runs the same
plans on a mesh of four CPU devices.  Its recovery ledger
(``plan.recoveries``) has JAX's kinds in JAX's order, the same shards for
every ``unit``, ``shard_lost`` and ``rehome`` event, the same donors,
recipients, buckets and row counts — and its recovered product equals its
own no-fault run bit for bit.  In-process, a one-shard mesh replays a
failed or straggling wave per unit (JAX's ledger, JAX's product to
tolerance), and raises typed when its only shard is lost."""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import plan as jplan_mod
from repro.sparse import random as sprand
from repro_torch.core import faults as tfaults
from repro_torch.core import plan as tplan_mod
from repro_torch.core.errors import ShardFailureError, StragglerError
from repro_torch.core.mesh import make_mesh
from repro_torch.sparse.formats import CSR, spgemm_dense_oracle

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOST = 2
PANEL_LOST = 1

FAMILIES = {
    "er": (sprand.erdos_renyi(250, 250, 4, seed=25),
           sprand.erdos_renyi(250, 250, 3, seed=26)),
    "pl": (sprand.power_law(300, 300, 5, 1.5, seed=21),
           sprand.power_law(300, 300, 4, 1.6, seed=22)),
    "rmat": (sprand.rmat(250, 250, 1250, seed=31),
             sprand.rmat(250, 250, 1000, seed=32)),
    "band": (sprand.banded(250, 250, 10, 14, seed=23),
             sprand.banded(250, 250, 8, 12, seed=24)),
    "fem": (sprand.banded(160, 160, 40, 30, seed=51),
            sprand.banded(160, 160, 32, 28, seed=52)),
}
NAMES = sorted(FAMILIES)

# the JAX side: the ledgers of the lost-shard runs, one line of JSON
SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax
import numpy as np

from repro.sparse import random as sprand
from repro.core import faults, plan as plan_mod

mesh = jax.make_mesh((4,), ("data",))
fams = {
    "er": (sprand.erdos_renyi(250, 250, 4, seed=25),
           sprand.erdos_renyi(250, 250, 3, seed=26)),
    "pl": (sprand.power_law(300, 300, 5, 1.5, seed=21),
           sprand.power_law(300, 300, 4, 1.6, seed=22)),
    "rmat": (sprand.rmat(250, 250, 1250, seed=31),
             sprand.rmat(250, 250, 1000, seed=32)),
    "band": (sprand.banded(250, 250, 10, 14, seed=23),
             sprand.banded(250, 250, 8, 12, seed=24)),
    "fem": (sprand.banded(160, 160, 40, 30, seed=51),
            sprand.banded(160, 160, 32, 28, seed=52)),
}

def ledger(p):
    return [{k: v for k, v in e.items() if k != "error"}
            for e in p.recoveries]

out = {}
for name, (a, b) in fams.items():
    cache = plan_mod.PlanCache()
    p = plan_mod.plan_spgemm(a, b, mesh=mesh, safety=1.3,
                             retry_policy=plan_mod.RetryPolicy())
    c0 = plan_mod.reassemble(p, plan_mod.execute(p, a, b, cache=cache))
    with faults.inject(lose_shard=%(lost)d):
        c1 = plan_mod.reassemble(p, plan_mod.execute(p, a, b, cache=cache))
    out[name] = dict(ledger=ledger(p), nnz=int(c1.nnz),
                     rpt_eq=bool((c1.rpt == c0.rpt).all()))
a, b = fams["band"]
cache = plan_mod.PlanCache()
p = plan_mod.plan_spgemm(a, b, mesh=mesh, n_panels=2, safety=1.3,
                         retry_policy=plan_mod.RetryPolicy())
plan_mod.execute(p, a, b, cache=cache)
with faults.inject(lose_shard=%(panel_lost)d):
    c1 = plan_mod.reassemble(p, plan_mod.execute(p, a, b, cache=cache))
out["band-panels"] = dict(ledger=ledger(p), nnz=int(c1.nnz), rpt_eq=True)
print(json.dumps(out))
""" % dict(lost=LOST, panel_lost=PANEL_LOST)


@functools.lru_cache(maxsize=None)
def _jax_ledgers() -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _bitwise(c, want):
    np.testing.assert_array_equal(c.rpt, want.rpt)
    np.testing.assert_array_equal(c.col, want.col)
    np.testing.assert_array_equal(c.val.view(np.int32),
                                  want.val.view(np.int32))


def _port_lost(family, n_panels, lost, use_kernel=False):
    """The port's clean and lost-shard runs of one plan on four CPU
    devices: (clean CSR, recovered CSR, ledger without error texts)."""
    a, b = (_host(m) for m in FAMILIES[family])
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    cache = tplan_mod.PlanCache()
    p = tplan_mod.plan_spgemm(a, b, mesh=mesh, safety=1.3,
                              n_panels=n_panels, use_kernel=use_kernel,
                              retry_policy=tplan_mod.RetryPolicy())
    c0 = tplan_mod.reassemble(p, tplan_mod.execute(p, a, b, cache=cache))
    assert p.recoveries == []
    with tfaults.inject(lose_shard=lost):
        c1 = tplan_mod.reassemble(p, tplan_mod.execute(p, a, b, cache=cache))
    assert not tfaults.armed()
    json.dumps(p.stats())               # the ledger stays serializable
    assert p.stats()["recoveries"] == p.recoveries
    return c0, c1, [{k: v for k, v in e.items() if k != "error"}
                    for e in p.recoveries]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", NAMES)
def test_lost_shard_ledger_matches_jax(family, use_kernel):
    want = _jax_ledgers()[family]
    c0, c1, led = _port_lost(family, 0, LOST, use_kernel)
    assert led == want["ledger"]
    _bitwise(c1, c0)
    assert c1.nnz == want["nnz"] and want["rpt_eq"]
    # only the survivors' units re-ran, each once; only the lost shard's
    # rows re-homed, onto survivors
    units = [(e["bucket"], e["shard"]) for e in led if e["kind"] == "unit"]
    assert len(units) == len(set(units))
    assert {s for _, s in units} == {0, 1, 3}
    assert {e["shard"] for e in led if e["kind"] == "shard_lost"} == {LOST}
    rehomes = [e for e in led if e["kind"] == "rehome"]
    assert {e["shard"] for e in rehomes} == {LOST}
    assert {e["to"] for e in rehomes} <= {0, 1, 3}
    a, b = FAMILIES[family]
    np.testing.assert_allclose(c1.to_dense(), spgemm_dense_oracle(a, b),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lost_device_of_a_panel_plan_matches_jax(use_kernel):
    want = _jax_ledgers()["band-panels"]
    c0, c1, led = _port_lost("band", 2, PANEL_LOST, use_kernel)
    assert led == want["ledger"]
    _bitwise(c1, c0)
    assert {e["shard"] for e in led if e["kind"] == "rehome"} \
        == {PANEL_LOST}


@pytest.mark.parametrize("family", NAMES)
def test_lost_panel_device_rehomes_bitwise(family):
    """Every family at two panels, device 2 lost: its units move whole to
    survivors and the product is the clean run's, bit for bit."""
    c0, c1, led = _port_lost(family, 2, LOST)
    _bitwise(c1, c0)
    rehomes = [e for e in led if e["kind"] == "rehome"]
    assert rehomes and {e["shard"] for e in rehomes} == {LOST}


def _one_shard(family, **inj):
    """JAX and the port on a one-shard mesh under ``inj``: each (ledger
    kinds, units, CSR or error)."""
    import jax
    a, b = FAMILIES[family]
    out = []
    for plan_mod, fmod, mesh, (x, y), extra in (
            (jplan_mod, jfaults, jax.make_mesh((1,), ("data",)), (a, b), {}),
            (tplan_mod, tfaults, make_mesh((1,), ("data",),
                                           devices=["cpu"]),
             (_host(a), _host(b)), {})):
        cache = plan_mod.PlanCache()
        p = plan_mod.plan_spgemm(
            x, y, mesh=mesh, safety=1.3, retry_policy=plan_mod.RetryPolicy(),
            dispatch_budget=plan_mod.DispatchBudget(multiple=50.0,
                                                    floor_s=5.0), **extra)
        c0 = plan_mod.reassemble(p, plan_mod.execute(p, x, y, cache=cache))
        try:
            with fmod.inject(**inj):
                c = plan_mod.reassemble(p, plan_mod.execute(p, x, y,
                                                            cache=cache))
        except plan_mod.SpgemmError as e:
            c = e
        out.append(([{k: v for k, v in e.items() if k != "error"}
                     for e in p.recoveries], c0, c))
    return out


@pytest.mark.parametrize("fault", ["executor", "delay", "lose"])
@pytest.mark.parametrize("family", ["band", "pl"])
def test_one_shard_mesh_recovery_matches_jax(family, fault):
    """``tests/test_recovery.py``'s in-process pins: on a one-shard mesh a
    failed wave (executor death) and a straggling one (an injected delay
    against the budget) replay per unit — JAX's ledger, every unit landing
    first try, the clean product — and a lost shard has no survivor, so
    the run raises typed."""
    inj = dict(executor=dict(fail_executor={"unit": "dist"}),
               delay=dict(delay_executor={"unit": "dist"}, delay_s=30.0),
               lose=dict(lose_shard=0))[fault]
    (jled, jc0, jc), (led, c0, c) = _one_shard(family, **inj)
    assert led == jled
    if fault == "lose":
        assert isinstance(c, ShardFailureError)
        assert type(jc).__name__ == "ShardFailureError"
        assert c.context["shards"] == jc.context["shards"] == [0]
        return
    assert led[0]["kind"] == "wave_failed"
    assert led[0]["unit"] == "dist"
    assert all(e["attempts"] == 1 for e in led if e["kind"] == "unit")
    _bitwise(c, c0)
    np.testing.assert_array_equal(c.rpt, jc.rpt)
    np.testing.assert_array_equal(c.col, jc.col)
    np.testing.assert_allclose(c.val, jc.val, rtol=1e-5, atol=1e-6)
    if fault == "delay":
        assert issubclass(StragglerError, ShardFailureError)
