"""The service's chaos soak (``tests/test_service.py``) through both packages.

One round of each of the soak's five waves — capacity starvation, sketch
corruption, executor failure, the two composed, and a no-fault control —
over mixed-family traffic with a malformed operand in every round, then
the panel class (gather starvation on a panel service) and the straggler
class (a ``DispatchBudget``-armed service under injected delay).  JAX runs
eight rounds of the waves; one each keeps this file's time down.  Every
request of the port ends in JAX's terminal state with JAX's error class
and context (the plan-key hash aside), or with JAX's CSR (``rpt``/``col``
exactly, ``val`` within rtol 1e-5); the queues drain, straggler waves
recover DEGRADED with their ledgers, no breaker of the straggler service
trips, and repeat traffic after the storm builds no executor.  The
shard-loss class (``tests/test_service.py``'s class 7) runs on a one-shard
mesh, where recovery has no survivor: every request ends FAILED with
JAX's typed error.  The port runs plain and through the kernel wrappers'
CPU path."""
import functools

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import plan as jplan_mod
from repro.serve import spgemm_service as jsvc
from repro.sparse import random as sprand
from repro_torch.core import faults as tfaults
from repro_torch.core import plan as tplan_mod
from repro_torch.core.mesh import make_mesh
from repro_torch.serve import spgemm_service as tsvc
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

VAL_RTOL = 1e-5

FAMILIES = [
    ("er", sprand.erdos_renyi(250, 250, 4, seed=25),
     sprand.erdos_renyi(250, 250, 3, seed=26)),
    ("pl", sprand.power_law(300, 300, 5, 1.5, seed=21),
     sprand.power_law(300, 300, 4, 1.6, seed=22)),
    ("rmat", sprand.rmat(250, 250, 1250, seed=31),
     sprand.rmat(250, 250, 1000, seed=32)),
    ("band", sprand.banded(250, 250, 10, 14, seed=23),
     sprand.banded(250, 250, 8, 12, seed=24)),
    ("fem", sprand.banded(160, 160, 40, 30, seed=51),
     sprand.banded(160, 160, 32, 28, seed=52)),
]

# the soak's waves, one round each (tests/test_service.py)
WAVES = [
    ("capacity", dict(capacity_scale=0.2)),
    ("sketch", dict(sketch_scale=0.05)),
    ("executor", dict(fail_executor={"unit": "local"})),
    ("composed", dict(capacity_scale=0.3, sketch_scale=0.5)),
    ("control", None),
]
CLASSES = [w for w, _ in WAVES] + ["operand", "gather", "straggler",
                                   "shard_loss"]


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _nan():
    m = sprand.erdos_renyi(50, 50, 3, seed=7)
    val = m.val.copy()
    val[len(val) // 2] = np.nan
    return type(m)(m.rpt, m.col, val, m.shape)


def _summary(req):
    err = req.error
    return dict(
        id=req.id, state=req.state, history=[s for s, _ in req.history],
        error=type(err).__name__ if err is not None else None,
        context=({k: v for k, v in err.context.items() if k != "plan_key"}
                 if err is not None else None),
        attempts=req.attempts,
        recoveries=req.stats.get("recoveries"),
        degradations=req.stats.get("degradations"))


def _soak(pkg, use_kernel=False):
    """The soak through one package: per fault class, each request's
    summary and result; and the checks that need no other package."""
    if pkg == "jax":
        import jax
        svc_mod, plan_mod, fmod, host, extra = (jsvc, jplan_mod, jfaults,
                                                lambda m: m, {})
        mesh = jax.make_mesh((1,), ("data",))
    else:
        svc_mod, plan_mod, fmod, host = tsvc, tplan_mod, tfaults, _host
        extra = dict(device="cpu", use_kernel=use_kernel)
        mesh = make_mesh((1,), ("data",), devices=["cpu"])

    def service(**cfg):
        return svc_mod.SpgemmService(svc_mod.ServiceConfig(**extra, **cfg))

    fams = [(host(a), host(b)) for _, a, b in FAMILIES]
    nan = host(_nan())
    out = {c: [] for c in CLASSES}
    svc = service(queue_capacity=256, max_batch=4, breaker_threshold=3,
                  breaker_cooldown=0.0)
    for round_i, (wave, fault) in enumerate(WAVES):
        batch = [svc.submit(a, b) for a, b in fams for _ in range(5)]
        bad = svc.submit(nan, nan)
        assert bad.state == svc_mod.RequestState.FAILED
        out["operand"].append(bad)
        if fault is None:
            svc.drain()
        else:
            with fmod.inject(seed=round_i, **fault):
                svc.drain()
        assert not fmod.armed()
        out[wave] += batch
    # the panel class: gather starvation needs a panel plan
    panel_svc = service(queue_capacity=64, n_panels=2)
    batch = [panel_svc.submit(a, b) for a, b in fams for _ in range(2)]
    with fmod.inject(gather_scale=0.25, seed=0):
        panel_svc.drain()
    out["gather"] = batch
    # the straggler class: every request recovers through per-unit replay
    rec_svc = service(queue_capacity=64, max_batch=4,
                      dispatch_budget=plan_mod.DispatchBudget(
                          multiple=50.0, floor_s=5.0))
    for a, b in fams:
        rec_svc.submit(a, b)
    rec_svc.drain()
    batch = [rec_svc.submit(a, b) for a, b in fams for _ in range(2)]
    with fmod.inject(delay_executor={"unit": "local"}, delay_s=30.0):
        rec_svc.drain()
    out["straggler"] = batch
    assert all(b["trips"] == 0 for b in rec_svc.stats()["breakers"])
    # the shard-loss class: on a one-shard mesh every shard is the lost
    # shard, so recovery is impossible and containment is a typed failure
    dist_svc = service(queue_capacity=16, breaker_cooldown=0.0, mesh=mesh)
    batch = [dist_svc.submit(a, b) for a, b in fams]
    with fmod.inject(lose_shard=0):
        dist_svc.drain()
    out["shard_loss"] = batch
    for s in (svc, panel_svc, rec_svc, dist_svc):
        st = s.stats()
        assert st["queue"]["depth"] == 0 and st["in_flight"] == 0
    # steady state after the storm: repeat traffic builds nothing
    for a, b in fams:
        svc.submit(a, b)
    svc.drain()
    traces = svc.stats()["plan_cache"]["traces"]
    post = [svc.submit(a, b) for a, b in fams for _ in range(2)]
    svc.drain()
    assert svc.stats()["plan_cache"]["traces"] == traces
    assert all(r.state == svc_mod.RequestState.DONE for r in post)
    breakers = [{k: v for k, v in b.items() if k != "time_in_state"}
                for b in svc.stats()["breakers"]]
    return {c: [(_summary(r), r.result) for r in reqs]
            for c, reqs in out.items()}, breakers


@functools.lru_cache(maxsize=None)
def _run(pkg, use_kernel=False):
    return _soak(pkg, use_kernel)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("cls", CLASSES)
def test_chaos_class_matches_jax(cls, use_kernel):
    want, _ = _run("jax")
    got, _ = _run("port", use_kernel)
    assert len(got[cls]) == len(want[cls]) > 0
    for (s, c), (js, jc) in zip(got[cls], want[cls]):
        assert s == js
        assert s["state"] in tsvc.RequestState.TERMINAL
        assert (c is None) == (jc is None) == (s["error"] is not None)
        if c is None:
            continue
        np.testing.assert_array_equal(c.rpt, jc.rpt)
        np.testing.assert_array_equal(c.col, jc.col)
        np.testing.assert_allclose(c.val, jc.val, rtol=VAL_RTOL, atol=1e-5)
    states = {s["state"] for s, _ in got[cls]}
    if cls == "straggler":
        assert states == {"DEGRADED"}
        assert all(s["recoveries"][0]["kind"] == "wave_failed"
                   for s, _ in got[cls])
    if cls in ("operand", "executor"):
        assert "FAILED" in states
    if cls == "shard_loss":
        assert states == {"FAILED"}
        assert {s["error"] for s, _ in got[cls]} == {"ShardFailureError"}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_chaos_breakers_match_jax(use_kernel):
    """The main service's breakers went through the same transitions."""
    assert _run("port", use_kernel)[1] == _run("jax")[1]
