"""The port's roofline (``roofline/{hlo_cost,analysis,report}.py``) against
the JAX package's.

* FLOPs: ``hlo_cost.analyze`` counts exactly JAX's ``hlo_cost.analyze`` of
  the compiled program on JAX's own cases — a single dot, a dot in a
  7-trip loop (a ``scan`` in JAX, a Python loop in the port) and a batched
  dot — and on phi3-mini's smoke forward, unsharded, at 512 tokens (one
  whole query chunk: at other lengths JAX pads the last chunk to 512 rows
  and counts the padded rows' products, the port leaves them out).
* Per chip: a sharded product on a fake (2, 4) mesh counts the rank's own
  local product, not the global one, and the all-gather DTensor issues.
* Bytes are non-zero and sane; ``Roofline.build`` on the H100's rates.
* ``roofline_table`` and ``dryrun_summary`` print what JAX's print on the
  same two records.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro.models import schema as jschema
from repro.models import transformer as jT
from repro.roofline import hlo_cost as jcost
from repro.roofline import report as jreport
from repro_torch.configs import base as tbase
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as tT
from repro_torch.roofline import analysis
from repro_torch.roofline import hlo_cost
from repro_torch.roofline import report

torch.set_num_threads(1)


def _jax_flops(f, *shapes) -> float:
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jcost.analyze(jax.jit(f).lower(*args).compile().as_text())["flops"]


def test_single_dot_flops_equal_jax():
    a = torch.randn(512, 512)
    got = hlo_cost.analyze(lambda x: x @ x, a)["flops"]
    assert got == _jax_flops(lambda x: x @ x, (512, 512)) == 2 * 512 ** 3


def test_loop_flops_equal_jax():
    def jf(a):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, None), a, None, length=7)
        return y

    def tf(a):
        for _ in range(7):
            a = a @ a
        return a
    got = hlo_cost.analyze(tf, torch.randn(256, 256) * 0.01)["flops"]
    assert got == _jax_flops(jf, (256, 256)) == 7 * 2 * 256 ** 3


def test_batched_dot_flops_equal_jax():
    x, y = torch.randn(8, 64, 96), torch.randn(8, 96, 32)
    got = hlo_cost.analyze(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                           x, y)["flops"]
    want = _jax_flops(lambda a, b: jnp.einsum("bik,bkj->bij", a, b),
                      (8, 64, 96), (8, 96, 32))
    assert got == want == 2 * 8 * 64 * 96 * 32


def test_forward_flops_equal_jax():
    name, s = "phi3-mini-3.8b", 512
    jc, tc = jbase.get_smoke_config(name), tbase.get_smoke_config(name)
    tok = np.random.default_rng(0).integers(0, jc.vocab_size, (2, s))
    text = jax.jit(lambda p, b: jT.forward(p, jc, b)[0]).lower(
        jschema.abstract_params(jT.build_schema(jc, 1)),
        {"tokens": jax.ShapeDtypeStruct((2, s), jnp.int32)}).compile(
        ).as_text()
    params = tschema.init_params(tT.build_schema(tc, 1), torch.Generator(),
                                 device="cpu")
    with torch.no_grad():
        got = hlo_cost.analyze(tT.forward, params, tc, {
            "tokens": torch.from_numpy(tok.astype(np.int32))})
    assert got["flops"] == jcost.analyze(text)["flops"]
    assert got["collective_bytes"] == 0.0


def test_bytes_nonzero_and_sane():
    a = torch.randn(1024, 1024)
    r = hlo_cost.analyze(lambda x: x @ x + 1.0, a)
    sz = 1024 * 1024 * 4
    assert 2 * sz <= r["bytes"] < 50 * sz


@pytest.fixture
def fake_group():
    """A fake process group of 8 ranks, destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_counts_are_a_chips_share(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (Replicate, Shard, distribute_tensor,
                                          init_device_mesh)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 128), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(128, 256), mesh,
                              [Replicate(), Shard(1)])

        def step():
            return (x @ w).redistribute(mesh, [Shard(0), Replicate()])
        r = hlo_cost.analyze(step)
    # rank 0's product: 32 rows by 64 of the 256 columns
    assert r["flops"] == 2 * 32 * 128 * 64
    # the gathered (32, 256) float32 rows over `model`
    assert r["collectives"]["all-gather"] == 32 * 256 * 4
    assert r["collective_bytes"] == r["collectives"]["all-gather"]


def test_roofline_terms_on_the_h100():
    rl = analysis.Roofline.build(
        flops_per_chip=9.89e12,            # 10 ms at 989 TFLOP/s
        hbm_bytes_per_chip=3.35e9,         # 1 ms at 3.35 TB/s
        coll={"all-reduce": 50e6},         # 1 ms at 50 GB/s
        model_flops=9.89e12 * 256 * 0.5, chips=256)
    assert rl.compute_s == pytest.approx(0.01)
    assert rl.memory_s == pytest.approx(0.001)
    assert rl.collective_s == pytest.approx(0.001)
    assert rl.bottleneck == "compute"
    assert rl.useful_flops_ratio == pytest.approx(0.5)
    assert sorted(rl.to_dict()) == sorted(
        ["flops_per_chip", "hbm_bytes_per_chip", "collective_bytes_per_chip",
         "collective_breakdown", "compute_s", "memory_s", "collective_s",
         "bottleneck", "model_flops", "useful_flops_ratio"])


def _record(arch, shape, mesh, compute, memory, coll, temp, secs):
    rl = analysis.Roofline.build(compute * analysis.PEAK_FLOPS,
                                 memory * analysis.HBM_BW,
                                 {"all-gather": coll * analysis.LINK_BW},
                                 1e15, 256).to_dict()
    return dict(arch=arch, shape=shape, mesh=mesh, chips=256, kind="train",
                compile_s=secs, memory_analysis={"temp_size": temp},
                roofline=rl)


def test_report_equals_jax(tmp_path):
    recs = [_record("phi3-mini-3.8b", "train_4k", "single", 0.2, 0.5, 0.1,
                    3 * 2 ** 30, 12.0),
            _record("xlstm-125m", "decode_32k", "single", 0.01, 0.03, 0.002,
                    2 ** 29, 4.0)]
    for r in recs:
        with open(tmp_path / f"{r['arch']}__{r['shape']}__single.json",
                  "w") as f:
            json.dump(r, f)
    assert report.roofline_table(str(tmp_path)) == \
        jreport.roofline_table(str(tmp_path))
    assert report.dryrun_summary(str(tmp_path)) == \
        jreport.dryrun_summary(str(tmp_path))
    # the port's own records are traced, not compiled
    for r in recs:
        r["trace_s"] = r.pop("compile_s")
        with open(tmp_path / f"{r['arch']}__{r['shape']}__single.json",
                  "w") as f:
            json.dump(r, f)
    assert report.dryrun_summary(str(tmp_path)) == \
        "2 single-pod + 0 multi-pod cells traced; median trace 12s"
