"""The port's sharding (``models/sharding.py``, ``launch/{mesh,specs}.py``,
``optimizer.state_specs``) against the JAX package's, and sharded runs
against unsharded ones.

* Rules and spec trees: ``make_rules``, ``specs_from_schema``,
  ``batch_specs``, ``batch_pspecs``, ``decode_pspecs``, ``cache_spec_tree``
  and the optimizer's state specs equal JAX's entry by entry for all ten
  configs on the single and the multi-pod mesh (pure functions, so
  exactly); the shape cells, live cells and batch axes are JAX's; every
  sharded parameter dimension divides by its mesh axes.
* Outside a mesh ``constrain_*`` and ``local_map`` hand back their
  argument's own result (the unsharded path is unchanged bit for bit).
* A sharded train step on a one-process ``gloo`` (1, 1) mesh (JAX's R5
  test, held to unsharded runs): phi3-mini's smoke config in float32,
  Adam's ``eps`` 1e-3 (its first step is the sign of each gradient, so a
  gradient within rounding of 0 would flip otherwise).  Against the port's
  unsharded step: loss within 1e-6 relative, parameters within 1e-5 of
  each leaf's largest |value|; against JAX's unsharded ``make_train_step``:
  1e-4 (the tolerance of ``test_torch_train.py``).
* Four ``gloo`` ranks on a (2, 2) mesh, one process each: deepseek-v3's
  smoke config (MLA, MoE, FSDP) gradients within 1e-4 of each leaf's
  largest |gradient| of the unsharded ones, and four decode steps of
  qwen2.5-32b's (q heads sharded, kv heads whole) and zamba2-7b's (Mamba
  states, the shared attention's cache) smoke configs, the caches' four
  positions split over the two `model` ranks (each rank's shard written),
  logits within 1e-5 of the largest |logit|.
"""
import json
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jbase
from repro.launch import specs as jspecs
from repro.models import schema as jschema
from repro.models import sharding as jsharding
from repro.models import transformer as jT
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import specs as tspecs
from repro_torch.models import schema as tschema
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as tT
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
NAMES = sorted(jbase.registry())
SIZES = {"pod": 2, "data": 16, "model": 16}


def _jflat(tree) -> dict:
    """{path: spec entries} of a JAX spec tree (dicts, named tuples)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]

    def key(k):
        for a in ("key", "name", "idx"):
            if hasattr(k, a):
                return getattr(k, a)
        raise TypeError(k)
    return {tuple(str(key(k)) for k in path): tuple(p) for path, p in leaves}


def _tflat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, tuple) and not tsharding.is_spec(tree):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_tflat(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


def _same(t, j):
    got, want = _tflat(t), _jflat(j)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


# --------------------------------------------------------------------------- #
# rules and spec trees
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
def test_rules_and_spec_trees_equal_jax(name):
    jc, tc = jbase.get_config(name), tbase.get_config(name)
    js, ts = jT.build_schema(jc, 16), tT.build_schema(tc, 16)
    for mp in (False, True):
        for fsdp in (None, True):
            jr = jsharding.make_rules(jc, mesh_model=16, multi_pod=mp,
                                      fsdp=fsdp)
            tr = tsharding.make_rules(tc, mesh_model=16, multi_pod=mp,
                                      fsdp=fsdp)
            assert tr == jr
            _same(tsharding.specs_from_schema(ts, tr),
                  jsharding.specs_from_schema(js, jr))
        for kind in ("train", "prefill", "decode"):
            _same(tsharding.batch_specs(tc, kind, mp),
                  jsharding.batch_specs(jc, kind, mp))
        _same(tsharding.cache_spec_tree(tc, 16, mp),
              jsharding.cache_spec_tree(jc, 16, mp))
        for shape in tspecs.SHAPES:
            if not tspecs.cell_is_live(name, shape):
                continue
            _same(tspecs.batch_pspecs(tc, shape, mp),
                  jspecs.batch_pspecs(jc, shape, mp))
            got = tspecs.decode_pspecs(tc, shape, mp)
            want = jspecs.decode_pspecs(jc, shape, mp)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    _same({"x": g}, {"x": w})


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_divide_shapes(name):
    """Every sharded param dim must divide by its mesh axis size."""
    cfg = tbase.get_config(name)
    schema = tT.build_schema(cfg, mesh_model=16)
    rules = tsharding.make_rules(cfg, mesh_model=16, multi_pod=True)
    specs = _tflat(tsharding.specs_from_schema(schema, rules))
    shapes = {k: v.shape for k, v in _tflat_shapes(schema).items()}
    assert sorted(specs) == sorted(shapes)
    for k, spec in specs.items():
        for dim, ax in zip(shapes[k], spec):
            if ax is None:
                continue
            n = int(np.prod([SIZES[a] for a in
                             ((ax,) if isinstance(ax, str) else ax)]))
            assert dim % n == 0, (name, k, shapes[k], spec)


def _tflat_shapes(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat_shapes(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def test_shape_cells_and_batch_axes_equal_jax():
    assert tspecs.SHAPES == jspecs.SHAPES
    assert tspecs.LONG_CONTEXT_ARCHS == jspecs.LONG_CONTEXT_ARCHS
    assert tspecs.VISION_PATCHES == jspecs.VISION_PATCHES
    cells = tspecs.live_cells(NAMES)
    assert cells == jspecs.live_cells(NAMES) and len(cells) == 32
    for name in NAMES:
        jc, tc = jbase.get_config(name), tbase.get_config(name)
        for sh in tspecs.SHAPES.values():
            for mp in (False, True):
                assert tspecs._batch_axes(tc, sh["batch"], mp) == \
                    jspecs._batch_axes(jc, sh["batch"], mp)


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "qwen2-vl-72b",
                                  "whisper-small", "zamba2-7b"])
def test_structs_equal_jax(name):
    jc, tc = jbase.get_config(name), tbase.get_config(name)
    for shape in ("train_4k", "prefill_32k"):
        got = tspecs.batch_structs(tc, shape)
        want = jspecs.batch_structs(jc, shape)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    tok, cur, cache, enc = tspecs.decode_structs(tc, "decode_32k")
    jtok, jcur, jcache, jenc = jspecs.decode_structs(jc, "decode_32k")
    assert tuple(tok.shape) == jtok.shape and tuple(cur.shape) == ()
    got = {k: tuple(v.shape) for k, v in _tflat_tensors(cache).items()}
    want = {tuple(str(getattr(p, "key", getattr(p, "name", ""))) for p in
                  path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert got == want
    assert sorted(got) == sorted(_tflat(tspecs.decode_pspecs(
        tc, "decode_32k", False)[2]))
    assert (enc is None) == (jenc is None)


def _tflat_tensors(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat_tensors(v, prefix + (str(k),)))
        return out
    if isinstance(tree, tuple):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_tflat_tensors(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mp", [False, True])
def test_state_specs_equal_jax(mp):
    name = "deepseek-v3-671b"
    jc, tc = jbase.get_config(name), tbase.get_config(name)
    js, ts = jT.build_schema(jc, 16), tT.build_schema(tc, 16)
    jr = jsharding.make_rules(jc, mesh_model=16, multi_pod=mp)
    tr = tsharding.make_rules(tc, mesh_model=16, multi_pod=mp)
    plain = topt.state_specs(tsharding.specs_from_schema(ts, tr))
    want = jopt.state_specs(jsharding.specs_from_schema(js, jr))
    assert tuple(plain.step) == tuple(want.step) == ()
    _same(plain.mu, want.mu)
    _same(plain.nu, want.nu)
    # JAX's ``lower_cell`` builds the ZeRO variant inline
    zero_rules = dict(jr, embed=("pod", "data") if mp else ("data",))
    zero = topt.zero_state_specs(ts, tr, multi_pod=mp)
    _same(zero.mu, jsharding.specs_from_schema(js, zero_rules))
    _same(zero.nu, jsharding.specs_from_schema(js, zero_rules))


def test_spec_normalisation_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    P = tsharding.P
    assert P(("data",), None) == P("data", None) == ("data", None)
    assert P((), "model") == (None, "model")
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tsharding.placements(P(("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tsharding.placements(P(None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError):
        tsharding.placements(P(("data", "pod")), mesh)


def test_outside_a_mesh_nothing_changes():
    x = torch.randn(2, 3, 4)
    assert tsharding.ambient_mesh() is None
    assert tsharding.constrain_batch(x, sharded_tail={2: "model"}) is x
    assert tsharding.constrain_spec(x, tsharding.P("model", "data")) is x
    out = object()
    assert tsharding.local_map(lambda a, b: out, (x, x), (None, None),
                               None) is out


def test_core_reexports_the_planner_lazily():
    import importlib
    core = importlib.import_module("repro_torch.core")
    from repro_torch.core import plan
    assert core.plan_spgemm is plan.plan_spgemm
    assert core.RetryPolicy is plan.RetryPolicy
    with pytest.raises(AttributeError):
        core.no_such_name


# --------------------------------------------------------------------------- #
# sharded runs against unsharded ones
# --------------------------------------------------------------------------- #
@pytest.fixture
def one_rank_group():
    """A one-process gloo group, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _np_params(schema, seed):
    rng = np.random.default_rng(seed)

    def leaf(spec):
        x = rng.standard_normal(spec.shape).astype(np.float32)
        if spec.init == "ones":
            return 1.0 + 0.1 * x
        if spec.init == "zeros":
            return 0.1 * x
        if spec.init == "embed":
            return 0.02 * x
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else 1 / np.sqrt(fan_in)
        return x * np.float32(scale)
    return jax.tree_util.tree_map(leaf, schema, is_leaf=jschema.is_pspec)


def _max_rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def test_sharded_train_step_1x1_mesh(one_rank_group):
    from torch.distributed.tensor import init_device_mesh
    name = "phi3-mini-3.8b"
    jc, tc = jbase.get_smoke_config(name), tbase.get_smoke_config(name)
    params = _np_params(jT.build_schema(jc, 1), 3)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    kw = dict(total_steps=4, warmup_steps=1, eps=1e-3)

    jcfg = jopt.AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstep = jax.jit(jtl.make_train_step(jc, jcfg))
    jnew, _, jm = jstep(jp, jopt.init_state(jcfg, jp),
                        {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = topt.AdamWConfig(**kw)
    step = ttl.make_train_step(tc, tcfg)
    tp = convert.params_from_numpy(params, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain, _, pm = step(tp, topt.init_state(tcfg, tp), tb)

    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    specs = tsharding.specs_from_schema(
        tT.build_schema(tc, 1),
        tsharding.make_rules(tc, mesh_model=1, multi_pod=False))
    dp = tsharding.distribute_tree(tp, specs, mesh)
    db = {k: tsharding.distribute(v, tsharding.P("data", None), mesh)
          for k, v in tb.items()}
    state = topt.init_state(tcfg, dp)
    assert tschema.tree_leaves(state.mu)[0].placements == \
        tschema.tree_leaves(dp)[0].placements
    with tsharding.use_mesh(mesh):
        sharded, _, sm = step(dp, state, db)

    loss = float(sm["loss"].full_tensor())
    assert abs(loss - float(pm["loss"])) <= 1e-6 * abs(float(pm["loss"]))
    assert abs(loss - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
    got = [t.full_tensor() for t in tschema.tree_leaves(sharded)]
    for g, p, j in zip(got, tschema.tree_leaves(plain),
                       jax.tree_util.tree_leaves(jnew)):
        assert _max_rel(g, p) <= 1e-5
        assert _max_rel(g, j) <= 1e-4


FOUR_RANKS = r"""
import dataclasses, json, os, sys
import torch, torch.distributed as dist
from torch.distributed.tensor import init_device_mesh
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import schema, sharding as S, transformer as T
from repro_torch.train.train_loop import grads_of

torch.set_num_threads(1)
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        rank=rank, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}

def setup(name, fsdp):
    cfg = dataclasses.replace(get_smoke_config(name), dtype="float32")
    sch = T.build_schema(cfg, 2)
    specs = S.specs_from_schema(sch, S.make_rules(
        cfg, mesh_model=2, multi_pod=False, fsdp=fsdp))
    p = schema.init_params(sch, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    return cfg, p, S.distribute_tree(p, specs, mesh)

def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

cfg, p, dp = setup("deepseek-v3-671b", True)
g = torch.Generator().manual_seed(1)
batch = {k: torch.randint(0, cfg.vocab_size, (4, 12), generator=g,
                          dtype=torch.int32) for k in ("tokens", "labels")}
_, want = grads_of(p, cfg, batch)
with S.use_mesh(mesh):
    _, got = grads_of(dp, cfg, {k: S.distribute(v, S.P("data", None), mesh)
                               for k, v in batch.items()})
out["grads"] = max(rel(a.full_tensor(), b) for a, b in zip(
    schema.tree_leaves(got), schema.tree_leaves(want)))

for name in ("qwen2.5-32b", "zamba2-7b"):
    cfg, p, dp = setup(name, False)
    toks = torch.randint(0, cfg.vocab_size, (4, 4), generator=g,
                         dtype=torch.int32)
    cache = T.init_cache(cfg, 4, 4, 2, device="cpu")
    dcache = S.distribute_tree(T.init_cache(cfg, 4, 4, 2, device="cpu"),
                               S.cache_spec_tree(cfg, 2, False), mesh)
    worst = 0.0
    with torch.no_grad():
        for t in range(4):
            cur = torch.tensor(t, dtype=torch.int32)
            want, _ = T.decode_step(p, cfg, toks[:, t:t + 1], cache, cur)
            dt = S.distribute(toks[:, t:t + 1], S.P("data", None), mesh)
            with S.use_mesh(mesh):
                got, _ = T.decode_step(dp, cfg, dt, dcache, cur)
            worst = max(worst, rel(got.full_tensor(), want))
    out[name] = worst
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


def test_sharded_matches_unsharded_on_four_ranks(tmp_path):
    script = tmp_path / "four_ranks.py"
    script.write_text(FOUR_RANKS)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert res["grads"] <= 1e-4, res
    assert res["qwen2.5-32b"] <= 1e-5 and res["zamba2-7b"] <= 1e-5, res
