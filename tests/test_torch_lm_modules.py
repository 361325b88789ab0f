"""The port's LM-stack modules against the JAX package's, at smoke width.

* ``configs``: every ``CONFIG`` and ``SMOKE`` equals JAX's field for field;
  ``param_count`` of each full ``CONFIG`` (the schema only, nothing
  allocated) equals JAX's, the recurrent zamba2-7b and xlstm-125m
  included.
* ``models.schema``: logical axes, stacked layers, ``abstract_params`` and
  ``init_params``' scales.
* ``models.layers``, ``models.attention`` (GQA and MLA, forward, prefill
  and decode with their caches, cross attention, the sliding window, more
  than one query chunk, q heads that the kv heads do not divide) and
  ``models.moe`` (output, aux losses and dropped fraction at an ample and
  at a starved capacity): float32 results within 1e-5 relative plus 1e-5 ×
  the result's largest |value| of JAX's on the same parameters, carried
  across with ``convert.params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import schema as jschema
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as tT

torch.set_num_threads(1)

TOL = 1e-5
NAMES = sorted(jbase.registry())


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
def test_registries_name_the_same_configs():
    assert sorted(tbase.registry()) == NAMES
    assert sorted(tbase.smoke_registry()) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_jax(name):
    for reg_t, reg_j in ((tbase.registry, jbase.registry),
                         (tbase.smoke_registry, jbase.smoke_registry)):
        t, j = reg_t()[name], reg_j()[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.resolved_head_dim, t.layer_kinds, t.padded_vocab(),
                t.padded_heads(1), t.padded_kv_heads(1)) == \
            (j.resolved_head_dim, j.layer_kinds, j.padded_vocab(),
             j.padded_heads(1), j.padded_kv_heads(1))
    assert tbase.get_config(name) == tbase.registry()[name]
    assert tbase.get_smoke_config(name) == tbase.smoke_registry()[name]


@pytest.mark.parametrize("name", NAMES)
def test_param_count_of_full_config_equals_jax(name):
    cfg = tbase.get_config(name)
    assert cfg.param_count_estimate() == \
        jbase.get_config(name).param_count_estimate()
    assert cfg.active_param_count_estimate() == \
        jbase.get_config(name).active_param_count_estimate()


# --------------------------------------------------------------------------- #
# schema
# --------------------------------------------------------------------------- #
def _jax_tree(schema, fn):
    return jax.tree_util.tree_map(fn, schema, is_leaf=jschema.is_pspec)


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", NAMES)
def test_schema_matches_jax(name):
    cfg_t, cfg_j = tbase.get_smoke_config(name), jbase.get_smoke_config(name)
    st, sj = tT.build_schema(cfg_t), jT.build_schema(cfg_j)
    ft = _flat(tschema.logical_axes(st))
    fj = _flat(jschema.logical_axes(sj))
    assert ft == fj
    shapes = _flat(tschema.tree_map(lambda l: (l.shape, l.init), st))
    assert shapes == _flat(_jax_tree(sj, lambda l: (l.shape, l.init)))
    assert tschema.param_count(st) == jschema.param_count(sj)
    meta = tschema.abstract_params(st, torch.bfloat16)
    for path, t in _flat(meta).items():
        assert t.is_meta and t.dtype == torch.bfloat16
        assert tuple(t.shape) == shapes[path][0]


def test_init_params_scales_and_determinism():
    cfg = tbase.get_smoke_config("deepseek-v3-671b")
    sch = tT.build_schema(cfg)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return tschema.init_params(sch, g, torch.float32, "cpu")
    p, again, other = draw(0), draw(0), draw(1)
    fp, fs = _flat(p), _flat(sch)
    for path, t in fp.items():
        spec = fs[path]
        assert tuple(t.shape) == spec.shape and t.dtype == torch.float32
        assert torch.equal(t, _flat(again)[path])
        if spec.init == "ones":
            assert bool((t == 1).all())
        elif spec.init == "zeros":
            assert bool((t == 0).all())
        else:
            assert not torch.equal(t, _flat(other)[path])
    # 1/sqrt(fan_in) with fan_in = shape[-2]; the embedding at 0.02
    wi = p["seg1"]["pos0"]["moe"]["wi"]                # (L, E, d, ff)
    assert float(wi.std()) == pytest.approx(1 / np.sqrt(cfg.d_model), rel=0.05)
    assert float(p["embed"]["tok"].std()) == pytest.approx(0.02, rel=0.05)
    assert tschema.param_bytes(p) == 4 * tschema.param_count(sch)
    bf = tschema.init_params(sch, torch.Generator().manual_seed(0),
                             torch.bfloat16, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tschema.tree_leaves(bf))


# --------------------------------------------------------------------------- #
# shared parameters for the module tests
# --------------------------------------------------------------------------- #
def _np_params(schema, seed):
    """Random numpy parameters for a JAX schema: normal leaves at
    1/sqrt(fan_in), ones and zeros perturbed so that norms and biases act."""
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
        return x / np.float32(np.sqrt(fan_in))
    return _jax_tree(schema, leaf)


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    """Within ``tol`` relative, plus ``tol`` × the result's largest |value|:
    the schema's scales (1/sqrt(shape[-2])) give attention scores of ~16
    standard deviations, where one rounding of a score moves a softmax
    weight by ~1e-5 of itself, whichever order the sums are taken in."""
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(scale, 1.0))


def _jit(fn, cfg, **kw):
    """JAX's ``fn(params, cfg, *args, **kw)`` under ``jax.jit``, as its
    serving engine runs the model (one compile a test, not one an op)."""
    return jax.jit(lambda p, *args: fn(p, cfg, *args, **kw))


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _cfg(name, **kw):
    return (dataclasses.replace(jbase.get_smoke_config(name), **kw),
            dataclasses.replace(tbase.get_smoke_config(name), **kw))


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["qwen2.5-32b", "starcoder2-7b"])
def test_norm_and_mlp_match_jax(name):
    jc, tc = _cfg(name)
    jp, tp = _both(_np_params({"n": jlayers.norm_schema(jc),
                               "m": jlayers.mlp_schema(jc)}, 1))
    jx, tx = _x((2, 5, jc.d_model), 2)
    _close(tlayers.apply_norm(tp["n"], tx), jlayers.apply_norm(jp["n"], jx))
    _close(tlayers.apply_mlp(tp["m"], tx), jlayers.apply_mlp(jp["m"], jx))


@pytest.mark.parametrize("sections", [(), (2, 3, 3)])
def test_rope_matches_jax(sections):
    jx, tx = _x((2, 7, 3, 16), 3)
    pos = np.random.default_rng(4).integers(0, 500, (3, 2, 7)).astype(np.int32)
    for p in (pos, pos[0]):
        _close(tlayers.apply_rope(tx, torch.from_numpy(p), 1e4, sections),
               jlayers.apply_rope(jx, jnp.asarray(p), 1e4, sections))


@pytest.mark.parametrize("tie", [False, True])
def test_embed_and_head_match_jax(tie):
    jc, tc = _cfg("phi3-mini-3.8b", tie_embeddings=tie)
    jp, tp = _both(_np_params(jlayers.embed_schema(jc, jc.padded_vocab()), 5))
    tok = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 9))
    je = jlayers.embed_tokens(jp, jnp.asarray(tok, jnp.int32), jnp.float32)
    te = tlayers.embed_tokens(tp, torch.from_numpy(tok.astype(np.int32)),
                              torch.float32)
    _close(te, je)
    got = tlayers.lm_head(tp, te)
    assert got.dtype == torch.float32
    _close(got, jlayers.lm_head(jp, je))


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
# (config, extra fields, sequence length, window)
GQA_CASES = {
    "qwen2.5": ("qwen2.5-32b", {}, 11, 0),
    "qwen2-vl": ("qwen2-vl-72b", {}, 9, 0),
    "window": ("phi3-mini-3.8b", {"sliding_window": 4}, 10, 4),
    "chunks": ("qwen2.5-32b", {}, 530, 0),
    "odd-heads": ("qwen2.5-32b", {"num_heads": 6, "num_kv_heads": 4,
                                  "head_dim": 16}, 8, 0),
}


def _positions(cfg, b, s):
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    if cfg.mrope_sections:
        # three distinct streams, so each M-RoPE section is exercised
        pos = np.stack([pos, pos // 2, pos % 3]).astype(np.int32)
    return jnp.asarray(pos), torch.from_numpy(np.ascontiguousarray(pos))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_gqa_forward_matches_jax(case, causal):
    name, kw, s, window = GQA_CASES[case]
    jc, tc = _cfg(name, **kw)
    jp, tp = _both(_np_params(jattn.gqa_schema(jc, 1), 7))
    jx, tx = _x((2, s, jc.d_model), 8)
    jpos, tpos = _positions(jc, 2, s)
    _close(tattn.gqa_forward(tp, tc, tx, tpos, causal=causal, window=window),
           _jit(jattn.gqa_forward, jc, causal=causal, window=window)(
               jp, jx, jpos))


def _assert_cache(got, want, tol=TOL):
    _close(got.k, want.k, tol)
    _close(got.v, want.v, tol)


@pytest.mark.parametrize("case", ["qwen2.5", "window", "odd-heads"])
def test_gqa_prefill_and_decode_match_jax(case):
    name, kw, s, window = GQA_CASES[case]
    jc, tc = _cfg(name, **kw)
    jp, tp = _both(_np_params(jattn.gqa_schema(jc, 1), 9))
    b, p = 2, s - 2                     # prefill, then two decode steps
    smax = s + 3
    jx, tx = _x((b, s, jc.d_model), 10)
    jpos, tpos = _positions(jc, b, s)
    jcache = jattn.init_gqa_cache(jc, b, smax, jnp.float32)
    tcache = tattn.init_gqa_cache(tc, b, smax, torch.float32, "cpu")
    jo, jcache = _jit(jattn.gqa_prefill, jc, window=window)(
        jp, jx[:, :p], jpos[:, :p], jcache)
    to, tcache = tattn.gqa_prefill(tp, tc, tx[:, :p], tpos[:, :p], tcache,
                                   window=window)
    _close(to, jo)
    _assert_cache(tcache, jcache)
    jdecode = _jit(jattn.gqa_decode, jc, window=window)
    for i in range(p, s):
        jo, jcache = jdecode(jp, jx[:, i:i + 1], jpos[:, i:i + 1], jcache,
                             jnp.asarray(i, jnp.int32))
        to, tcache = tattn.gqa_decode(tp, tc, tx[:, i:i + 1],
                                      tpos[:, i:i + 1], tcache,
                                      torch.tensor(i, dtype=torch.int32),
                                      window=window)
        _close(to, jo)
        _assert_cache(tcache, jcache)


def test_mla_forward_prefill_decode_match_jax():
    jc, tc = _cfg("deepseek-v3-671b")
    jp, tp = _both(_np_params(jattn.mla_schema(jc, 1), 11))
    b, s, p = 2, 7, 5
    jx, tx = _x((b, s, jc.d_model), 12)
    jpos, tpos = _positions(jc, b, s)
    for causal in (True, False):
        _close(tattn.mla_forward(tp, tc, tx, tpos, causal=causal),
               _jit(jattn.mla_forward, jc, causal=causal)(jp, jx, jpos))
    jcache = jattn.init_mla_cache(jc, b, s + 2, jnp.float32)
    tcache = tattn.init_mla_cache(tc, b, s + 2, torch.float32, "cpu")
    jo, jcache = _jit(jattn.mla_prefill, jc)(jp, jx[:, :p], jpos[:, :p],
                                             jcache)
    to, tcache = tattn.mla_prefill(tp, tc, tx[:, :p], tpos[:, :p], tcache)
    _close(to, jo)
    _assert_cache(tcache, jcache)
    jdecode = _jit(jattn.mla_decode, jc)
    for i in range(p, s):
        jo, jcache = jdecode(jp, jx[:, i:i + 1], jpos[:, i:i + 1], jcache,
                             jnp.asarray(i, jnp.int32))
        to, tcache = tattn.mla_decode(tp, tc, tx[:, i:i + 1], tpos[:, i:i + 1],
                                      tcache, torch.tensor(i))
        _close(to, jo)
        _assert_cache(tcache, jcache)


def test_cross_attention_matches_jax():
    jc, tc = _cfg("whisper-small")
    jp, tp = _both(_np_params(jattn.cross_schema(jc, 1), 13))
    jx, tx = _x((2, 6, jc.d_model), 14)
    je, te = _x((2, jc.encoder_seq_len, jc.d_model), 15)
    _close(tattn.cross_forward(tp, tc, tx, te),
           _jit(jattn.cross_forward, jc)(jp, jx, je))


def test_decode_past_the_cache_raises():
    _, tc = _cfg("qwen2.5-32b")
    tp = convert.params_from_numpy(
        _np_params(jattn.gqa_schema(_cfg("qwen2.5-32b")[0], 1), 16),
        device="cpu")
    cache = tattn.init_gqa_cache(tc, 1, 4, torch.float32, "cpu")
    x = torch.zeros((1, 1, tc.d_model))
    pos = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(IndexError, match="past the cache"):
        tattn.gqa_decode(tp, tc, x, pos, cache, torch.tensor(4))


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("capacity", [64, 4])
@pytest.mark.parametrize("name", ["deepseek-v3-671b", "llama4-scout-17b-a16e"])
def test_moe_matches_jax(name, capacity):
    jc, tc = _cfg(name)
    jp, tp = _both(_np_params(jmoe.moe_schema(jc), 17))
    jx, tx = _x((2, 16, jc.d_model), 18)
    jy, jaux = _jit(jmoe.apply_moe, jc, capacity=capacity)(jp, jx)
    ty, taux = tmoe.apply_moe(tp, tc, tx, capacity=capacity)
    _close(ty, jy)
    for f in tmoe.MoEAux._fields:
        _close(getattr(taux, f), getattr(jaux, f))
    if capacity == 64:
        assert float(taux.dropped_fraction) == 0.0
    else:
        assert float(taux.dropped_fraction) > 0.0
    assert tmoe.default_capacity(tc, 16) == jmoe.default_capacity(jc, 16)
