"""The port's transformer and serving engine against the JAX package's, for
all ten smoke configs (the recurrent xlstm-125m and zamba2-7b included).

* ``transformer.forward`` (logits, aux losses and deepseek's MTP logits;
  qwen2-vl with early-fused patch embeddings and three M-RoPE position
  streams; whisper through its encoder) and ``decode_step`` step by step
  (every step's logits and the returned cache): within 1e-4 relative plus
  1e-4 × the result's largest |value| of JAX's.  The port's own decode
  reproduces its forward (the serving invariant of
  ``tests/test_decode_consistency.py``).
* ``serve.engine.generate``: greedy tokens and the final cache (KV, SSM
  and sLSTM states, zamba2's shared-attention cache) equal JAX's for
  qwen2.5-32b, deepseek-v3-671b, whisper-small, xlstm-125m and zamba2-7b;
  temperature sampling is deterministic under one generator seed (JAX's
  ``jax.random.categorical`` stream cannot be reproduced, so only greedy
  output is held to JAX).
* zamba2's shared attention: decode is windowed and the forward is not, as
  in JAX (ROADMAP R9), so past the window the two part.
* An entry point called without ``device="cpu"`` raises where no card is
  present; a session never writes past its cache.

JAX runs under ``jax.jit`` as its serving engine runs it; weights are
carried across with ``convert.params_from_numpy``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import schema as jschema
from repro.models import transformer as jT
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.models import attention as tattn
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

TOL = 1e-4
SERVED = sorted(jbase.smoke_registry())
B, S = 2, 10
CAP = 64           # no expert drops at S tokens a group


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
    return jax.tree_util.tree_map(leaf, schema, is_leaf=jschema.is_pspec)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(scale, 1.0))


def _assert_caches(got, want_jax):
    want = convert.cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, want_jax), device="cpu")
    _assert_cache_tree(got, want)


def _assert_cache_tree(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_cache_tree(got[k], want[k])
        return
    assert type(got) is type(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """Both configs, numpy weights and inputs (tokens, extras)."""
    jc, tc = jbase.get_smoke_config(name), tbase.get_smoke_config(name)
    params = _np_params(jT.build_schema(jc, 1), 7)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if jc.frontend == "audio_stub":
        extra["frame_embeds"] = rng.standard_normal(
            (B, jc.encoder_seq_len, jc.d_model)).astype(np.float32)
    return jc, tc, params, tokens, extra


def _port_params(name):
    return convert.params_from_numpy(_setup(name)[2], device="cpu")


def _jax_params(name):
    return jax.tree_util.tree_map(jnp.asarray, _setup(name)[2])


def _forward_batch(name):
    """The forward batch as numpy: qwen2-vl gets early-fused patch
    embeddings and three distinct M-RoPE position streams."""
    jc, _, _, tokens, extra = _setup(name)
    batch = {"tokens": tokens, **extra}
    if jc.frontend == "vision_stub":
        rng = np.random.default_rng(12)
        batch["patch_embeds"] = rng.standard_normal(
            (B, 3, jc.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        batch["positions"] = np.stack([pos, pos // 2, pos % 3])
    return batch


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    jc = _setup(name)[0]
    batch = {k: jnp.asarray(v) for k, v in _forward_batch(name).items()}
    fwd = jax.jit(lambda p, b: jT.forward(p, jc, b, capacity=CAP))
    logits, aux, mtp = fwd(_jax_params(name), batch)
    return (np.asarray(logits), tuple(np.asarray(a) for a in aux),
            None if mtp is None else np.asarray(mtp))


@functools.lru_cache(maxsize=None)
def _jax_decode(name):
    """JAX's per-step logits (B, S, V) and its final cache."""
    jc, _, _, tokens, extra = _setup(name)
    params = _jax_params(name)
    enc = None
    if "frame_embeds" in extra:
        enc = jT._run_encoder(params, jc, jnp.asarray(extra["frame_embeds"]))
    step = jengine.make_decode_fn(jc)
    cache = jT.init_cache(jc, B, S + 2)
    out = []
    for i in range(S):
        lg, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.asarray(i, jnp.int32), enc)
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, axis=1), cache, enc


def _port_batch(name):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _forward_batch(name).items()}


@pytest.mark.parametrize("name", SERVED)
def test_forward_matches_jax(name):
    tc = _setup(name)[1]
    logits, aux, mtp = tT.forward(_port_params(name), tc, _port_batch(name),
                                  capacity=CAP)
    jlogits, jaux, jmtp = _jax_forward(name)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, S, tc.padded_vocab())
    _close(logits, jlogits)
    for got, want in zip(aux, jaux):
        _close(got, want)
    if tc.mtp_heads:
        _close(mtp, jmtp)
    else:
        assert mtp is None and jmtp is None


@pytest.mark.parametrize("name", SERVED)
def test_decode_step_matches_jax_and_forward(name):
    jc, tc, _, tokens, extra = _setup(name)
    params = _port_params(name)
    enc = None
    if "frame_embeds" in extra:
        enc = tT._run_encoder(params, tc,
                              torch.from_numpy(extra["frame_embeds"]))
    want, jcache, jenc = _jax_decode(name)
    if enc is not None:
        _close(enc, jenc)
    cache = tT.init_cache(tc, B, S + 2, device="cpu")
    tok = torch.from_numpy(tokens)
    got = []
    for i in range(S):
        lg, cache = tT.decode_step(params, tc, tok[:, i:i + 1], cache,
                                   torch.tensor(i, dtype=torch.int32),
                                   enc_out=enc)
        got.append(lg[:, 0])
    got = torch.stack(got, dim=1)
    _close(got, want)
    _assert_caches(cache, jcache)
    # decode with the cache reproduces the teacher-forced forward
    batch = {"tokens": tok, **{k: torch.from_numpy(v)
                               for k, v in extra.items()}}
    full, _, _ = tT.forward(params, tc, batch, capacity=CAP)
    _close(got, full)


GEN_P, GEN_N = 5, 6


@functools.lru_cache(maxsize=None)
def _jax_generate(name):
    jc, _, _, tokens, extra = _setup(name)
    fe = extra.get("frame_embeds")
    sess = jengine.start_session(
        jc, _jax_params(name), B, GEN_P + GEN_N + 1,
        frame_embeds=None if fe is None else jnp.asarray(fe))
    out = jengine.generate(sess, jnp.asarray(tokens[:, :GEN_P]), GEN_N)
    return np.asarray(out), sess.cache


def _port_session(name, max_len=GEN_P + GEN_N + 1):
    _, tc, _, _, extra = _setup(name)
    fe = extra.get("frame_embeds")
    return tengine.start_session(
        tc, _port_params(name), B, max_len,
        frame_embeds=None if fe is None else torch.from_numpy(fe),
        device="cpu")


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "qwen2.5-32b",
                                  "whisper-small", "xlstm-125m",
                                  "zamba2-7b"])
def test_greedy_generate_matches_jax(name):
    tokens = _setup(name)[3]
    sess = _port_session(name)
    got = tengine.generate(sess, torch.from_numpy(tokens[:, :GEN_P]), GEN_N)
    want, jcache = _jax_generate(name)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, GEN_N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(sess.cur_len) == sess.filled == GEN_P + GEN_N
    _assert_caches(sess.cache, jcache)


def test_generate_logits_are_the_decode_steps():
    name = "qwen2.5-32b"
    tc, tokens = _setup(name)[1], _setup(name)[3]
    sess = _port_session(name)
    got, logits = tengine.generate(sess, torch.from_numpy(tokens[:, :GEN_P]),
                                   GEN_N, return_logits=True)
    assert tuple(logits.shape) == (B, GEN_P + GEN_N, tc.padded_vocab())
    # each generated token is the arg-max of the previous position's logits
    pick = logits[:, GEN_P - 1:-1, :tc.vocab_size].argmax(-1)
    assert torch.equal(pick.to(torch.int32), got)
    seq = torch.cat([torch.from_numpy(tokens[:, :GEN_P]), got[:, :-1]], 1)
    full, _, _ = tT.forward(_port_params(name), tc, {"tokens": seq})
    _close(logits[:, :-1], full)


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "starcoder2-7b"])
def test_temperature_sampling_is_deterministic(name):
    tc, tokens = _setup(name)[1], _setup(name)[3]
    prompt = torch.from_numpy(tokens[:, :GEN_P])
    runs = [tengine.generate(_port_session(name), prompt, GEN_N,
                             temperature=0.8, seed=seed)
            for seed in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    for r in runs:
        assert r.dtype == torch.int32
        assert bool(((r >= 0) & (r < tc.vocab_size)).all())


@pytest.mark.parametrize("window", [0, GEN_P + 2])
def test_generate_refuses_more_tokens_than_the_cache_holds(window):
    """A session holds ``max_len`` positions, or its sliding window's
    where that is shorter (the cache is cut to it), and refuses to write
    past them before any step runs."""
    _, tc, _, tokens, _ = _setup("qwen2.5-32b")
    cfg = dataclasses.replace(tc, sliding_window=window)
    sess = tengine.start_session(cfg, _port_params("qwen2.5-32b"), B,
                                 GEN_P + 2 if not window else 4 * GEN_P,
                                 device="cpu")
    assert sess.max_len == GEN_P + 2
    assert sess.cache["seg0"]["pos0"].k.shape[3] == GEN_P + 2
    with pytest.raises(IndexError, match="do not fit"):
        tengine.generate(sess, torch.from_numpy(tokens[:, :GEN_P]), 3)
    assert sess.filled == 0
    tengine.generate(sess, torch.from_numpy(tokens[:, :GEN_P]), 2)
    assert sess.filled == GEN_P + 2


def test_zamba2_shared_attention_is_windowed_in_decode_only():
    """zamba2's shared block runs after every ``attn_every``-th layer under
    ``sliding_window`` in decode and unwindowed in the forward (JAX's
    ``transformer.py:193, 407``): within the window the two agree, past it
    they part, and JAX's decode parts the same way."""
    name = "zamba2-7b"
    jc, tc, _, tokens, _ = _setup(name)
    window = 4
    jcw = dataclasses.replace(jc, sliding_window=window)
    tcw = dataclasses.replace(tc, sliding_window=window)
    params = _port_params(name)
    tok = torch.from_numpy(tokens)
    cache = tT.init_cache(tcw, B, S, device="cpu")
    # the window caps the shared block's cache; the SSM states are per step
    assert cache["shared_attn"].k.shape[:4] == (2, B, tc.num_kv_heads,
                                                window)
    cache = tT.init_cache(tcw, B, window, device="cpu")
    got = []
    for i in range(window):
        lg, cache = tT.decode_step(params, tcw, tok[:, i:i + 1], cache,
                                   torch.tensor(i, dtype=torch.int32))
        got.append(lg[:, 0])
    full, _, _ = tT.forward(params, tcw, {"tokens": tok})
    _close(torch.stack(got, 1), full[:, :window])
    # past the window: a decode with a cache of S slots, masked to the
    # window, against JAX's decode of the same
    step = jengine.make_decode_fn(jcw)
    jp = _jax_params(name)
    jcache = jT.init_cache(jc, B, S)       # S slots: the mask does the window
    tcache = tT.init_cache(tc, B, S, device="cpu")
    want, got = [], []
    for i in range(S):
        jl, jcache = step(jp, jcache, jnp.asarray(tokens[:, i:i + 1]),
                          jnp.asarray(i, jnp.int32), None)
        tl, tcache = tT.decode_step(params, tcw, tok[:, i:i + 1], tcache,
                                    torch.tensor(i, dtype=torch.int32))
        want.append(np.asarray(jl[:, 0]))
        got.append(tl[:, 0])
    got = torch.stack(got, 1)
    _close(got, np.stack(want, 1))
    assert (got[:, window:] - full[:, window:]).abs().max() > 1e-3


ENTRY_POINTS = {
    "init_params": lambda cfg: tschema.init_params(
        tT.build_schema(cfg), torch.Generator(), torch.float32),
    "init_cache": lambda cfg: tT.init_cache(cfg, 1, 8),
    "start_session": lambda cfg: tengine.start_session(cfg, {}, 1, 8),
    "params_from_numpy": lambda cfg: convert.params_from_numpy(
        {"w": np.zeros(2, np.float32)}),
    "cache_from_numpy": lambda cfg: convert.cache_from_numpy(
        {"seg0": {"pos0": tattn.KVCache(np.zeros(2), np.zeros(2))}}),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_by_default(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](tbase.get_smoke_config("qwen2.5-32b"))
