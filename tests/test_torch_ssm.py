"""The port's recurrent blocks (``models/ssm.py``) against the JAX package's,
at smoke width, float32.

* ``ssd_chunk_scan`` with S not a multiple of ``chunk`` and over more than
  one chunk, from a zero and from a carried state; ``ssd_decode_step``;
  ``causal_conv`` and ``causal_conv_step``.
* Mamba2 (zamba2), mLSTM and sLSTM (xlstm): each block's forward, and its
  decode step by step with its cache, against JAX's; the port's decode
  reproduces its own forward.

Results within 1e-5 relative plus 1e-5 × the result's largest |value| of
JAX's (1e-4 for the cache states carried across many steps).  JAX runs
under ``jax.jit``; parameters cross with ``convert.params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import schema as jschema
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

TOL = 1e-5
STATE_TOL = 1e-4


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(scale, 1.0))


def _rand(shape, seed, scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _np_params(schema, seed):
    """Random numpy parameters: normal leaves at 1/sqrt(fan_in) (or the
    spec's scale), ones and zeros perturbed so that norms and biases act."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        x = rng.standard_normal(spec.shape).astype(np.float32)
        if spec.init == "ones":
            return 1.0 + 0.1 * x
        if spec.init == "zeros":
            return 0.1 * x
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else 1 / np.sqrt(fan_in)
        return x * np.float32(scale)
    return jax.tree_util.tree_map(leaf, schema, is_leaf=jschema.is_pspec)


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"))


# --------------------------------------------------------------------------- #
# the shared scan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s,chunk,carried", [(37, 16, False), (32, 16, True),
                                             (5, 8, False)])
def test_ssd_chunk_scan_matches_jax(s, chunk, carried):
    b, h, p, n = 2, 3, 5, 4
    jx, tx = _rand((b, s, h, p), 1)
    jdt, tdt = (a.__abs__() for a in _rand((b, s, h), 2, 0.5))
    jb, tb = _rand((b, s, h, n), 3)
    jc, tc = _rand((b, s, h, n), 4)
    jda, tda = (-a.__abs__() for a in _rand((b, s, h), 5, 0.3))
    js0, ts0 = _rand((b, h, n, p), 6) if carried else (
        jnp.zeros((b, h, n, p)), torch.zeros((b, h, n, p)))
    jy, jst = jax.jit(jssm.ssd_chunk_scan, static_argnums=5)(
        jx, jdt, jb, jc, jda, chunk, js0)
    ty, tst = tssm.ssd_chunk_scan(tx, tdt, tb, tc, tda, chunk, ts0)
    assert ty.dtype == tst.dtype == torch.float32
    assert tuple(ty.shape) == (b, s, h, p)
    _close(ty, jy)
    _close(tst, jst)


def test_ssd_decode_step_and_conv_match_jax():
    b, h, p, n = 2, 3, 5, 4
    js, ts = _rand((b, h, n, p), 7)
    jx, tx = _rand((b, h, p), 8)
    jdt, tdt = _rand((b, h), 9)
    jb, tb = _rand((b, h, n), 10)
    jc, tc = _rand((b, h, n), 11)
    ja, ta = (-a.__abs__() for a in _rand((b, h), 12))
    jy, js_new = jax.jit(jssm.ssd_decode_step)(js, jx, jdt, jb, jc, ja)
    state = ts.clone()
    ty, ts_new = tssm.ssd_decode_step(state, tx, tdt, tb, tc, ta)
    assert ts_new is state          # updated in place
    _close(ty, jy)
    _close(ts_new, js_new)

    c, width, s = 6, tssm.CONV_W, 9
    jxs, txs = _rand((b, s, c), 13)
    jw, tw = _rand((width, c), 14)
    jbias, tbias = _rand((c,), 15)
    _close(tssm.causal_conv(txs, tw, tbias),
           jax.jit(jssm.causal_conv)(jxs, jw, jbias))
    jst, tst = _rand((b, width - 1, c), 16)
    jy, jst_new = jax.jit(jssm.causal_conv_step)(jst, jxs[:, 0], jw, jbias)
    conv = tst.clone()
    ty, conv_new = tssm.causal_conv_step(conv, txs[:, 0], tw, tbias)
    assert conv_new is conv
    _close(ty, jy)
    _close(conv_new, jst_new)


# --------------------------------------------------------------------------- #
# the three blocks
# --------------------------------------------------------------------------- #
# (config, schema, forward, decode, cache init, extra config fields)
BLOCKS = {
    "mamba": ("zamba2-7b", "mamba_schema", "mamba_forward", "mamba_decode",
              "init_mamba_cache", {}),
    "mlstm": ("xlstm-125m", "mlstm_schema", "mlstm_forward", "mlstm_decode",
              "init_mlstm_cache", {}),
    "slstm": ("xlstm-125m", "slstm_schema", "slstm_forward", "slstm_decode",
              "init_slstm_cache", {}),
    # more than one chunk of 16, the last one padded
    "mamba-chunks": ("zamba2-7b", "mamba_schema", "mamba_forward",
                     "mamba_decode", "init_mamba_cache", {"ssm_chunk": 8}),
    "mlstm-chunks": ("xlstm-125m", "mlstm_schema", "mlstm_forward",
                     "mlstm_decode", "init_mlstm_cache", {"ssm_chunk": 8}),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_forward_and_decode_match_jax(block):
    name, sch, fwd, dec, init, kw = BLOCKS[block]
    jcfg = dataclasses.replace(jbase.get_smoke_config(name), **kw)
    tcfg = dataclasses.replace(tbase.get_smoke_config(name), **kw)
    jp, tp = _both(_np_params(getattr(jssm, sch)(jcfg), 21))
    b, s = 2, 19
    jx, tx = _rand((b, s, jcfg.d_model), 22)
    jy = jax.jit(lambda p, x: getattr(jssm, fwd)(p, jcfg, x))(jp, jx)
    ty = getattr(tssm, fwd)(tp, tcfg, tx)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == (b, s,
                                                             jcfg.d_model)
    _close(ty, jy)

    jdec = jax.jit(lambda p, x, c: getattr(jssm, dec)(p, jcfg, x, c))
    jcache = getattr(jssm, init)(jcfg, b, jnp.float32)
    tcache = getattr(tssm, init)(tcfg, b, torch.float32, "cpu")
    steps = []
    for i in range(s):
        jo, jcache = jdec(jp, jx[:, i:i + 1], jcache)
        to, tc_new = getattr(tssm, dec)(tp, tcfg, tx[:, i:i + 1], tcache)
        assert all(a is b_ for a, b_ in zip(tc_new, tcache))  # in place
        _close(to, jo)
        steps.append(to)
    for got, want in zip(tcache, jcache):
        _close(got, want, STATE_TOL)
    # decode with the carried state reproduces the full-sequence forward
    _close(torch.cat(steps, dim=1), ty)


def test_slstm_scan_gradient_equals_the_recorded_cells():
    """The sLSTM scan's hand-written backward against autograd through the
    cell recorded step by step (float32, the same ops forward): the
    forward bit for bit, the gradients within summation order."""
    rng = np.random.default_rng(31)
    b, s, h, dh = 2, 23, 3, 4
    gx0 = torch.from_numpy((2 * rng.standard_normal((b, s, h, dh, 4))).astype(
        np.float32))
    r0 = torch.from_numpy((0.5 * rng.standard_normal((h, dh, 4 * dh))).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(
        np.float32))
    gx, r = gx0.clone().requires_grad_(), r0.clone().requires_grad_()
    zero = torch.zeros((b, h, dh))
    carry, hs = tssm.SLSTMCache(zero, zero, zero, zero), []
    for t in range(s):
        carry = tssm._slstm_cell(carry, gx[:, t], r)
        hs.append(carry.h)
    ref = torch.stack(hs, 1)
    want = torch.autograd.grad((ref * w).sum(), [gx, r])
    gx2, r2 = gx0.clone().requires_grad_(), r0.clone().requires_grad_()
    got_h = tssm._SLSTMScan.apply(gx2, r2)
    assert torch.equal(got_h, ref.detach())
    got = torch.autograd.grad((got_h * w).sum(), [gx2, r2])
    for g, want_g in zip(got, want):
        _close(g, want_g)
