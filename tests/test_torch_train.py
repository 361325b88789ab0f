"""The port's training path against the JAX package's, at smoke width,
float32.

* ``data.pipeline.SyntheticLM``: batches equal JAX's bit for bit.
* ``train.optimizer``: ``schedule`` over warmup and decay, and
  ``apply_updates`` over several steps on the same numpy gradients (new
  parameters, moments, grad norm and lr) within 1e-6 relative, with float32
  and bfloat16 moments.
* ``train.train_loop``: ``cross_entropy`` with masked labels; ``loss_fn``
  and its gradients for xlstm-125m, zamba2-7b and deepseek-v3-671b (MoE
  auxiliary losses and the MTP term) within 1e-4 relative plus 1e-4 × each
  leaf's largest |grad|; a whole ``accum=2`` train step against JAX's
  ``accum=2``; remat ``full`` against ``none``: gradients equal.
* ``launch.train`` on the host: 3 steps and a restart for 3 more equal 6
  straight steps bit for bit; SIGTERM in a subprocess writes a checkpoint
  and exits 0; ``launch.serve`` restores that checkpoint.

JAX runs under ``jax.jit``; parameters cross with
``convert.params_from_numpy``.
"""
import dataclasses
import functools
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import pipeline as jdata
from repro.models import schema as jschema
from repro.models import transformer as jT
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import convert
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tdata
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import schema as tschema
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
OPT_TOL = 1e-6
B, S = 2, 20                 # more than one SSD chunk of the smoke configs
TRAINED = ("deepseek-v3-671b", "xlstm-125m", "zamba2-7b")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    want = _np(want).astype(np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got).astype(np.float32), want, rtol=tol,
                               atol=tol * max(scale, 1.0))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _close_trees(got, want, tol=TOL):
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        _close(fg[k], fw[k], tol)


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


@functools.lru_cache(maxsize=None)
def _setup(name):
    jc, tc = jbase.get_smoke_config(name), tbase.get_smoke_config(name)
    params = _np_params(jT.build_schema(jc, 1), 3)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels[0, -3:] = -1                      # masked positions
    return jc, tc, params, {"tokens": tokens, "labels": labels}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_batches_equal_jax(hosts):
    cfg = dict(vocab_size=300, seq_len=17, global_batch=4, seed=5)
    for host in range(hosts):
        j = jdata.SyntheticLM(jdata.DataConfig(**cfg), host, hosts)
        t = tdata.SyntheticLM(tdata.DataConfig(**cfg), host, hosts)
        for step in (0, 1, 9):
            jb, tb = j.batch(step), t.batch(step)
            assert sorted(jb) == sorted(tb)
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #
def test_schedule_matches_jax():
    cfg = dict(lr_peak=1e-3, lr_min=1e-4, warmup_steps=7, total_steps=40)
    steps = np.arange(0, 45, dtype=np.int32)
    want = jax.jit(lambda s: jopt.schedule(jopt.AdamWConfig(**cfg), s))(
        jnp.asarray(steps))
    got = topt.schedule(topt.AdamWConfig(**cfg), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    _close(got, want, OPT_TOL)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(state_dtype):
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "stack": {"scale": rng.standard_normal((3, 5)).astype(
                  np.float32)},
              "bias": rng.standard_normal((5,)).astype(np.float32)}
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5,
              state_dtype=state_dtype)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = convert.params_from_numpy(params, device="cpu")
    js, ts = jopt.init_state(jcfg, jp), topt.init_state(tcfg, tp)
    jstep = jax.jit(lambda g, s, p: jopt.apply_updates(jcfg, g, s, p))
    for i in range(4):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * (0.3 + i)).astype(
                np.float32), params)
        jp, js, jm = jstep(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tp, ts, tm = topt.apply_updates(
            tcfg, convert.params_from_numpy(grads, device="cpu"), ts, tp)
        _close_trees(tp, jp, OPT_TOL)
        _close_trees(ts.mu, jax.tree_util.tree_map(np.asarray, js.mu),
                     OPT_TOL)
        _close_trees(ts.nu, jax.tree_util.tree_map(np.asarray, js.nu),
                     OPT_TOL)
        assert int(ts.step) == int(js.step) == i + 1
        assert ts.mu["w"].dtype == getattr(torch, state_dtype)
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k], OPT_TOL)


def test_opt_state_crosses_from_jax():
    _, tc, params, _ = _setup("xlstm-125m")
    jstate = jopt.init_state(jopt.AdamWConfig(state_dtype="bfloat16"),
                             jax.tree_util.tree_map(jnp.asarray, params))
    jstate = jstate._replace(step=jnp.asarray(7, jnp.int32))
    got = convert.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert got.step.dtype == torch.int32 and int(got.step) == 7
    assert all(t.dtype == torch.bfloat16
               for t in tschema.tree_leaves(got.mu))
    assert sorted(_flat(got.nu)) == sorted(_flat(params))


# --------------------------------------------------------------------------- #
# loss and gradients
# --------------------------------------------------------------------------- #
def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(8)
    logits = (3 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    valid = rng.random((2, 7)) > 0.3
    for v in (None, valid):
        want = jtl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if v is None else jnp.asarray(v))
        got = ttl.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if v is None else torch.from_numpy(v))
        _close(got, want, 1e-6)
    none_valid = ttl.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   torch.zeros((2, 7), dtype=torch.bool))
    assert float(none_valid) == 0.0


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    jc, _, params, batch = _setup(name)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jtl.loss_fn(p, jc, b),
                                    has_aux=True))
    (loss, metrics), grads = fn(jax.tree_util.tree_map(jnp.asarray, params),
                                _jbatch(batch))
    return (np.asarray(loss), {k: np.asarray(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("name", TRAINED)
def test_loss_and_grads_match_jax(name):
    _, tc, params, batch = _setup(name)
    (loss, metrics), grads = ttl.grads_of(
        convert.params_from_numpy(params, device="cpu"), tc, _tbatch(batch))
    jloss, jmetrics, jgrads = _jax_grads(name)
    _close(loss, jloss)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        _close(metrics[k], jmetrics[k])
    if name == "deepseek-v3-671b":
        assert "mtp_ce" in metrics and float(metrics["moe_lb"]) > 0
    _close_trees(grads, jgrads)
    for g in tschema.tree_leaves(grads):
        assert g.dtype == torch.float32


def test_accum_train_step_matches_jax():
    name = "zamba2-7b"
    jc, tc, params, batch = _setup(name)
    # eps well above the gradients' rounding noise: at the first step Adam
    # moves each weight by ±lr by the sign of its gradient, so a gradient
    # within rounding of 0 would flip the step between the two packages
    kw = dict(lr_peak=1e-3, warmup_steps=1, total_steps=4, eps=1e-3)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jnew, jstate, jm = jax.jit(jtl.make_train_step(jc, jcfg, accum=2))(
        jp, jopt.init_state(jcfg, jp), _jbatch(batch))
    tp = convert.params_from_numpy(params, device="cpu")
    tnew, tstate, tm = ttl.make_train_step(tc, tcfg, accum=2)(
        tp, topt.init_state(tcfg, tp), _tbatch(batch))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k])
    _close_trees(tnew, jax.tree_util.tree_map(np.asarray, jnew))
    _close_trees(tstate.mu, jax.tree_util.tree_map(np.asarray, jstate.mu))
    assert int(tstate.step) == 1


def test_remat_full_equals_none():
    _, tc, params, batch = _setup("zamba2-7b")
    tp = convert.params_from_numpy(params, device="cpu")
    got = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tc, remat=remat)
        (loss, _), grads = ttl.grads_of(tp, cfg, _tbatch(batch))
        got[remat] = (loss, grads)
    for remat in ("full", "dots"):
        assert torch.equal(got[remat][0], got["none"][0])
        fa, fb = _flat(got[remat][1]), _flat(got["none"][1])
        for k in fb:
            assert torch.equal(fa[k], fb[k]), (remat, k)


# --------------------------------------------------------------------------- #
# the training entry point on the host
# --------------------------------------------------------------------------- #
TRAIN_ARGS = ["--arch", "xlstm-125m", "--smoke", "--batch", "2", "--seq",
              "20", "--warmup", "2", "--log-every", "1", "--device", "cpu"]


def _run_train(ckpt_dir, steps, ckpt_every):
    seen = {}

    def on_step(step, metrics, params, opt_state):
        seen[step] = float(metrics["loss"])
    first, last = ttrain.main(TRAIN_ARGS + [
        "--steps", str(steps), "--ckpt-dir", str(ckpt_dir),
        "--ckpt-every", str(ckpt_every)], on_step=on_step)
    return seen, (first, last)


def _checkpoint_arrays(ckpt_dir, step):
    d = os.path.join(str(ckpt_dir), f"step_{step:010d}")
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        return {k: data[k] for k in data.files}


def test_train_restart_equals_straight_run(tmp_path):
    """With ``--warmup 2`` the third step's learning rate is the peak
    whatever ``--steps`` is, so a first leg of 3 steps is the straight
    run's first three; the second leg resumes from its checkpoint."""
    straight, (first, last) = _run_train(tmp_path / "a", 6, 6)
    assert sorted(straight) == [1, 2, 3, 4, 5, 6]
    assert first == straight[1]
    assert last == pytest.approx(np.mean([straight[i] for i in range(2, 7)]))
    leg1, _ = _run_train(tmp_path / "b", 3, 3)
    assert tckpt.latest_step(str(tmp_path / "b")) == 3
    leg2, _ = _run_train(tmp_path / "b", 6, 3)
    assert sorted(leg2) == [4, 5, 6]
    assert {**leg1, **leg2} == straight          # losses bit for bit
    want = _checkpoint_arrays(tmp_path / "a", 6)
    got = _checkpoint_arrays(tmp_path / "b", 6)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_sigterm_writes_a_checkpoint_and_exits_0(tmp_path):
    ckpt_dir = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + TRAIN_ARGS +
        ["--steps", "100000", "--ckpt-dir", str(ckpt_dir), "--ckpt-every",
         "100000"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 50
        # wait for the loop to run (its first log line), then preempt
        line = proc.stdout.readline()
        assert line.startswith("[train] step"), line
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=max(deadline - time.time(), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "preemption checkpoint written" in out
    step = tckpt.latest_step(str(ckpt_dir))
    assert step is not None and step >= 1
    # the serving entry point restores it: (params, opt_state), then serves
    toks = tserve.main(["--arch", "xlstm-125m", "--smoke", "--batch", "2",
                        "--prompt-len", "3", "--gen", "4", "--ckpt-dir",
                        str(ckpt_dir), "--device", "cpu"])
    assert toks.shape == (2, 4)
    cfg = tbase.get_smoke_config("xlstm-125m")
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
