"""The port's checkpoints (``ckpt/checkpoint.py``) against the JAX package's
format.

* A ``(params, AdamState)`` tree with float32, bfloat16 and int32 leaves
  round-trips bit for bit, onto the target's dtypes and device; the
  manifest's keys, shapes and dtypes equal those JAX writes for the same
  tree (keys by JAX's ``_key_str``).
* Retention keeps the newest ``keep``; a ``.tmp`` directory (a write cut
  short) is never taken as the latest; ``save_async`` writes in the
  background, ``wait_async`` joins it and re-raises its failure; a target
  the checkpoint does not match raises ``CheckpointMismatchError``.
* A float32 checkpoint written by JAX is read by the port and the other way
  round; a bfloat16 one written by JAX is read by the port, which JAX's own
  restore cannot do (ROADMAP R7).
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"seg0": {"pos0": {"w": rng.standard_normal((2, 3, 4)).astype(
                np.float32), "scale": rng.standard_normal((2, 4)).astype(
                np.float32)}},
            "embed": {"tok": rng.standard_normal((5, 4)).astype(np.float32)},
            "final_norm": {"scale": rng.standard_normal(4).astype(
                np.float32)}}


def _port_state(params, state_dtype):
    st = topt.init_state(topt.AdamWConfig(state_dtype=state_dtype), params)
    # distinct moment values, so a swapped leaf shows
    return topt.AdamState(torch.tensor(12, dtype=torch.int32),
                          _map(lambda t: t + 0.5, st.mu),
                          _map(lambda t: t + 2, st.nu))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    return list(tckpt._flatten(tree))


def _assert_bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (key, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), key


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_and_keys_match_jax(tmp_path, dtype):
    params = convert.params_from_numpy(_np_tree(1), dtype=dtype,
                                       device="cpu")
    state = _port_state(params, "bfloat16" if dtype == torch.bfloat16
                        else "float32")
    d = tckpt.save(str(tmp_path / "t"), 12, (params, state),
                   extra={"seed": 3})
    assert os.path.basename(d) == "step_0000000012"
    target = (_map(torch.zeros_like, params),
              topt.AdamState(torch.zeros((), dtype=torch.int32),
                             _map(torch.zeros_like, state.mu),
                             _map(torch.zeros_like, state.nu)))
    (got_p, got_s), extra, step = tckpt.restore(str(tmp_path / "t"), target)
    assert step == 12 and extra == {"seed": 3}
    assert isinstance(got_s, topt.AdamState)
    _assert_bitwise((got_p, got_s), (params, state))

    # the same tree saved by JAX: one manifest, key for key
    jtree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.asarray(
                t.numpy()).dtype), (params, state._asdict()))
    jstate = jopt.AdamState(jtree[1]["step"], jtree[1]["mu"], jtree[1]["nu"])
    jd = jckpt.save(str(tmp_path / "j"), 12, (jtree[0], jstate),
                    extra={"seed": 3})
    mine, theirs = _manifest(d), _manifest(jd)
    assert mine == theirs
    assert {"0/seg0/pos0/w", "1/step", "1/mu/embed/tok",
            "1/nu/final_norm/scale"} <= {e["key"] for e in mine["index"]}
    # and the payloads are the same bytes
    with np.load(os.path.join(d, "shard_0.npz")) as a, \
            np.load(os.path.join(jd, "shard_0.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype.str == b[k].dtype.str
            assert a[k].tobytes() == b[k].tobytes()


def test_restore_takes_target_dtype_and_meta_leaves_stay_on_host(tmp_path):
    params = convert.params_from_numpy(_np_tree(2), device="cpu")
    tckpt.save(str(tmp_path), 1, params)
    target = _map(lambda t: torch.empty(t.shape, dtype=torch.float64,
                                        device="meta"), params)
    got, _, _ = tckpt.restore(str(tmp_path), target)
    for (key, g), (_, w) in zip(_leaves(got), _leaves(params)):
        assert g.device.type == "cpu" and g.dtype == torch.float64, key
        assert torch.equal(g, w.double())


def test_retention_tmp_and_mismatch(tmp_path):
    params = convert.params_from_numpy(_np_tree(3), device="cpu")
    root = str(tmp_path)
    assert tckpt.latest_step(root + "/none") is None
    for step in (1, 2, 3, 4):
        tckpt.save(root, step, params, keep=2)
    assert sorted(os.listdir(root)) == ["step_0000000003",
                                        "step_0000000004"]
    # a write cut short leaves a .tmp directory: never the latest
    os.makedirs(os.path.join(root, "step_0000000009.tmp"))
    # a step directory without its manifest is not complete either
    os.makedirs(os.path.join(root, "step_0000000008"))
    assert tckpt.latest_step(root) == 4
    _, _, step = tckpt.restore(root, params)
    assert step == 4
    # a later save at the .tmp's step replaces it
    tckpt.save(root, 9, params, keep=5)
    assert tckpt.latest_step(root) == 9
    assert not os.path.exists(os.path.join(root, "step_0000000009.tmp"))
    with pytest.raises(tckpt.CheckpointMismatchError, match="missing"):
        tckpt.restore(root, {"other": params["embed"]["tok"]})
    with pytest.raises(tckpt.CheckpointMismatchError, match="shape"):
        tckpt.restore(root, _map(lambda t: torch.zeros(t.shape + (1,)),
                                 params))
    with pytest.raises(FileNotFoundError):
        tckpt.restore(root + "/none", params)


def test_async_save_and_its_failure(tmp_path):
    params = convert.params_from_numpy(_np_tree(4), device="cpu")
    root = str(tmp_path / "a")
    t = tckpt.save_async(root, 5, params)
    tckpt.wait_async(root)
    assert not t.is_alive()
    assert tckpt.latest_step(root) == 5
    got, _, _ = tckpt.restore(root, _map(torch.zeros_like, params))
    _assert_bitwise(got, params)
    tckpt.wait_async(root)                   # nothing in flight: a no-op
    # a write that fails is raised where it is joined
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    tckpt.save_async(str(blocked), 1, params)
    with pytest.raises(OSError):
        tckpt.wait_async(str(blocked))


def test_float32_checkpoints_cross_both_ways(tmp_path):
    tree = _np_tree(5)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init_state(jopt.AdamWConfig(), jparams)
    jstate = jstate._replace(step=jnp.asarray(3, jnp.int32),
                             mu=jax.tree_util.tree_map(lambda a: a + 1,
                                                       jstate.mu))
    jckpt.save(str(tmp_path / "j"), 3, (jparams, jstate))
    tparams = convert.params_from_numpy(tree, device="cpu")
    tstate = topt.init_state(topt.AdamWConfig(), tparams)
    (gp, gs), _, step = tckpt.restore(str(tmp_path / "j"), (tparams, tstate))
    assert step == 3 and int(gs.step) == 3
    want = (tparams, topt.AdamState(
        torch.tensor(3, dtype=torch.int32),
        _map(lambda t: t + 1, tstate.mu), tstate.nu))
    _assert_bitwise((gp, gs), want)

    tckpt.save(str(tmp_path / "t"), 7, want)
    (jp, js), _, jstep = jckpt.restore(str(tmp_path / "t"),
                                       (jparams, jstate))
    assert jstep == 7 and int(js.step) == 3
    for (key, a), (_, b) in zip(_leaves((gp, gs)),
                                _leaves(jax.tree_util.tree_map(
                                    lambda x: torch.from_numpy(
                                        np.array(x)), (jp, js)))):
        assert torch.equal(a, b), key


def test_jax_bfloat16_checkpoint_is_read_by_the_port(tmp_path):
    tree = _np_tree(6)
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    jckpt.save(str(tmp_path), 2, jparams)
    target = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    zeros = _map(torch.zeros_like, target)
    got, _, step = tckpt.restore(str(tmp_path), zeros)
    assert step == 2
    _assert_bitwise(got, target)
    # the 2-byte payload on disk is JAX's bfloat16 bit pattern
    with np.load(os.path.join(str(tmp_path), "step_0000000002",
                              "shard_0.npz")) as data:
        assert {data[k].dtype.str for k in data.files} == {"|V2"}
    assert np.asarray(jparams["embed"]["tok"]).dtype == ml_dtypes.bfloat16
