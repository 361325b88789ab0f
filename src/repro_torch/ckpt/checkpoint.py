"""Atomic, mesh-agnostic checkpointing in the JAX package's on-disk format.

  * **atomic two-phase commit** — the shard file and the manifest are
    written to a ``.tmp`` step directory and fsync'd, then the directory is
    renamed; a crash mid-write never corrupts the latest checkpoint, and a
    leftover ``.tmp`` is never read.
  * **one format for both packages** — ``step_%010d/`` holding one
    ``shard_0.npz`` (leaf ``i`` as array ``a{i}``) and ``manifest.json``
    with ``step``, ``index`` (each leaf's key, ``idx``, ``shape`` and
    ``dtype``), ``shards`` and ``extra``.  Keys are JAX's pytree paths: dict
    keys sorted, a named tuple's field names, a tuple's indices, joined by
    ``/`` (``(params, AdamState)`` gives ``0/seg0/...``, ``1/step``,
    ``1/mu/...``).  A bfloat16 leaf is stored as its 2-byte payload
    (``|V2``, which is what ``np.savez`` writes for JAX's bfloat16) and
    read back by the manifest's ``dtype``, so no ``ml_dtypes`` is needed,
    and the port reads JAX's bfloat16 checkpoints (which JAX itself cannot
    restore, ROADMAP R7).
  * **pipeline state inside the checkpoint** — step and seed travel with the
    params, so a restart resumes the exact batch stream (the data pipeline
    is pure in (seed, step)).
  * retention: keep the newest ``keep`` checkpoints, delete older ones.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

BF16 = "bfloat16"


class CheckpointMismatchError(ValueError):
    """The checkpoint does not hold the target tree's keys or shapes."""


def _flatten(tree, path=()):
    """[(key string, leaf)] in JAX's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in _flatten(v, path + (name,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _rebuild(tree, fn, path=()):
    """``tree``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], fn, path + (str(k),)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, fn, path + (name,))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(the array to store, its manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), BF16
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_leaves(tree) -> list[tuple[str, np.ndarray, str]]:
    """The tree copied to the host: [(key, array, dtype name)]."""
    return [(key,) + _to_host(leaf) for key, leaf in _flatten(tree)]


def _write(ckpt_dir: str, step: int, leaves, extra, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = [dict(key=key, idx=i, shape=list(arr.shape), dtype=dtype)
             for i, (key, arr, dtype) in enumerate(leaves)]
    with open(os.path.join(tmp, "shard_0.npz"), "wb") as f:
        np.savez(f, **{f"a{i}": arr for i, (_, arr, _) in enumerate(leaves)})
        f.flush()
        os.fsync(f.fileno())
    manifest = dict(step=step, index=index, shards=["shard_0.npz"],
                    extra=extra or {})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)  # atomic commit
    _retain(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomically save ``tree`` (params/opt state/…; tensors on any device,
    or numpy arrays) at ``step``.  Returns the step directory."""
    return _write(ckpt_dir, step, _host_leaves(tree), extra, keep)


class _AsyncSave(threading.Thread):
    """One background write; ``join_checked`` re-raises its failure."""

    def __init__(self, *args):
        super().__init__(daemon=True)
        self.args_ = args
        self.error: BaseException | None = None

    def run(self):
        try:
            _write(*self.args_)
        except BaseException as e:  # handed to the thread that joins
            self.error = e

    def join_checked(self):
        self.join()
        if self.error is not None:
            raise self.error


_ASYNC: dict[str, _AsyncSave] = {}
_ASYNC_LOCK = threading.Lock()


def save_async(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
               keep: int = 3) -> threading.Thread:
    """Non-blocking checkpoint: snapshot to the host, write in a daemon
    thread.

    The caller resumes right after the device→host copy; the atomic rename
    still guarantees crash consistency.  ``wait_async`` joins the in-flight
    write of ``ckpt_dir`` (call it before shutdown; the next ``save_async``
    to the same directory calls it first)."""
    wait_async(ckpt_dir)
    t = _AsyncSave(ckpt_dir, step, _host_leaves(tree), extra, keep)
    with _ASYNC_LOCK:
        _ASYNC[ckpt_dir] = t
    t.start()
    return t


def wait_async(ckpt_dir: str) -> None:
    """Join the in-flight write of ``ckpt_dir``, raising what it raised."""
    with _ASYNC_LOCK:
        t = _ASYNC.pop(ckpt_dir, None)
    if t is not None:
        t.join_checked()


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(ckpt_dir: str, target_tree, *, step: int | None = None):
    """Restore into the structure of ``target_tree`` (keys and shapes must
    match; each leaf takes its target's dtype and device, and a target leaf
    on the ``meta`` device is restored on the host).

    Returns (tree, extra, step); raises ``CheckpointMismatchError`` where
    the checkpoint lacks a key of the target or holds another shape."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        by_key = {e["key"]: (data[f"a{e['idx']}"], e["dtype"])
                  for e in manifest["index"]}

    def leaf(key, target):
        if key not in by_key:
            raise CheckpointMismatchError(f"checkpoint missing {key}")
        arr, dtype = by_key[key]
        if tuple(arr.shape) != tuple(target.shape):
            raise CheckpointMismatchError(
                f"{key}: shape {tuple(arr.shape)} in the checkpoint, "
                f"{tuple(target.shape)} in the target")
        dev = "cpu" if target.device.type == "meta" else target.device
        return _from_host(arr, dtype).to(device=dev, dtype=target.dtype)

    tree = _rebuild(target_tree, leaf)
    return tree, manifest.get("extra", {}), step
