"""Carry state across from the JAX package, as plain numpy arrays.

A parity test runs ``repro`` and ``repro_torch`` on the very same operands,
bucket plan and sample rows, or attention inputs.  These helpers build the
port's objects from numpy arrays — what ``np.asarray`` gives for a JAX
array or a JAX-side dataclass field — so the port never sees a JAX object.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.binning import BinningPlan, RowBucket
from repro_torch.core.csr import CSRDevice, resolve_device


def csr_device_from_numpy(rpt, col, val, shape, device=None) -> CSRDevice:
    """The port's ``CSRDevice`` from a device CSR's arrays (capacity-padded
    ``col``/``val`` are taken as they are)."""
    dev = resolve_device(device)
    return CSRDevice(
        rpt=torch.from_numpy(np.array(rpt, dtype=np.int32)).to(dev),
        col=torch.from_numpy(np.array(col, dtype=np.int32)).to(dev),
        val=torch.from_numpy(np.array(val, dtype=np.float32)).to(dev),
        shape=(int(shape[0]), int(shape[1])))


def binning_plan_from_numpy(buckets, *, global_deg_a: int | None = None,
                            global_deg_b: int | None = None) -> BinningPlan:
    """The port's ``BinningPlan`` from per-bucket dicts with the keys
    ``rows, deg_a, deg_b, block_rows, route, tile_n, n_tiles, span``.

    Buckets partition the output rows, so the row count and the row →
    bucket map follow from them.  The global degree bounds only feed lane
    statistics; they default to the largest bucket bounds."""
    bks = tuple(RowBucket(rows=np.asarray(d["rows"], dtype=np.int32),
                          deg_a=int(d["deg_a"]), deg_b=int(d["deg_b"]),
                          block_rows=int(d["block_rows"]),
                          route=str(d["route"]), tile_n=int(d["tile_n"]),
                          n_tiles=int(d["n_tiles"]), span=int(d["span"]))
                for d in buckets)
    nrows = sum(b.n_rows for b in bks)
    row_bucket = np.zeros(nrows, dtype=np.int32)
    for i, b in enumerate(bks):
        row_bucket[b.rows] = i
    return BinningPlan(
        buckets=bks, nrows=nrows,
        global_deg_a=int(global_deg_a if global_deg_a is not None
                         else max((b.deg_a for b in bks), default=1)),
        global_deg_b=int(global_deg_b if global_deg_b is not None
                         else max((b.deg_b for b in bks), default=1)),
        row_bucket=row_bucket)


def dense_from_numpy(x, dtype=torch.float32, device=None) -> torch.Tensor:
    """A tensor of ``dtype`` from a float32 numpy array (attention's q, k,
    v), cast on the torch side: float32 → bfloat16/float16 rounds to
    nearest even, as ``jnp.asarray(x).astype(dtype)`` does, so both packages
    get the same inputs (numpy has no bfloat16)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(resolve_device(device)).to(dtype)


def _tensor_from_numpy(x, dtype, device) -> torch.Tensor:
    """One leaf: numpy's (or ``ml_dtypes``') array as a tensor, bfloat16
    carried bit for bit through its 16-bit pattern."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def params_from_numpy(tree, dtype=None, device=None):
    """The port's parameter tree from JAX parameters: a nested dict of
    numpy arrays (``np.asarray`` on each leaf).  ``dtype`` casts every leaf
    (default: keep each leaf's own); ``device`` defaults to the card."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dtype, dev) for k, v in tree.items()}
    return _tensor_from_numpy(tree, dtype, dev)


def _cache_types() -> dict:
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import MambaCache, MLSTMCache, SLSTMCache
    return {t.__name__: t for t in (KVCache, MambaCache, MLSTMCache,
                                    SLSTMCache)}


def cache_from_numpy(tree, dtype=None, device=None):
    """The port's cache tree from a JAX cache whose leaves went through
    ``np.asarray``: nested dicts of cache named tuples (``KVCache``,
    ``MambaCache``, ``MLSTMCache``, ``SLSTMCache``, matched by class name
    and fields) of stacked arrays.  ``dtype`` casts every leaf (the SSM
    states stay float32 only if it is None)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: cache_from_numpy(v, dtype, dev) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        cls = _cache_types().get(type(tree).__name__)
        if cls is None or tuple(cls._fields) != tuple(tree._fields):
            raise TypeError(f"no cache of the port matches "
                            f"{type(tree).__name__}{tuple(tree._fields)}")
        return cls(*(_tensor_from_numpy(a, dtype, dev) for a in tree))
    return _tensor_from_numpy(tree, dtype, dev)


def opt_state_from_numpy(state, device=None):
    """The port's ``AdamState`` from JAX's, its leaves through
    ``np.asarray``: ``step`` a 0-d int32 tensor, ``mu``/``nu`` parameter
    trees (bfloat16 moments bit for bit)."""
    from repro_torch.train.optimizer import AdamState
    dev = resolve_device(device)
    return AdamState(
        torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                     device=dev),
        params_from_numpy(state.mu, device=dev),
        params_from_numpy(state.nu, device=dev))
