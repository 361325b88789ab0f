"""Declarative parameter schema: one source of truth for shapes, logical
sharding axes, and initialization.

Every model builds a nested dict of ``PSpec`` leaves.  From the same tree we
derive (a) materialized params (``init_params``), (b) shape-only ``meta``
tensors (``abstract_params``), and (c) the logical-axis tree
(``logical_axes``) a mesh layout would read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core.csr import resolve_device


@dataclasses.dataclass(frozen=True)
class PSpec:
    """A parameter leaf: shape + logical axes + init style."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]      # logical axis names, len == len(shape)
    init: str = "normal"              # "normal" | "zeros" | "ones" | "embed"
    scale: float | None = None        # fan-in override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_pspec(x: Any) -> bool:
    return isinstance(x, PSpec)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict (``PSpec`` leaves or
    tensors), keeping the dict structure; keys are visited sorted, as JAX
    flattens a dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _leaf_init(spec: PSpec, generator: torch.Generator, dtype,
               device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "embed":
        scale = 0.02
    else:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = (spec.scale if spec.scale is not None
                 else 1.0 / math.sqrt(max(fan_in, 1)))
    # drawn in ``dtype`` on ``device``: no float32 copy of a large tree
    out = torch.randn(spec.shape, generator=generator, dtype=dtype,
                      device=device)
    return out.mul_(scale)


def init_params(schema: dict, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Materialize a schema tree into tensors on ``device`` (default: the
    CUDA card; ``device="cpu"`` for the host), deterministic in the
    generator's seed.  ``generator`` must live on that device."""
    dev = resolve_device(device)
    return tree_map(lambda l: _leaf_init(l, generator, dtype, dev), schema)


def abstract_params(schema: dict, dtype=torch.float32) -> dict:
    """Shape-only tree of ``meta`` tensors (no allocation)."""
    return tree_map(lambda l: torch.empty(l.shape, dtype=dtype,
                                          device="meta"), schema)


def logical_axes(schema: dict) -> dict:
    """Tree of logical-axis tuples (same structure as params)."""
    return tree_map(lambda l: l.axes, schema)


def param_count(schema: dict) -> int:
    return int(sum(math.prod(l.shape) for l in tree_leaves(schema)))


def param_bytes(params: dict) -> int:
    """Bytes held by a materialized parameter tree."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(params)))


def stack_layers(layer_schema: dict, n: int) -> dict:
    """Prepend a stacked ('layers') axis to every leaf — stacked-layer
    params, one slice a repeat of the segment."""
    return tree_map(
        lambda l: PSpec((n,) + l.shape, ("layers",) + l.axes, l.init, l.scale),
        layer_schema)
