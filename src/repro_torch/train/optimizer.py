"""AdamW with a cosine schedule and global-norm clipping, functional on the
parameter tree.

  * optimizer state dtype knob (``bfloat16`` m/v for the ≥100B archs — halves
    the dominant memory term; updates computed in float32 regardless),
  * global-norm clipping with the norm computed once over every leaf, in
    sorted-key order, and
  * a pure functional API: (grads, state, params) → (new_params, new_state).

The arithmetic is the JAX package's, in float32 with each Python constant
rounded to float32 first (``b1 ** step`` is taken on a float32 tensor, not
a Python float).  Decay applies to every leaf of two or more dimensions,
as JAX's ``p.ndim >= 2``: with a segment's layer axis that includes its
norm scales and biases (ROADMAP R8), while ``final_norm`` is not decayed.

The state shards like its param (``state_specs``), or under ZeRO with
``embed`` over data(+pod) as well (``zero_state_specs``); ``init_state``
lays each moment out as its param is laid out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.schema import tree_leaves, tree_map
from repro_torch.models.sharding import laid_out_like


class AdamState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a float32 tensor on ``like``'s device (what ``jnp``
    makes of a weakly typed scalar beside a float32 array)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to lr_min; ``step`` an integer tensor."""
    warm = (_f32(cfg.lr_peak, step) * (step + 1).float()
            / _f32(max(cfg.warmup_steps, 1), step))
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
                    0.0, 1.0)
    cos = _f32(cfg.lr_min, step) + \
        _f32(0.5 * (cfg.lr_peak - cfg.lr_min), step) * \
        (1 + torch.cos(_f32(math.pi, step) * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(cfg: AdamWConfig, params) -> AdamState:
    dt = getattr(torch, cfg.state_dtype)
    leaf = tree_leaves(params)[0]
    return AdamState(
        torch.zeros((), dtype=torch.int32, device=leaf.device),
        tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
        tree_map(lambda p: torch.zeros_like(p, dtype=dt), params))


def state_specs(param_specs) -> AdamState:
    """State shards exactly like its param."""
    from repro_torch.models.sharding import P
    return AdamState(P(), param_specs, param_specs)


def zero_state_specs(schema, rules, *, multi_pod: bool) -> AdamState:
    """ZeRO: the state shards like its param and also ``embed`` over
    data(+pod), whether or not the params do."""
    from repro_torch.models.sharding import specs_from_schema
    zero = dict(rules, embed=("pod", "data") if multi_pod else ("data",))
    return state_specs(specs_from_schema(schema, zero))


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    sq = torch.square(leaves[0].float()).sum()
    for x in leaves[1:]:
        sq = sq + torch.square(x.float()).sum()
    return torch.sqrt(sq)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, grads, state: AdamState, params):
    """Returns (new_params, new_state, metrics dict).  On a mesh the update
    runs in each moment's layout: a gradient is taken there first (its
    partial sums reduced, and scattered where ZeRO shards the state) and a
    new parameter goes back to its own layout."""
    grads = unflatten(grads, [laid_out_like(g, m) for g, m in zip(
        tree_leaves(grads), tree_leaves(state.mu))])
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gnorm), _f32(cfg.clip_norm, gnorm)
                          / torch.maximum(gnorm, _f32(1e-9, gnorm)))
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1c = 1 - torch.pow(_f32(cfg.b1, gnorm), step.float())
    b2c = 1 - torch.pow(_f32(cfg.b2, gnorm), step.float())
    sd = getattr(torch, cfg.state_dtype)
    b1, nb1 = _f32(cfg.b1, gnorm), _f32(1 - cfg.b1, gnorm)
    b2, nb2 = _f32(cfg.b2, gnorm), _f32(1 - cfg.b2, gnorm)
    eps, wd = _f32(cfg.eps, gnorm), _f32(cfg.weight_decay, gnorm)

    def upd(g, m, v, p_own):
        p = laid_out_like(p_own, m)
        g = g.float() * scale
        m32 = b1 * m.float() + nb1 * g
        v32 = b2 * v.float() + nb2 * g * g
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + eps)
        if p.dim() >= 2:  # decoupled weight decay on "matrices" (see R8)
            delta = delta + wd * p.float()
        newp = laid_out_like((p.float() - lr * delta).to(p.dtype), p_own)
        return newp, m32.to(sd), v32.to(sd)

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
        tree_leaves(params))]
    new_p, new_m, new_v = (unflatten(params, [o[i] for o in out])
                           for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamState(step, new_m, new_v), metrics


def unflatten(like, leaves: list):
    """A tree shaped like ``like`` holding ``leaves`` in sorted-key order
    (the order of ``tree_leaves``)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
