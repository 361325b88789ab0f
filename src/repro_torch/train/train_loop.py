"""Loss and the train step factory.

The train step is a function (params, opt_state, batch) → (params,
opt_state, metrics), functional on the parameter tree: gradients come from
``torch.autograd`` over the tree's leaves, the update from
``optimizer.apply_updates``.  Gradient accumulation runs micro-batches in
sequence (activation memory bounded), in JAX's order: micro-batch 0's
gradients, the rest added in order, then divided by ``accum``.
"""
from __future__ import annotations

import torch

from repro_torch.models import sharding
from repro_torch.models import transformer as tmod
from repro_torch.models.schema import tree_leaves, tree_map
from . import optimizer as opt_mod

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3
MTP_WEIGHT = 0.3


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over valid positions; logits fp32 (B,S,Vp), labels (B,S).
    Inside a mesh the vocab stays sharded: the log-sum-exp takes a max and
    a sum reduced across the shards."""
    if sharding.ambient_mesh() is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        m = logits.detach().amax(-1, keepdim=True)
        lse = (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))[
            ..., 0]
        gold = _gold_sharded(logits, labels)
    ce = lse - gold
    if valid is None:
        valid = torch.ones_like(ce, dtype=torch.bool)
    denom = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, ce, torch.zeros_like(ce)).sum() / denom


def _gold_sharded(logits, labels):
    """Each position's logit of its label, the vocab sharded: each rank
    picks the labels in its shard and the picks are summed across them."""
    bx, vx = sharding.axes_of(logits, 0), sharding.axes_of(logits, -1)
    v0 = sharding.mesh_offset(logits, -1)

    def pick(lg, y):
        at = y.long() - v0
        inside = (at >= 0) & (at < lg.shape[-1])
        g = torch.gather(lg, -1, at.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(inside, g[..., 0], torch.zeros_like(g[..., 0]))
    return sharding.local_map(pick, (logits, labels),
                              (sharding.P(bx, None, vx), sharding.P(bx, None)),
                              sharding.P(bx, None), partial=vx)


def loss_fn(params, cfg, batch, *, capacity: int | None = None):
    """(loss, metrics): CE, plus the MoE auxiliary losses and deepseek's
    MTP term where the config has them."""
    logits, aux, mtp_logits = tmod.forward(params, cfg, batch,
                                           capacity=capacity)
    labels = batch["labels"]
    valid = labels >= 0
    labels = torch.clamp(labels, min=0)
    ce = cross_entropy(logits, labels, valid)
    loss = ce + MOE_LB_WEIGHT * aux.moe_lb + MOE_Z_WEIGHT * aux.moe_z
    metrics = {"ce": ce, "moe_lb": aux.moe_lb, "moe_dropped": aux.moe_dropped}
    if mtp_logits is not None:  # deepseek MTP: position i predicts token i+2
        labels2 = sharding.roll_rows(labels, -1)
        s = labels.shape[1]
        valid2 = valid & sharding.replicated_like(
            torch.arange(s, device=labels.device) < s - 1, valid)
        mtp_ce = cross_entropy(mtp_logits, labels2, valid2)
        loss = loss + MTP_WEIGHT * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def grads_of(params, cfg, batch, *, capacity: int | None = None):
    """((loss, metrics), grads): gradients of ``loss_fn`` for every leaf of
    ``params`` (zeros where a leaf does not reach the loss), in each leaf's
    dtype; metrics detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = opt_mod.unflatten(params, leaves)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, cfg, batch, capacity=capacity)
        loss = sharding.replicate(loss)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: sharding.replicate(v.detach()) for k, v in metrics.items()}
    return (loss.detach(), metrics), opt_mod.unflatten(params, grads)


def _micro(batch: dict, accum: int, i: int) -> dict:
    """Micro-batch ``i`` of ``accum``: each array's leading axis cut into
    ``accum`` equal parts (as JAX reshapes it)."""
    return {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: opt_mod.AdamWConfig, *,
                    capacity: int | None = None, accum: int = 1):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics)."""

    def train_step(params, opt_state, batch):
        (_, metrics), grads = grads_of(params, cfg, _micro(batch, accum, 0),
                                       capacity=capacity)
        for i in range(1, accum):
            (_, m), g = grads_of(params, cfg, _micro(batch, accum, i),
                                 capacity=capacity)
            grads = opt_mod.unflatten(grads, [
                a + b for a, b in zip(tree_leaves(grads), tree_leaves(g))])
            metrics = {k: metrics[k] + m[k] for k in metrics}
        if accum > 1:
            grads = tree_map(lambda g: g / _scalar(accum, g), grads)
            metrics = {k: v / _scalar(accum, v) for k, v in metrics.items()}
        new_params, new_state, om = opt_mod.apply_updates(
            opt_cfg, grads, opt_state, params)
        metrics.update(om)
        return new_params, new_state, metrics

    return train_step


def _scalar(n: int, like: torch.Tensor) -> torch.Tensor:
    """``n`` in ``like``'s dtype: ``x / n`` then divides as ``jnp`` does
    (PyTorch's ``tensor / int`` multiplies by a rounded reciprocal)."""
    return torch.tensor(n, dtype=like.dtype, device=like.device)
