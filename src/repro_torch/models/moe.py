"""Mixture-of-Experts with sort-based dispatch and predicted capacity.

Dispatch is sort-based (megablocks-style, static shapes): within each group
(one batch row) the assignments are sorted by expert id, each token-slot
gets a position-within-expert, and slots beyond the expert's static
``capacity`` are dropped.  Cost is O(T·k log T·k) for the sort plus
O(T·k·d) gathers — no O(T·E·C) one-hot dispatch tensor.

Capacity is where the paper lands in the LM stack (DESIGN §4): the static
per-expert capacity is the predicted output structure of the token→expert
dispatch.  ``repro_torch.core.moe_capacity.predict_group_capacity``
supplies it from a sampled calibration batch; the fallback is the classic
worst-case ``capacity_factor·T·k/E``.

The groups are dispatched together by batched indexing, with the expert
axis leading the buffer, (E, G, C, d), so each expert's products are one
batched matrix product over its (G·C) slots with no copy of the buffer.
The combine gathers each assignment's expert output back into (token,
top-k slot) order and sums the k slots, so no atomic add decides the
order of a sum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import sharding
from .schema import PSpec
from .layers import mlp_schema, apply_mlp


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    dropped_fraction: torch.Tensor
    expert_load: torch.Tensor      # (E,) fraction of assignments per expert


def moe_schema(cfg) -> dict:
    d, e = cfg.d_model, cfg.moe_num_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    sch = {
        "router": PSpec((d, e), ("embed", "expert")),
        "wi": PSpec((e, d, ff), ("expert", "embed", "moe_ff")),
        "wg": PSpec((e, d, ff), ("expert", "embed", "moe_ff")),
        "wo": PSpec((e, ff, d), ("expert", "moe_ff", "embed")),
    }
    if cfg.moe_shared_experts:
        sch["shared"] = mlp_schema(cfg, d_ff=ff * cfg.moe_shared_experts)
    return sch


def default_capacity(cfg, tokens_per_group: int) -> int:
    """Worst-case (upper-bound-method analogue) per-group capacity."""
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = int(tokens_per_group * k / e * cfg.moe_capacity_factor)
    return max(4, -(-cap // 4) * 4)


def dispatch_buffer_bytes(cfg, groups: int, capacity: int, dtype) -> int:
    """Bytes of the (E, G, C, d) dispatch buffer ``apply_moe`` allocates."""
    return (cfg.moe_num_experts * groups * capacity * cfg.d_model
            * torch.empty((), dtype=dtype).element_size())


def apply_moe(p, cfg, x, *, capacity: int):
    """x: (B, S, d) → (y, MoEAux).

    Grouped dispatch: one group per batch row, so the dispatch sort and
    position bookkeeping stay local to the group (S·k-element sorts).
    ``capacity`` is per group and static; the paper's predictor supplies it
    (DESIGN §4), worst-case ``default_capacity`` is the fallback.  Inside a
    mesh each rank dispatches and combines its own groups; the experts
    shard over `model`.
    """
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k

    bx = sharding.axes_of(x, 0)
    rows, toks = sharding.P(bx, None), sharding.P(bx, None, None)
    lse, probs, gates, ids = sharding.local_map(
        lambda rl, xl: _route(rl, xl, k), (p["router"], x),
        (sharding.replicated(2), toks), (rows, toks, toks, toks))
    buf, order, dest, keep, counts = sharding.local_map(
        lambda xl, il: _dispatch(xl, il, e, capacity), (x, ids),
        (toks, toks), (sharding.P(None, bx, None), rows, rows, rows, rows))

    # ---- expert MLPs: one batched product over the experts ----
    # pinned to (E@model, G·C@data) at training scale, as the JAX package
    # pins its (G, E, C, d) buffers (its third pin, on the hidden
    # activations, falls inside the experts' local block here)
    pin = capacity >= 16
    ep = sharding.P("model", ("pod", "data"), None)
    if pin:
        buf = sharding.constrain_spec(buf, ep)
    w = {n: p[n] for n in ("wi", "wg", "wo")}
    eb = sharding.P(sharding.axes_of(p["wi"], 0), bx, None)
    out = sharding.local_map(lambda wl, bl: _experts(wl, bl, x.dtype),
                             (w, buf), (sharding.tp_specs(w), eb), eb)
    if pin:
        out = sharding.constrain_spec(out, ep)

    y = sharding.local_map(
        lambda ol, orl, dl, kl, gl: _combine(ol, orl, dl, kl, gl, s, k),
        (out, order, dest, keep, gates),
        (sharding.P(None, bx, None), rows, rows, rows, toks), toks)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], x)

    # ---- aux losses (Switch-style) ----
    frac_assign = counts.sum(0).float() / (b * s * k)
    mean_prob = probs.mean(dim=(0, 1))
    lb = e * torch.sum(frac_assign * mean_prob)
    zl = torch.mean(lse ** 2)
    dropped = 1.0 - keep.float().mean()
    return y, MoEAux(lb, zl, dropped, frac_assign)


def _route(router, x, k: int):
    """(the router logits' log-sum-exp, probs, top-k gates renormalised,
    top-k expert ids)."""
    logits = (x @ router.to(x.dtype)).float()                         # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k breaks ties to the lower index; torch.topk does not
    # promise to on the card.  Router probabilities are continuous, so ties
    # do not occur on real or random inputs.
    gates, ids = torch.topk(probs, k, dim=-1)                         # (B,S,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return torch.logsumexp(logits, dim=-1), probs, gates, ids


def _experts(w, buf, dtype):
    """The expert MLPs over the (E, G·C, d) buffer: one batched product
    an expert matrix."""
    h = torch.bmm(buf, w["wi"].to(dtype))
    g = torch.bmm(buf, w["wg"].to(dtype))
    h = F.silu(g).mul_(h)
    del g
    return torch.bmm(h, w["wo"].to(dtype))


def _dispatch(x, ids, e: int, capacity: int):
    """Sort-based dispatch of every group (batch row) of x (B, S, d) to the
    (E, B·C, d) buffer.  Returns (buffer, each group's sort order, each
    sorted assignment's slot, whether it kept one, counts (B, E))."""
    b, s, d = x.shape
    k = ids.shape[-1]
    dev = x.device
    n = s * k
    flat_e = ids.reshape(b, n)
    flat_t = torch.arange(s, device=dev).repeat_interleave(k)         # (n,)
    order = torch.argsort(flat_e, dim=-1, stable=True)                # (B,n)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, se, torch.ones_like(se))
    start = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(n, device=dev)[None, :] - torch.gather(start, 1, se)
    keep = pos < capacity
    grp = torch.arange(b, device=dev)[:, None]
    slots = e * b * capacity
    # slot (expert, group, position) of the (E, G, C) buffer; a dropped
    # assignment goes to one extra row past the end, cut off below
    dest = torch.where(keep, (se * b + grp) * capacity + pos, slots)
    buf = torch.zeros((slots + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, dest.reshape(-1), x[grp, st].reshape(-1, d))
    return buf[:slots].view(e, b * capacity, d), order, dest, keep, counts


def _combine(out, order, dest, keep, gates, s: int, k: int):
    """Each assignment's expert output (``out`` (E, B·C, d)) back to its
    (token, top-k slot), weighted by its gate and summed over the k."""
    b, n = dest.shape
    d = out.shape[-1]
    slots = out.shape[0] * out.shape[1]
    out = out.reshape(slots, d)
    inv = torch.argsort(order, dim=-1)           # sorted position of (t, j)
    dest_tj = torch.gather(dest, 1, inv)                              # (B,n)
    keep_tj = torch.gather(keep, 1, inv)
    contrib = out[dest_tj.clamp(max=slots - 1)]                   # (B,n,d)
    contrib = contrib.masked_fill(~keep_tj[..., None], 0)
    return (contrib * gates.reshape(b, n, 1).to(out.dtype)).view(
        b, s, k, d).sum(2)
