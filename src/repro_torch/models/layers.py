"""Shared model layers (functional PyTorch; params are plain dicts of
tensors, as the JAX package's are pytrees)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import sharding
from .schema import PSpec


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def norm_schema(cfg) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": PSpec((cfg.d_model,), ("embed",), "ones"),
                "bias": PSpec((cfg.d_model,), ("embed",), "zeros")}
    return {"scale": PSpec((cfg.d_model,), ("embed",), "ones")}


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm where ``p`` has a bias; computed in float32 and
    cast back to ``x``'s dtype (inside a mesh on each rank's rows)."""
    rows = sharding.rows(x)
    return sharding.local_map(lambda pl, xl: _norm(pl, xl, eps), (p, x),
                              ("replicated", rows), rows)


def _norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"] + p["bias"]).to(x.dtype)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


# --------------------------------------------------------------------------- #
# RoPE (standard + M-RoPE)
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, D).  positions: (B, S) or (3, B, S) for M-RoPE.

    The rotate-half form on the two halves of D (not interleaved).  M-RoPE
    (qwen2-vl): the D/2 rotary frequencies are split into ``mrope_sections``
    (t, h, w); each section uses its own position stream.  Text tokens carry
    identical (t, h, w) positions, so M-RoPE degenerates to standard RoPE
    for them.
    """
    b, s, h, d = x.shape
    inv = rope_freqs(d, theta, x.device)  # (d/2,)
    if mrope_sections and positions.dim() == 3:
        assert sum(mrope_sections) == d // 2, (mrope_sections, d)
        pos = torch.cat([positions[i][:, :, None].expand(b, s, sec)
                         for i, sec in enumerate(mrope_sections)], dim=-1)
        ang = pos.float() * inv[None, None, :]             # (B, S, d/2)
    else:
        if positions.dim() == 3:
            positions = positions[0]
        ang = positions[:, :, None].float() * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]                    # (B, S, 1, d/2)
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
def mlp_schema(cfg, d_ff: int | None = None) -> dict:
    ff = d_ff or cfg.d_ff
    d = cfg.d_model
    if cfg.act == "swiglu":
        return {"wi": PSpec((d, ff), ("embed", "ff")),
                "wg": PSpec((d, ff), ("embed", "ff")),
                "wo": PSpec((ff, d), ("ff", "embed"))}
    return {"wi": PSpec((d, ff), ("embed", "ff")),
            "wo": PSpec((ff, d), ("ff", "embed"))}


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp`` promotes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The MLP; inside a mesh on each rank's rows and shard of the hidden
    units, the output summed across the shards (tensor parallel)."""
    rows = sharding.rows(x)
    return sharding.local_map(_mlp, (p, x), (sharding.tp_specs(p), rows),
                              rows, partial=sharding.axes_of(p["wi"], 1))


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = _matmul(x, p["wi"])
    if "wg" in p:  # swiglu
        h = F.silu(_matmul(x, p["wg"])) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return _matmul(h, p["wo"])


# --------------------------------------------------------------------------- #
# embeddings / head
# --------------------------------------------------------------------------- #
def embed_schema(cfg, padded_vocab: int) -> dict:
    sch = {"tok": PSpec((padded_vocab, cfg.d_model), ("vocab", "embed"),
                        "embed")}
    if not cfg.tie_embeddings:
        sch["head"] = PSpec((cfg.d_model, padded_vocab), ("embed", "vocab"))
    return sch


def embed_tokens(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    if sharding.ambient_mesh() is None:
        return p["tok"].to(dtype)[tokens]
    # the vocab-sharded table: each rank looks up the rows it holds and the
    # lookups are summed across the shards, no table gathered
    table = p["tok"]
    vx, bx = sharding.axes_of(table, 0), sharding.axes_of(tokens, 0)
    v0 = sharding.mesh_offset(table, 0)

    def look(t, tok):
        at = tok.long() - v0
        inside = (at >= 0) & (at < t.shape[0])
        rows = t.to(dtype)[at.clamp(0, t.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return sharding.reduce_partial(sharding.local_map(
        look, (table, tokens), (sharding.P(vx, None), sharding.P(bx, None)),
        sharding.P(bx, None, None), partial=vx))


def lm_head(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (the product itself runs in ``x``'s dtype)."""
    w = p.get("head")
    if w is None:
        w = p["tok"].T
    vx = sharding.axes_of(w, 1)
    return sharding.local_map(lambda wl, xl: (xl @ wl.to(xl.dtype)).float(),
                              (w, x), (sharding.P(None, vx), sharding.rows(x)),
                              sharding.P(sharding.axes_of(x, 0), None, vx))
