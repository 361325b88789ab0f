"""Attention blocks: GQA (RoPE/M-RoPE) and MLA (deepseek-v3), full
sequence and one-token decode, as plain PyTorch.

  * prefill / full sequence — queries in 512-row chunks against all keys,
    scores and softmax in float32 (O(S·chunk) memory), top-left causal
    mask and an optional sliding window;
  * decode — one query a sequence against the KV cache, masked past
    ``cur_len``;
  * MLA decode uses the absorbed form (score against the latent cache
    directly) — the compact-cache property that makes MLA serve long
    contexts.

The KV cache is written in place at ``cur_len`` (a 0-d integer tensor that
stays on the cache's device): ``decode`` returns the same tensors it was
given, updated.  A position past the cache's end raises on the host; the
serving engine checks its own step count so that a card never sees one.
The hand-written flash kernel (``repro_torch.kernels.flash_attention``) is
not used here, as the JAX package's model does not use its Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .schema import PSpec
from .layers import apply_rope, apply_norm

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# schemas
# --------------------------------------------------------------------------- #
def gqa_schema(cfg, mesh_model: int) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hp = cfg.padded_heads(mesh_model)
    kv = cfg.padded_kv_heads(mesh_model)
    sch = {
        "wq": PSpec((d, hp, hd), ("embed", "heads", None)),
        "wk": PSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": PSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": PSpec((hp, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        sch["bq"] = PSpec((hp, hd), ("heads", None), "zeros")
        sch["bk"] = PSpec((kv, hd), ("kv_heads", None), "zeros")
        sch["bv"] = PSpec((kv, hd), ("kv_heads", None), "zeros")
    return sch


def mla_schema(cfg, mesh_model: int) -> dict:
    d = cfg.d_model
    hp = cfg.padded_heads(mesh_model)
    qk = cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim
    return {
        "wq_a": PSpec((d, cfg.mla_q_lora_rank), ("embed", None)),
        "q_norm": {"scale": PSpec((cfg.mla_q_lora_rank,), (None,), "ones")},
        "wq_b": PSpec((cfg.mla_q_lora_rank, hp, qk), (None, "heads", None)),
        "wkv_a": PSpec((d, cfg.mla_kv_lora_rank + cfg.mla_qk_rope_dim),
                       ("embed", None)),
        "kv_norm": {"scale": PSpec((cfg.mla_kv_lora_rank,), (None,), "ones")},
        "wkv_b": PSpec((cfg.mla_kv_lora_rank, hp,
                        cfg.mla_qk_nope_dim + cfg.mla_v_dim),
                       (None, "heads", None)),
        "wo": PSpec((hp, cfg.mla_v_dim, d), ("heads", None, "embed")),
    }


def attention_schema(cfg, mesh_model: int) -> dict:
    if cfg.attention_type == "mla":
        return mla_schema(cfg, mesh_model)
    return gqa_schema(cfg, mesh_model)


# --------------------------------------------------------------------------- #
# caches
# --------------------------------------------------------------------------- #
class KVCache(NamedTuple):
    """GQA cache: k/v (B, KV, Smax, hd).  MLA: ckv (B, Smax, latent),
    krope (B, Smax, rope) — stored in k/v respectively (2D per token)."""
    k: torch.Tensor
    v: torch.Tensor


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, device,
                   mesh_model: int = 1) -> KVCache:
    hd = cfg.resolved_head_dim
    shp = (batch, cfg.padded_kv_heads(mesh_model), max_len, hd)
    return KVCache(torch.zeros(shp, dtype=dtype, device=device),
                   torch.zeros(shp, dtype=dtype, device=device))


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device) -> KVCache:
    return KVCache(
        torch.zeros((batch, max_len, cfg.mla_kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, cfg.mla_qk_rope_dim), dtype=dtype,
                    device=device))


def _write_at(buf: torch.Tensor, dim: int, cur_len: torch.Tensor,
              new: torch.Tensor) -> None:
    """``buf[..., cur_len, ...] = new`` along ``dim`` in place, with no read
    of ``cur_len`` back to the host.  Where JAX's ``dynamic_update_slice``
    would clamp a start past the end, this raises (on the host) instead."""
    idx = cur_len.reshape(1).to(device=buf.device, dtype=torch.long)
    if buf.device.type == "cpu" and int(idx) >= buf.shape[dim]:
        raise IndexError(f"decode position {int(idx)} is past the cache's "
                         f"{buf.shape[dim]} slots")
    buf.index_copy_(dim, idx, new.to(buf.dtype))


# --------------------------------------------------------------------------- #
# chunked causal attention
# --------------------------------------------------------------------------- #
def _causal_attn_chunked(q, k, v, *, chunk: int = 512, causal: bool = True,
                         window: int = 0):
    """q/k (B,H,S,D); v (B,KV,S,Dv) — Dv may differ (MLA).  GQA by head
    grouping; O(S·chunk) memory.  The causal mask is top-left
    (``qpos >= kpos``)."""
    b, h, s, d = q.shape
    dv = v.shape[-1]
    kv = k.shape[1]
    group = h // kv
    qg = q.reshape(b, kv, group, s, d)
    scale = 1.0 / (d ** 0.5)
    nk = k.shape[2]
    kpos = torch.arange(nk, device=q.device)
    kf, vf = k.float(), v.float()
    outs = []
    for c0 in range(0, s, chunk):
        # the JAX path pads the last chunk to ``chunk`` rows; padded query
        # rows never reach the output, so the port leaves them out
        qch = qg[:, :, :, c0:c0 + chunk].float()           # (B,KV,G,C,D)
        sco = torch.einsum("bkgcd,bksd->bkgcs", qch, kf) * scale
        qpos = c0 + torch.arange(qch.shape[3], device=q.device)
        mask = torch.ones((qch.shape[3], nk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        sco = sco.masked_fill(~mask[None, None, None], NEG_INF)
        p = torch.softmax(sco, dim=-1)
        outs.append(torch.einsum("bkgcs,bksd->bkgcd", p, vf))
    out = torch.cat(outs, dim=3)                          # (B,KV,G,S,Dv)
    return out.reshape(b, h, s, dv).to(q.dtype)


# --------------------------------------------------------------------------- #
# GQA
# --------------------------------------------------------------------------- #
def _project_qkv(p, cfg, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _repeat_kv(kh, vh, hp):
    """Pad-head grouping: where the kv heads do not divide the q heads,
    repeat each kv head and cut to ``hp`` (JAX's ``jnp.repeat``)."""
    kvh = kh.shape[1]
    if hp % kvh != 0:
        reps = -(-hp // kvh)
        kh = torch.repeat_interleave(kh, reps, dim=1)[:, :hp]
        vh = torch.repeat_interleave(vh, reps, dim=1)[:, :hp]
    return kh, vh


def _gqa_attend(p, x, q, kh, vh, *, causal, window):
    qh = q.transpose(1, 2)                         # (B, Hp, S, hd)
    kh, vh = _repeat_kv(kh, vh, qh.shape[1])
    out = _causal_attn_chunked(qh, kh, vh, causal=causal, window=window)
    out = out.transpose(1, 2)                      # (B, S, Hp, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def gqa_forward(p, cfg, x, positions, *, causal: bool = True,
                window: int = 0) -> torch.Tensor:
    """Full-sequence attention (training / prefill).  x: (B, S, d)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    return _gqa_attend(p, x, q, k.transpose(1, 2), v.transpose(1, 2),
                       causal=causal, window=window)


def gqa_prefill(p, cfg, x, positions, cache: KVCache, *, window: int = 0):
    """Prefill: forward + write k/v into the cache at [0, S) in place."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    s = kh.shape[2]
    if s > cache.k.shape[2]:
        raise IndexError(f"prefill of {s} tokens is past the cache's "
                         f"{cache.k.shape[2]} slots")
    cache.k[:, :, :s] = kh.to(cache.k.dtype)
    cache.v[:, :, :s] = vh.to(cache.v.dtype)
    return _gqa_attend(p, x, q, kh, vh, causal=True, window=window), cache


def gqa_decode(p, cfg, x, positions, cache: KVCache, cur_len, *,
               window: int = 0):
    """One-token decode.  x: (B, 1, d); cache k/v (B, KV, Smax, hd)."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, positions)
    # append new kv at cur_len
    _write_at(cache.k, 2, cur_len, k.transpose(1, 2))
    _write_at(cache.v, 2, cur_len, v.transpose(1, 2))
    ck, cv = cache.k, cache.v
    smax = ck.shape[2]

    qh = q.transpose(1, 2)                                  # (B, Hp, 1, hd)
    hp, kvh = qh.shape[1], ck.shape[1]
    group = -(-hp // kvh)
    if hp % kvh != 0:
        kk = torch.repeat_interleave(ck, group, dim=1)[:, :hp]
        vv = torch.repeat_interleave(cv, group, dim=1)[:, :hp]
        sco = torch.einsum("bhqd,bhsd->bhqs", qh.float(), kk.float())
    else:
        qg = qh.reshape(b, kvh, -1, 1, qh.shape[-1])
        vv = cv
        sco = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                           ck.float()).reshape(b, hp, 1, smax)
    sco = sco / (qh.shape[-1] ** 0.5)
    spos = torch.arange(smax, device=x.device)
    pos_mask = spos <= cur_len
    if window:
        pos_mask &= spos > cur_len - window
    sco = sco.masked_fill(~pos_mask[None, None, None], NEG_INF)
    prob = torch.softmax(sco, dim=-1)
    if hp % kvh != 0:
        out = torch.einsum("bhqs,bhsd->bhqd", prob, vv.float())
    else:
        out = torch.einsum("bkgqs,bksd->bkgqd",
                           prob.reshape(b, kvh, group, 1, smax),
                           vv.float()).reshape(b, hp, 1, -1)
    out = out.to(x.dtype).transpose(1, 2)                   # (B, 1, Hp, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), cache


# --------------------------------------------------------------------------- #
# MLA (deepseek-v3)
# --------------------------------------------------------------------------- #
def _mla_qkv(p, cfg, x, positions):
    nope = cfg.mla_qk_nope_dim
    cq = apply_norm(p["q_norm"], x @ p["wq_a"].to(x.dtype))
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"].to(x.dtype))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_full = x @ p["wkv_a"].to(x.dtype)
    r = cfg.mla_kv_lora_rank
    ckv, k_rope = ckv_full[..., :r], ckv_full[..., r:]
    ckv = apply_norm(p["kv_norm"], ckv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def mla_forward(p, cfg, x, positions, *, causal: bool = True) -> torch.Tensor:
    """Training/prefill MLA: expand latent to full k/v (FLOP-optimal for S≫1)."""
    nope = cfg.mla_qk_nope_dim
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, cfg, x, positions)
    kv = torch.einsum("bsr,rhk->bshk", ckv, p["wkv_b"].to(x.dtype))
    k_nope, v = kv[..., :nope], kv[..., nope:]
    hp = q_nope.shape[2]
    k_rope_b = k_rope[:, :, None, :].expand(
        k_rope.shape[0], k_rope.shape[1], hp, k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], -1).transpose(1, 2)
    k = torch.cat([k_nope, k_rope_b], -1).transpose(1, 2)
    vh = v.transpose(1, 2)
    out = _causal_attn_chunked(q, k, vh, causal=causal)
    out = out.transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def mla_prefill(p, cfg, x, positions, cache: KVCache):
    _, _, ckv, k_rope = _mla_qkv(p, cfg, x, positions)
    s = ckv.shape[1]
    if s > cache.k.shape[1]:
        raise IndexError(f"prefill of {s} tokens is past the cache's "
                         f"{cache.k.shape[1]} slots")
    cache.k[:, :s] = ckv.to(cache.k.dtype)
    cache.v[:, :s] = k_rope.to(cache.v.dtype)
    out = mla_forward(p, cfg, x, positions, causal=True)
    return out, cache


def mla_decode(p, cfg, x, positions, cache: KVCache, cur_len):
    """Absorbed-form decode against the latent cache (B, Smax, latent + rope)."""
    nope = cfg.mla_qk_nope_dim
    q_nope, q_rope, ckv_new, k_rope_new = _mla_qkv(p, cfg, x, positions)
    _write_at(cache.k, 1, cur_len, ckv_new)
    _write_at(cache.v, 1, cur_len, k_rope_new)
    ck, cr = cache.k, cache.v
    smax = ck.shape[1]

    w_uk = p["wkv_b"][..., :nope]                       # (latent, H, nope)
    w_uv = p["wkv_b"][..., nope:]                       # (latent, H, v)
    # absorb: q_eff (B,1,H,latent)
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope, w_uk.to(x.dtype))
    sco = (torch.einsum("bshr,bSr->bshS", q_eff.float(), ck.float()) +
           torch.einsum("bshk,bSk->bshS", q_rope.float(), cr.float()))
    sco = sco / ((nope + cfg.mla_qk_rope_dim) ** 0.5)
    mask = torch.arange(smax, device=x.device) <= cur_len
    sco = sco.masked_fill(~mask[None, None, None], NEG_INF)
    prob = torch.softmax(sco, dim=-1)
    ctx = torch.einsum("bshS,bSr->bshr", prob, ck.float())
    out = torch.einsum("bshr,rhk->bshk", ctx.to(x.dtype), w_uv.to(x.dtype))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), cache


# --------------------------------------------------------------------------- #
# cross attention (whisper decoder)
# --------------------------------------------------------------------------- #
def cross_schema(cfg, mesh_model: int) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hp = cfg.padded_heads(mesh_model)
    return {
        "wq": PSpec((d, hp, hd), ("embed", "heads", None)),
        "wk": PSpec((d, hp, hd), ("embed", "heads", None)),
        "wv": PSpec((d, hp, hd), ("embed", "heads", None)),
        "wo": PSpec((hp, hd, d), ("heads", None, "embed")),
    }


def cross_forward(p, cfg, x, enc_out) -> torch.Tensor:
    """Decoder cross-attention over encoder output (no cache needed: enc kv
    computed on the fly — enc seq is short)."""
    enc = enc_out.to(x.dtype)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype)).transpose(1, 2)
    k = torch.einsum("bsd,dhk->bshk", enc, p["wk"].to(x.dtype)).transpose(1, 2)
    v = torch.einsum("bsd,dhk->bshk", enc, p["wv"].to(x.dtype)).transpose(1, 2)
    sco = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                       k.float()) / (q.shape[-1] ** 0.5)
    prob = torch.softmax(sco, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", prob, v.float())
    out = out.to(x.dtype).transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
