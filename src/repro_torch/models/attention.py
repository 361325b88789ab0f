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

from . import sharding
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
    if (buf.device.type == "cpu" and not _is_fake(idx)
            and int(idx) >= buf.shape[dim]):
        raise IndexError(f"decode position {int(idx)} is past the cache's "
                         f"{buf.shape[dim]} slots")
    if sharding.ambient_mesh() is None:
        buf.index_copy_(dim, idx, new.to(buf.dtype))
        return
    # a cache sharded along ``dim``: each rank writes the position where it
    # falls in its own shard, and writes back what it holds elsewhere
    spec = sharding.P(*[None if d == dim else sharding.axes_of(buf, d)
                        for d in range(buf.ndim)])
    new = sharding.redistribute(new, spec, buf.device_mesh).to_local()
    loc = buf.to_local()
    at = idx - sharding.mesh_offset(buf, dim)
    inside = (at >= 0) & (at < loc.shape[dim])
    at = at.clamp(0, loc.shape[dim] - 1)
    loc.index_copy_(dim, at, torch.where(inside, new.to(loc.dtype),
                                         loc.index_select(dim, at)))


def _is_fake(t: torch.Tensor) -> bool:
    """A tensor with a shape and no values (the dry run's)."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


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
    def local(pl, xl, posl, kv_idx):
        q, k, v = _project_qkv(pl, cfg, xl, posl)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        if kv_idx is not None:
            kh, vh = kh[:, kv_idx], vh[:, kv_idx]
        return _gqa_attend(pl, xl, q, kh, vh, causal=causal, window=window)
    return _by_heads(local, p, x, positions,
                     _pos_spec(positions, sharding.axes_of(x, 0)),
                     kv=("wq", "wk"))


def _by_heads(fn, p, x, extra=None, extra_spec=None, *, kv=None):
    """``fn(p, x, extra, None)``.  Inside a mesh each rank runs ``fn`` on
    its batch rows and its shard of the heads (every weight's
    `model`-sharded dimension kept, the rest gathered), and the block's
    output is summed across the heads' shards (tensor parallelism).
    ``extra`` (positions, or the encoder output) is laid out by
    ``extra_spec``; a plain one holds the same row for every sequence.
    With ``kv = (q weight, kv weight)`` naming q heads sharded and kv heads
    whole, ``fn`` gets the kv heads its q heads read (JAX's head grouping:
    q head i reads kv head i // ceil(Hq / KV))."""
    if sharding.ambient_mesh() is None:
        return fn(p, x, extra, None)
    bx = sharding.axes_of(x, 0)
    rows = sharding.P(bx, None, None)
    heads = sharding.axes_of(p[kv[0]] if kv else p["wo"], 1 if kv else 0)
    q_off = group = None
    if kv and heads is not None and sharding.axes_of(p[kv[1]], 1) is None:
        q_off = sharding.mesh_offset(p[kv[0]], 1)
        group = -(-p[kv[0]].shape[1] // p[kv[1]].shape[1])

    def local(pl, xl, el):
        if extra_spec is None and el is not None:
            el = el[..., :xl.shape[0], :]
        kv_idx = None
        if q_off is not None:
            n = pl[kv[0]].shape[1]
            kv_idx = (q_off + torch.arange(n, device=xl.device)) // group
        return fn(pl, xl, el, kv_idx)
    return sharding.local_map(local, (p, x, extra),
                              (sharding.tp_specs(p), rows, extra_spec), rows,
                              partial=heads)


def _pos_spec(positions, bx):
    """The layout of a DTensor of positions ((B, S) or M-RoPE's (3, B,
    S)): batch over ``bx``; ``None`` for a plain one."""
    if not sharding.is_dtensor(positions):
        return None
    return sharding.P(*[None] * (positions.ndim - 2), bx, None)


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
    q, k, v = _decode_heads(
        lambda pl, xl, posl: _project_qkv(pl, cfg, xl, posl), p, x,
        positions, (("wq", 1), ("wk", 1), ("wv", 1)))
    # append new kv at cur_len
    _write_at(cache.k, 2, cur_len, k.transpose(1, 2))
    _write_at(cache.v, 2, cur_len, v.transpose(1, 2))
    qh = q.transpose(1, 2)                                  # (B, Hp, 1, hd)
    out = _decode_attend(
        lambda ql, kl, cl, s0: _gqa_scores(ql, kl, cl, s0, window),
        _gqa_mix, (qh,), (cache.k,), cache.v, cur_len, seq_dim=2)
    out = out.to(x.dtype).transpose(1, 2)                   # (B, 1, Hp, hd)
    return _out_proj(lambda pl, ol: torch.einsum("bshk,hkd->bsd", ol,
                                                 pl["wo"].to(x.dtype)),
                     {"wo": p["wo"]}, out, "wo", 0), cache


def _decode_heads(fn, p, x, positions, outs):
    """``fn(p, x, positions)``: a decode step's projections.  Inside a mesh
    on each rank's batch rows and heads; output ``i`` of (B, 1, H, ·) is
    laid out with its heads as weight ``outs[i][0]``'s dimension
    ``outs[i][1]`` (``None``: not by heads)."""
    if sharding.ambient_mesh() is None:
        return fn(p, x, positions)
    bx = sharding.axes_of(x, 0)

    def spec(o):
        if o is None:
            return sharding.P(bx, None, None)
        return sharding.P(bx, None, sharding.axes_of(p[o[0]], o[1]), None)

    pos_spec = _pos_spec(positions, bx)

    def local(pl, xl, posl):
        if pos_spec is None:
            posl = posl[..., :xl.shape[0], :]
        return fn(pl, xl, posl)
    return sharding.local_map(
        local, (p, x, positions),
        (sharding.tp_specs(p), sharding.P(bx, None, None), pos_spec),
        tuple(spec(o) for o in outs))


def _out_proj(fn, p, h, name: str, dim: int):
    """``fn(p, h)`` for h (B, 1, H, ·) whose heads weight ``name`` shards
    on ``dim``; inside a mesh on each rank's heads, summed across them."""
    if sharding.ambient_mesh() is None:
        return fn(p, h)
    bx, hx = sharding.axes_of(h, 0), sharding.axes_of(p[name], dim)
    return sharding.local_map(
        fn, (p, h), (sharding.tp_specs(p), sharding.P(bx, None, hx, None)),
        sharding.P(bx, None, None), partial=hx)


def _gqa_scores(qh, ck, cur_len, s0: int, window: int):
    """Masked scores (B, Hp, 1, S) of qh (B, Hp, 1, hd) against cache
    positions ``s0 + [0, S)`` of ``ck`` (B, KV, S, hd)."""
    b, hp = qh.shape[:2]
    kvh, smax = ck.shape[1], ck.shape[2]
    if hp % kvh != 0:
        kk = torch.repeat_interleave(ck, -(-hp // kvh), dim=1)[:, :hp]
        sco = torch.einsum("bhqd,bhsd->bhqs", qh.float(), kk.float())
    else:
        qg = qh.reshape(b, kvh, -1, 1, qh.shape[-1])
        sco = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                           ck.float()).reshape(b, hp, 1, smax)
    sco = sco / (qh.shape[-1] ** 0.5)
    spos = s0 + torch.arange(smax, device=qh.device)
    pos_mask = spos <= cur_len
    if window:
        pos_mask &= spos > cur_len - window
    return sco.masked_fill(~pos_mask[None, None, None], NEG_INF)


def _gqa_mix(prob, cv):
    """prob (B, Hp, 1, S) · cv (B, KV, S, hd) → (B, Hp, 1, hd), float32."""
    b, hp, _, smax = prob.shape
    kvh = cv.shape[1]
    group = -(-hp // kvh)
    if hp % kvh != 0:
        vv = torch.repeat_interleave(cv, group, dim=1)[:, :hp]
        return torch.einsum("bhqs,bhsd->bhqd", prob, vv.float())
    return torch.einsum("bkgqs,bksd->bkgqd",
                        prob.reshape(b, kvh, group, 1, smax),
                        cv.float()).reshape(b, hp, 1, -1)


def _decode_attend(scores, mix, queries, keys, values, cur_len, *,
                   seq_dim: int):
    """``mix(softmax(scores(*queries, *keys, cur_len, 0)), values)`` over
    caches with their sequence axis at ``seq_dim``.  Inside a mesh the
    caches stay sharded along their sequence axis: each rank scores its
    positions against the queries (gathered over the heads), the softmax
    is taken across the shards (a max and a sum reduced over the sequence
    axis), and each rank's part of the weighted sum is added up across
    them."""
    if sharding.ambient_mesh() is None:
        prob = torch.softmax(scores(*queries, *keys, cur_len, 0), dim=-1)
        return mix(prob, values)
    bx, sx = sharding.axes_of(values, 0), sharding.axes_of(values, seq_dim)
    s0 = sharding.mesh_offset(values, seq_dim)
    cache_spec = sharding.P(*[bx if d == 0 else sx if d == seq_dim else None
                              for d in range(values.ndim)])
    q_specs = tuple(sharding.P(bx, *[None] * (qq.ndim - 1))
                    for qq in queries)
    sco_spec = sharding.P(bx, None, None, sx)
    sco = sharding.local_map(
        lambda *a: scores(*a, s0), (*queries, *keys, cur_len),
        (*q_specs, *[cache_spec] * len(keys), None), sco_spec)
    e = torch.exp(sco - sco.amax(-1, keepdim=True))
    prob = e / e.sum(-1, keepdim=True)
    return sharding.local_map(
        mix, (prob, values), (sco_spec, cache_spec),
        sharding.P(bx, None, None, None), partial=sx)


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
    return _by_heads(lambda pl, xl, posl, _: _mla_forward(pl, cfg, xl, posl,
                                                          causal),
                     p, x, positions,
                     _pos_spec(positions, sharding.axes_of(x, 0)))


def _mla_forward(p, cfg, x, positions, causal):
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
    proj = {k_: p[k_] for k_ in p if k_ != "wo"}

    def qkv(pl, xl, posl):
        q_nope, q_rope, ckv_new, k_rope_new = _mla_qkv(pl, cfg, xl, posl)
        # absorb: q_eff (B,1,H,latent)
        q_eff = torch.einsum("bshk,rhk->bshr", q_nope,
                             pl["wkv_b"][..., :nope].to(xl.dtype))
        return q_eff, q_rope, ckv_new, k_rope_new
    q_eff, q_rope, ckv_new, k_rope_new = _decode_heads(
        qkv, proj, x, positions, (("wq_b", 1), ("wq_b", 1), None, None))
    _write_at(cache.k, 1, cur_len, ckv_new)
    _write_at(cache.v, 1, cur_len, k_rope_new)
    scale = (nope + cfg.mla_qk_rope_dim) ** 0.5
    ctx = _decode_attend(
        lambda qe, qr, ck, cr, cl, s0: _mla_scores(qe, qr, ck, cr, cl, s0,
                                                   scale),
        lambda prob, ck: torch.einsum("bshS,bSr->bshr", prob, ck.float()),
        (q_eff, q_rope), (cache.k, cache.v), cache.k, cur_len, seq_dim=1)

    def out_proj(pl, c):
        w_uv = pl["wkv_b"][..., nope:]                  # (latent, H, v)
        out = torch.einsum("bshr,rhk->bshk", c.to(x.dtype), w_uv.to(x.dtype))
        return torch.einsum("bshk,hkd->bsd", out, pl["wo"].to(x.dtype))
    return _out_proj(out_proj, {"wkv_b": p["wkv_b"], "wo": p["wo"]}, ctx,
                     "wo", 0), cache


def _mla_scores(q_eff, q_rope, ck, cr, cur_len, s0: int, scale: float):
    """Masked absorbed-form scores (B, 1, H, S) against latent cache
    positions ``s0 + [0, S)``."""
    sco = (torch.einsum("bshr,bSr->bshS", q_eff.float(), ck.float()) +
           torch.einsum("bshk,bSk->bshS", q_rope.float(), cr.float()))
    sco = sco / scale
    mask = s0 + torch.arange(ck.shape[1], device=ck.device) <= cur_len
    return sco.masked_fill(~mask[None, None, None], NEG_INF)


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
    return _by_heads(lambda pl, xl, el, _: _cross_forward(pl, xl, el), p, x,
                     enc_out, sharding.P(sharding.axes_of(x, 0), None, None))


def _cross_forward(p, x, enc_out):
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
