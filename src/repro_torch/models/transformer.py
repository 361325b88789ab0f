"""Unified model stack for all assigned families.

Layers are grouped into *segments* of identical repeating period (e.g.
deepseek-v3 = [3×dense] + [58×moe]; xlstm = 3×(mlstm,mlstm,mlstm,slstm));
each segment's params are stacked over repeats (a leading layer axis on
every leaf) and applied by a loop over that axis.  zamba2's one shared
attention+MLP block runs after every ``attn_every``-th layer: unwindowed
in the forward, under ``cfg.sliding_window`` in decode, as the JAX
package has it (the two agree only within the window).

With ``cfg.remat`` other than ``"none"``, each repeat of a segment runs
under ``torch.utils.checkpoint`` while gradients are being recorded
(``"full"`` saves nothing inside it, ``"dots"`` saves its plain matrix
products); it changes no value.

Public API:
  build_schema(cfg, mesh_model)                → PSpec tree
  forward(params, cfg, batch, ...)             → (logits, Aux, mtp_logits)
  init_cache / decode_step                     → serving
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.utils import checkpoint as ckpt_util

from repro_torch.core.csr import resolve_device

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (norm_schema, apply_norm, mlp_schema, apply_mlp,
                     embed_schema, embed_tokens, lm_head)
from .schema import PSpec, stack_layers
from .sharding import (P, ambient_mesh, axes_of, constrain_batch, local_map,
                       roll_rows, rows, use_mesh, write_shard)


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------- #
# segment planning
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    kinds: tuple[str, ...]   # block kinds within one period
    repeats: int             # stacked layers
    layer_offset: int        # global index of the segment's first layer


def segment_plan(cfg) -> list[SegmentPlan]:
    if cfg.block_pattern:
        period = tuple(cfg.block_pattern)
        assert cfg.num_layers % len(period) == 0, (cfg.num_layers, period)
        return [SegmentPlan(period, cfg.num_layers // len(period), 0)]
    if cfg.moe_num_experts:
        segs = []
        off = 0
        if cfg.moe_dense_layers:
            segs.append(SegmentPlan(("attn",), cfg.moe_dense_layers, 0))
            off = cfg.moe_dense_layers
        segs.append(SegmentPlan(("moe",), cfg.num_layers - off, off))
        return segs
    return [SegmentPlan(("attn",), cfg.num_layers, 0)]


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):  # a cache NamedTuple
        return type(tree)(*(t[i] for t in tree))
    return tree[i]


def _shared_at(cfg, gidx: int) -> bool:
    """Whether zamba2's shared block runs after global layer ``gidx``."""
    return bool(cfg.attn_every) and (gidx + 1) % cfg.attn_every == 0


# --------------------------------------------------------------------------- #
# per-kind block schemas
# --------------------------------------------------------------------------- #
def _block_schema(cfg, kind: str, mesh_model: int) -> dict:
    if kind == "attn":
        sch = {"ln1": norm_schema(cfg),
               "attn": attn_mod.attention_schema(cfg, mesh_model)}
        if cfg.d_ff:
            sch["ln2"] = norm_schema(cfg)
            sch["mlp"] = mlp_schema(cfg)
        return sch
    if kind == "moe":
        return {"ln1": norm_schema(cfg),
                "attn": attn_mod.attention_schema(cfg, mesh_model),
                "ln2": norm_schema(cfg),
                "moe": moe_mod.moe_schema(cfg)}
    if kind == "mamba":
        return {"ln1": norm_schema(cfg), "mamba": ssm_mod.mamba_schema(cfg)}
    if kind == "mlstm":
        return {"ln1": norm_schema(cfg), "mlstm": ssm_mod.mlstm_schema(cfg)}
    if kind == "slstm":
        return {"ln1": norm_schema(cfg), "slstm": ssm_mod.slstm_schema(cfg)}
    raise ValueError(kind)


def build_schema(cfg, mesh_model: int = 1) -> dict:
    pv = cfg.padded_vocab()
    sch: dict[str, Any] = {"embed": embed_schema(cfg, pv)}
    for si, seg in enumerate(segment_plan(cfg)):
        period = {f"pos{j}": _block_schema(cfg, k, mesh_model)
                  for j, k in enumerate(seg.kinds)}
        sch[f"seg{si}"] = stack_layers(period, seg.repeats)
    if cfg.attn_every:  # zamba2 shared attention+MLP block (one weight set)
        sch["shared_attn"] = {
            "ln1": norm_schema(cfg),
            "attn": attn_mod.gqa_schema(cfg, mesh_model),
            "ln2": norm_schema(cfg),
            "mlp": mlp_schema(cfg),
        }
    if cfg.is_encoder_decoder:
        enc_period = {"pos0": _block_schema(cfg, "attn", mesh_model)}
        sch["encoder"] = stack_layers(enc_period, cfg.num_encoder_layers)
        sch["enc_norm"] = norm_schema(cfg)
        # decoder blocks get cross attention
        cross_period = {"pos0": {"ln_x": norm_schema(cfg),
                                 "cross": attn_mod.cross_schema(cfg, mesh_model)}}
        sch["cross"] = stack_layers(cross_period, cfg.num_layers)
    if cfg.mtp_heads:  # deepseek multi-token prediction module
        sch["mtp"] = {
            "proj": PSpec((2 * cfg.d_model, cfg.d_model), (None, "embed")),
            "block": _block_schema(cfg, "attn", mesh_model),
            "norm": norm_schema(cfg),
        }
    sch["final_norm"] = norm_schema(cfg)
    return sch


# --------------------------------------------------------------------------- #
# block application (full sequence)
# --------------------------------------------------------------------------- #
class Aux(NamedTuple):
    moe_lb: torch.Tensor
    moe_z: torch.Tensor
    moe_dropped: torch.Tensor


def _zero_aux(device) -> Aux:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return Aux(z, z, z)


_SSM_FORWARD = {"mamba": ssm_mod.mamba_forward,
                "mlstm": ssm_mod.mlstm_forward,
                "slstm": ssm_mod.slstm_forward}
_SSM_DECODE = {"mamba": ssm_mod.mamba_decode,
               "mlstm": ssm_mod.mlstm_decode,
               "slstm": ssm_mod.slstm_decode}


def _apply_block(p, cfg, kind, x, positions, aux: Aux, *, causal=True,
                 capacity=None):
    if kind in _SSM_FORWARD:
        h = apply_norm(p["ln1"], x)
        rows = P(axes_of(h, 0), None, None)
        return x + local_map(lambda pl, hl: _SSM_FORWARD[kind](pl, cfg, hl),
                             (p[kind], h), ("replicated", rows), rows), aux
    h = apply_norm(p["ln1"], x)
    if cfg.attention_type == "mla":
        a = attn_mod.mla_forward(p["attn"], cfg, h, positions, causal=causal)
    else:
        a = attn_mod.gqa_forward(p["attn"], cfg, h, positions, causal=causal)
    x = x + a
    if kind == "moe":
        h = apply_norm(p["ln2"], x)
        y, maux = moe_mod.apply_moe(p["moe"], cfg, h, capacity=capacity)
        x = x + y
        aux = Aux(aux.moe_lb + maux.load_balance_loss,
                  aux.moe_z + maux.router_z_loss,
                  aux.moe_dropped + maux.dropped_fraction)
    elif cfg.d_ff:
        h = apply_norm(p["ln2"], x)
        x = x + apply_mlp(p["mlp"], h)
    return x, aux


def _apply_shared_attn(p, cfg, x, positions):
    """zamba2's shared block over the full sequence: unwindowed, as JAX's
    forward runs it (decode applies ``cfg.sliding_window``; ROADMAP R9)."""
    h = apply_norm(p["ln1"], x)
    x = x + attn_mod.gqa_forward(p["attn"], cfg, h, positions, causal=True)
    h = apply_norm(p["ln2"], x)
    return x + apply_mlp(p["mlp"], h)


def _save_dots():
    """Selective checkpointing that keeps plain matrix products (JAX's
    ``dots_with_no_batch_dims_saveable``) and recomputes the rest."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    dots = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(_ctx, op, *_args, **_kw):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _remat_wrap(cfg, fn):
    """``fn`` under activation checkpointing per ``cfg.remat``, where
    gradients are being recorded; as it is otherwise."""
    if cfg.remat == "none":
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {"context_fn": _save_dots} if cfg.remat == "dots" else {}
        mesh = ambient_mesh()
        if mesh is None:
            return ckpt_util.checkpoint(fn, *args, use_reentrant=False, **kw)

        def in_mesh(*a):
            # recomputed in the backward, which runs on the autograd
            # engine's own thread for a card's tensors
            with use_mesh(mesh):
                return fn(*a)
        return ckpt_util.checkpoint(in_mesh, *args, use_reentrant=False,
                                    **kw)
    return wrapped


def _repeat_fn(params, cfg, seg: SegmentPlan, positions, *, capacity,
               causal):
    """One repeat of ``seg``: (x, aux, layer params, repeat index) → (x,
    aux), zamba2's shared block interleaved."""
    def body(xx, aux_c, layer_p, r):
        xx = constrain_batch(xx, batch_over_model=not cfg.tensor_parallel)
        for j, kind in enumerate(seg.kinds):
            xx, aux_c = _apply_block(layer_p[f"pos{j}"], cfg, kind, xx,
                                     positions, aux_c, causal=causal,
                                     capacity=capacity)
            if _shared_at(cfg, seg.layer_offset + r * len(seg.kinds) + j):
                xx = _apply_shared_attn(params["shared_attn"], cfg, xx,
                                        positions)
        return xx, aux_c
    return _remat_wrap(cfg, body)


def _run_segments(params, cfg, x, positions, aux, *, capacity, causal=True):
    for si, seg in enumerate(segment_plan(cfg)):
        body = _repeat_fn(params, cfg, seg, positions, capacity=capacity,
                          causal=causal)
        for r in range(seg.repeats):
            x, aux = body(x, aux, _layer(params[f"seg{si}"], r), r)
    return x, aux


# --------------------------------------------------------------------------- #
# encoder (whisper)
# --------------------------------------------------------------------------- #
def _run_encoder(params, cfg, frame_embeds):
    x = frame_embeds
    pos = torch.arange(x.shape[1], dtype=torch.int32,
                       device=x.device)[None].expand(x.shape[:2])

    def body(xx, layer_p):
        xx = constrain_batch(xx, batch_over_model=not cfg.tensor_parallel)
        return _apply_block(layer_p["pos0"], cfg, "attn", xx, pos,
                            _zero_aux(xx.device), causal=False)[0]

    body = _remat_wrap(cfg, body)
    for r in range(cfg.num_encoder_layers):
        x = body(x, _layer(params["encoder"], r))
    return apply_norm(params["enc_norm"], x)


def _apply_cross(params, cfg, x, enc_out, r: int):
    """Decoder layer ``r``'s cross attention over the encoder output."""
    cross_p = _layer(params["cross"], r)["pos0"]
    h = apply_norm(cross_p["ln_x"], x)
    return x + attn_mod.cross_forward(cross_p["cross"], cfg, h, enc_out)


# --------------------------------------------------------------------------- #
# full-sequence forward
# --------------------------------------------------------------------------- #
def forward(params, cfg, batch, *, capacity: int | None = None):
    """batch: tokens (B,S) [+ positions, patch_embeds, frame_embeds], all on
    the parameters' device.

    Returns (logits (B,S,V_padded) fp32, Aux, mtp_logits or None).
    """
    dtype = _dtype(cfg)
    tokens = batch["tokens"]
    dev = tokens.device
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=dev)[None].expand(tokens.shape)
    x = constrain_batch(embed_tokens(params["embed"], tokens, dtype),
                        batch_over_model=not cfg.tensor_parallel)
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        # early fusion: precomputed patch embeddings replace the first P slots
        pe = batch["patch_embeds"].to(dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    if capacity is None and cfg.moe_num_experts:
        # per-group (= per batch row) capacity
        capacity = moe_mod.default_capacity(cfg, tokens.shape[1])
    aux = _zero_aux(dev)

    if cfg.is_encoder_decoder:
        enc_out = _run_encoder(params, cfg, batch["frame_embeds"].to(dtype))
        # decoder: interleave self-attn blocks with cross-attn per layer
        seg = segment_plan(cfg)[0]

        def body(xx, aux_c, r):
            xx = constrain_batch(xx, batch_over_model=not cfg.tensor_parallel)
            xx, aux_c = _apply_block(_layer(params["seg0"], r)["pos0"], cfg,
                                     "attn", xx, positions, aux_c,
                                     causal=True, capacity=capacity)
            return _apply_cross(params, cfg, xx, enc_out, r), aux_c

        body = _remat_wrap(cfg, body)
        for r in range(seg.repeats):
            x, aux = body(x, aux, r)
    else:
        x, aux = _run_segments(params, cfg, x, positions, aux,
                               capacity=capacity)

    x = apply_norm(params["final_norm"], x)
    # vocab stays `model`-sharded through the CE (a max and a sum reduced)
    logits = constrain_batch(
        lm_head(params["embed"], x),
        sharded_tail={2: "model"} if cfg.tensor_parallel else None,
        batch_over_model=not cfg.tensor_parallel)

    if cfg.mtp_heads:  # deepseek MTP: predict t+2 from [h_t ; emb(t+1)]
        emb_next = embed_tokens(params["embed"],
                                roll_rows(tokens, -1), dtype)
        h_mtp = torch.cat([x.to(dtype), emb_next], dim=-1)
        h_mtp = local_map(lambda w, hl: hl @ w.to(dtype),
                          (params["mtp"]["proj"], h_mtp),
                          (P(None, None), rows(h_mtp)), rows(h_mtp))
        h_mtp, _ = _apply_block(params["mtp"]["block"], cfg, "attn", h_mtp,
                                positions, _zero_aux(dev), capacity=capacity)
        h_mtp = apply_norm(params["mtp"]["norm"], h_mtp)
        mtp_logits = lm_head(params["embed"], h_mtp)
        return logits, aux, mtp_logits
    return logits, aux, None


# --------------------------------------------------------------------------- #
# serving: cache init / decode
# --------------------------------------------------------------------------- #
def _block_cache(cfg, kind, batch, max_len, dtype, device, mesh_model=1):
    if kind == "mamba":
        return ssm_mod.init_mamba_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return ssm_mod.init_mlstm_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        return ssm_mod.init_slstm_cache(cfg, batch, dtype, device)
    if cfg.attention_type == "mla":
        return attn_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
    return attn_mod.init_gqa_cache(cfg, batch, max_len, dtype, device,
                                   mesh_model)


def _stacked(c, n: int):
    """A cache NamedTuple with ``n`` zeroed layers stacked in front."""
    return type(c)(*(torch.zeros((n,) + a.shape, dtype=a.dtype,
                                 device=a.device) for a in c))


def init_cache(cfg, batch: int, max_len: int, mesh_model: int = 1, *,
               device=None):
    """Stacked-over-repeats cache tree mirroring the segment structure, on
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    cache: dict[str, Any] = {}
    eff_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    for si, seg in enumerate(segment_plan(cfg)):
        cache[f"seg{si}"] = {
            f"pos{j}": _stacked(_block_cache(cfg, kind, batch, eff_len, dtype,
                                             dev, mesh_model), seg.repeats)
            for j, kind in enumerate(seg.kinds)}
    if cfg.attn_every:
        n_shared = sum(1 for i in range(cfg.num_layers) if _shared_at(cfg, i))
        cache["shared_attn"] = _stacked(attn_mod.init_gqa_cache(
            cfg, batch, eff_len, dtype, dev, mesh_model), n_shared)
    return cache


def _decode_block(p, cfg, kind, x, positions, cache, cur_len, *, window=0):
    if kind in _SSM_DECODE:
        return x + _ssm_decode(_SSM_DECODE[kind], p[kind], cfg,
                               apply_norm(p["ln1"], x), cache), cache
    h = apply_norm(p["ln1"], x)
    if cfg.attention_type == "mla":
        a, cache = attn_mod.mla_decode(p["attn"], cfg, h, positions, cache,
                                       cur_len)
    else:
        a, cache = attn_mod.gqa_decode(p["attn"], cfg, h, positions, cache,
                                       cur_len, window=window)
    x = x + a
    if kind == "moe":
        h = apply_norm(p["ln2"], x)
        # decode: groups of one token → k distinct experts, ≤1 slot each
        y, _ = moe_mod.apply_moe(p["moe"], cfg, h, capacity=4)
        x = x + y
    elif cfg.d_ff:
        x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x))
    return x, cache


def _ssm_decode(fn, p, cfg, h, cache):
    """A recurrent block's decode step, ``cache`` updated in place.  Inside
    a mesh, as in its forward, each rank steps its own batch rows with the
    block's weights and its rows' states whole, then keeps its shard of the
    new states."""
    rows = P(axes_of(h, 0), None, None)
    states = tuple(P(axes_of(h, 0), *[None] * (c.ndim - 1)) for c in cache)
    y, *new = local_map(
        lambda pl, hl, *cl: _flat_step(fn(pl, cfg, hl, type(cache)(*cl))),
        (p, h, *cache), ("replicated", rows, *states), (rows, *states))
    if ambient_mesh() is not None:
        for dst, src in zip(cache, new):
            write_shard(dst, src)
    return y


def _flat_step(out):
    y, cache = out
    return (y, *cache)


def decode_step(params, cfg, tokens, cache, cur_len, *, enc_out=None):
    """One-token decode.  tokens (B, 1); cur_len a 0-d integer tensor (the
    current cache fill) on the cache's device.  Returns (logits (B,1,V)
    fp32, cache): the cache is updated in place and returned."""
    dtype = _dtype(cfg)
    b = tokens.shape[0]
    positions = cur_len.to(torch.int32).reshape(1, 1).expand(b, 1)
    x = embed_tokens(params["embed"], tokens, dtype)
    window = cfg.sliding_window
    shared_ct = 0
    for si, seg in enumerate(segment_plan(cfg)):
        seg_params = params[f"seg{si}"]
        seg_cache = cache[f"seg{si}"]
        for r in range(seg.repeats):
            layer_p = _layer(seg_params, r)
            rep_cache = _layer(seg_cache, r)
            for j, kind in enumerate(seg.kinds):
                x, _ = _decode_block(layer_p[f"pos{j}"], cfg, kind, x,
                                     positions, rep_cache[f"pos{j}"],
                                     cur_len, window=window)
                if _shared_at(cfg, seg.layer_offset + r * len(seg.kinds) + j):
                    sp = params["shared_attn"]
                    a, _ = attn_mod.gqa_decode(
                        sp["attn"], cfg, apply_norm(sp["ln1"], x), positions,
                        _layer(cache["shared_attn"], shared_ct), cur_len,
                        window=window)
                    x = x + a
                    x = x + apply_mlp(sp["mlp"], apply_norm(sp["ln2"], x))
                    shared_ct += 1
            if cfg.is_encoder_decoder and enc_out is not None:
                x = _apply_cross(params, cfg, x, enc_out, r)
    x = apply_norm(params["final_norm"], x)
    return lm_head(params["embed"], x), cache
