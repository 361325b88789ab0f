"""Input stand-ins and shardings per (arch × shape).

The four assigned shape cells; ``decode_*``/``long_*`` run ``decode_step``
(one new token against a seq_len KV cache), ``train_4k`` runs
``train_step``, ``prefill_32k`` runs the full-sequence forward.
long_500k runs only for the sub-quadratic archs (DESIGN §6).  The inputs
are ``meta`` tensors (shape and dtype, no storage), where the JAX package
has ``ShapeDtypeStruct``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import P

SHAPES: dict[str, dict] = {
    "train_4k":    dict(kind="train",   seq=4_096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768,  batch=32),
    "decode_32k":  dict(kind="decode",  seq=32_768,  batch=128),
    "long_500k":   dict(kind="decode",  seq=524_288, batch=1),
}

# long-context decode needs sub-quadratic state (SSM / hybrid-with-window)
LONG_CONTEXT_ARCHS = {"xlstm-125m", "zamba2-7b"}

VISION_PATCHES = 256          # vlm stub: patches prepended to the sequence


def cell_is_live(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def live_cells(archs: list[str]) -> list[tuple[str, str]]:
    return [(a, s) for a in archs for s in SHAPES if cell_is_live(a, s)]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_structs(cfg: ModelConfig, shape_name: str) -> dict[str, Any]:
    """Stand-ins for the model inputs of a train/prefill cell."""
    sh = SHAPES[shape_name]
    b, s = sh["batch"], sh["seq"]
    dt = getattr(torch, cfg.dtype)
    batch: dict[str, Any] = {"tokens": _meta((b, s), torch.int32)}
    if cfg.mrope_sections:
        batch["positions"] = _meta((3, b, s), torch.int32)
    else:
        batch["positions"] = _meta((b, s), torch.int32)
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = _meta((b, VISION_PATCHES, cfg.d_model), dt)
    if cfg.frontend == "audio_stub":
        batch["frame_embeds"] = _meta((b, cfg.encoder_seq_len, cfg.d_model),
                                      dt)
    if sh["kind"] == "train":
        batch["labels"] = _meta((b, s), torch.int32)
    return batch


def _batch_axes(cfg: ModelConfig, batch: int, multi_pod: bool):
    """Longest divisible prefix of the batch-shardable mesh axes."""
    axes = [("pod", 2)] if multi_pod else []
    axes.append(("data", 16))
    if not cfg.tensor_parallel:
        axes.append(("model", 16))
    chosen, prod = [], 1
    for name, size in axes:
        if batch % (prod * size) == 0:
            chosen.append(name)
            prod *= size
    if not chosen:
        return None
    return chosen[0] if len(chosen) == 1 else tuple(chosen)


def batch_pspecs(cfg: ModelConfig, shape_name: str, multi_pod: bool) -> dict:
    sh = SHAPES[shape_name]
    dshard = _batch_axes(cfg, sh["batch"], multi_pod)
    out = {"tokens": P(dshard, None)}
    out["positions"] = (P(None, dshard, None) if cfg.mrope_sections
                        else P(dshard, None))
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = P(dshard, None, None)
    if cfg.frontend == "audio_stub":
        out["frame_embeds"] = P(dshard, None, None)
    if sh["kind"] == "train":
        out["labels"] = P(dshard, None)
    return out


def decode_structs(cfg: ModelConfig, shape_name: str, mesh_model: int = 16):
    """(tokens, cur_len, cache, enc_out?) stand-ins for a decode cell."""
    from repro_torch.models import transformer as tmod
    sh = SHAPES[shape_name]
    b, s = sh["batch"], sh["seq"]
    tokens = _meta((b, 1), torch.int32)
    cur_len = _meta((), torch.int32)
    cache = tmod.init_cache(cfg, b, s, mesh_model, device="meta")
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _meta((b, cfg.encoder_seq_len, cfg.d_model),
                        getattr(torch, cfg.dtype))
    return tokens, cur_len, cache, enc_out


def decode_pspecs(cfg: ModelConfig, shape_name: str, multi_pod: bool,
                  mesh_model: int = 16):
    from repro_torch.models.sharding import cache_spec_tree
    sh = SHAPES[shape_name]
    dsize = 32 if multi_pod else 16
    data = ("pod", "data") if multi_pod else "data"
    dshard = data if sh["batch"] % dsize == 0 else None
    cache_specs = cache_spec_tree(cfg, mesh_model, multi_pod)
    if dshard is None:  # long_500k batch=1: replicate the batch axis
        cache_specs = _map_specs(
            lambda p: P(*[None if ax in ("data", ("pod", "data")) else ax
                          for ax in p]), cache_specs)
    tokens_spec = P(dshard, None)
    enc_spec = P(dshard, None, None) if cfg.is_encoder_decoder else None
    return tokens_spec, P(), cache_specs, enc_spec


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, P):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    return fn(tree)
