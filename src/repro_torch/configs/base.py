"""ModelConfig: the single config type covering all assigned families.

Each assigned architecture gets one file in this package defining ``CONFIG``
(the exact published shape) and ``smoke_config()`` (a reduced same-family
variant for CPU tests).  ``registry()`` maps arch ids to configs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // num_heads
    # --- attention ---
    attention_type: str = "gqa"       # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (sums to head_dim//2)
    # --- MLA (deepseek-v3) ---
    mla_q_lora_rank: int = 0
    mla_kv_lora_rank: int = 0
    mla_qk_nope_dim: int = 0
    mla_qk_rope_dim: int = 0
    mla_v_dim: int = 0
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_experts: int = 0
    moe_dense_layers: int = 0         # leading dense layers (deepseek: 3)
    moe_capacity_factor: float = 1.25
    mtp_heads: int = 0                # deepseek multi-token prediction depth
    # --- SSM / hybrid ---
    block_pattern: tuple[str, ...] = ()  # cycled over layers; empty → ("attn",)
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0               # zamba2: shared attn block every k layers
    # --- enc-dec (whisper) ---
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500
    # --- frontend stubs ---
    frontend: str = "none"            # none | audio_stub | vision_stub
    # --- misc ---
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- distribution hints (launch-time) ---
    tensor_parallel: bool = True      # False: replicate weights, batch shards
                                      # over (data × model) — right for <1B
                                      # models where TP shards starve the MXU
                                      # and per-layer all-reduces dominate
    fsdp: bool = False                # shard params over data axis too (ZeRO-3)
    opt_state_dtype: str = "float32"  # bfloat16 for the very large archs
    remat: str = "full"               # none | full | dots
    sliding_window: int = 0           # hybrid long-context serving window

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encoder_decoder(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer block kind, len == num_layers."""
        if not self.block_pattern:
            return ("attn",) * self.num_layers
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def padded_heads(self, mesh_model: int) -> int:
        h = self.num_heads
        return -(-h // mesh_model) * mesh_model

    def padded_kv_heads(self, mesh_model: int) -> int:
        """MHA archs pad kv with q (group stays 1); GQA kv stays exact —
        q padding is chosen as a multiple of kv, and the decode cache shards
        over the sequence axis so kv never needs the mesh to divide it."""
        if self.num_kv_heads == self.num_heads:
            return self.padded_heads(mesh_model)
        return self.num_kv_heads

    def padded_vocab(self, multiple: int = 256) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def param_count_estimate(self) -> int:
        """Rough parameter count (embeddings + blocks), for 6ND roofline."""
        from repro_torch.models.transformer import build_schema
        from repro_torch.models.schema import param_count
        return param_count(build_schema(self, mesh_model=1))

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        total = self.param_count_estimate()
        if self.moe_num_experts == 0:
            return total
        e_ff = self.moe_d_ff or self.d_ff
        per_expert = 3 * self.d_model * e_ff
        moe_layers = self.num_layers - self.moe_dense_layers
        inactive = (self.moe_num_experts - self.moe_top_k) * per_expert * moe_layers
        return total - inactive


_REGISTRY: dict[str, "ModelConfig"] = {}
_SMOKE: dict[str, "ModelConfig"] = {}


def register(config: ModelConfig, smoke: ModelConfig) -> None:
    _REGISTRY[config.name] = config
    _SMOKE[config.name] = smoke


def registry() -> dict[str, ModelConfig]:
    from . import (qwen2_5_32b, phi3_mini, starcoder2_7b, qwen1_5_32b,  # noqa
                   qwen2_vl_72b, deepseek_v3_671b, llama4_scout,
                   xlstm_125m, zamba2_7b, whisper_small)
    return dict(_REGISTRY)


def smoke_registry() -> dict[str, ModelConfig]:
    registry()
    return dict(_SMOKE)


def get_config(name: str) -> ModelConfig:
    return registry()[name]


def get_smoke_config(name: str) -> ModelConfig:
    return smoke_registry()[name]
