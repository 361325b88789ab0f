"""qwen2-vl-72b [vlm] — M-RoPE, dynamic-resolution vision frontend (stub).

Backbone only per assignment; ``input_specs`` provides precomputed patch
embeddings.  [arXiv:2409.12191]
"""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24),   # t/h/w sections of head_dim//2 = 64
    frontend="vision_stub",
    fsdp=True, opt_state_dtype="bfloat16", remat="full",
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, qkv_bias=True,
    mrope_sections=(2, 3, 3), frontend="vision_stub", dtype="float32",
)

register(CONFIG, SMOKE)
