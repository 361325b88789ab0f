"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    rope_theta=5e5,
    moe_num_experts=16, moe_top_k=1, moe_d_ff=8192,
    moe_shared_experts=1, moe_dense_layers=0,
    fsdp=True, remat="full",
)

SMOKE = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    moe_num_experts=4, moe_top_k=1, moe_d_ff=128,
    moe_shared_experts=1, dtype="float32",
)

register(CONFIG, SMOKE)
