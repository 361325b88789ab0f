"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block every 7th
slot (one weight set reused, the Zamba trick).  ssm_state=64.
Long-context serving uses a 4096-token sliding window on the shared attention
(sub-quadratic; see DESIGN.md §6).  [arXiv:2411.15242]
"""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    block_pattern=("mamba",),
    ssm_state_dim=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=7, sliding_window=4096,
)

SMOKE = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    block_pattern=("mamba",),
    ssm_state_dim=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
    attn_every=2, sliding_window=64, dtype="float32",
)

register(CONFIG, SMOKE)
