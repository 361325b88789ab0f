"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA (MHA: kv=heads).  [arXiv:2404.14219]"""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, dtype="float32",
)

register(CONFIG, SMOKE)
