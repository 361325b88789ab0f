"""starcoder2-7b [dense] — GQA kv=4, RoPE, layernorm+gelu.  [arXiv:2402.19173]"""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    qkv_bias=True, norm="layernorm", act="gelu", rope_theta=1e5,
)

SMOKE = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, norm="layernorm", act="gelu", dtype="float32",
)

register(CONFIG, SMOKE)
