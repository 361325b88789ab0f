"""qwen1.5-32b [dense] — MHA (kv=40), QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    fsdp=True, remat="full",
)

SMOKE = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, qkv_bias=True, dtype="float32",
)

register(CONFIG, SMOKE)
