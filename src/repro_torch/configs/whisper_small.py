"""whisper-small [audio] — enc-dec backbone; conv frontend is a STUB
(``input_specs`` provides precomputed frame embeddings).  [arXiv:2212.04356]
"""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    num_encoder_layers=12, encoder_seq_len=1500,
    norm="layernorm", act="gelu", frontend="audio_stub",
    tensor_parallel=False,   # 0.3B on 256 chips: DP over both mesh axes
)

SMOKE = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    num_encoder_layers=2, encoder_seq_len=32,
    norm="layernorm", act="gelu", frontend="audio_stub", dtype="float32",
)

register(CONFIG, SMOKE)
