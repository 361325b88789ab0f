"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (7:1-ish ratio → 3:1 over 12L).

No separate MLP (d_ff=0): xLSTM blocks integrate up/down projections.
[arXiv:2405.04517]
"""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ssm_expand=2, ssm_chunk=256, norm="layernorm",
    tensor_parallel=False,   # 0.19B on 256 chips: DP over both mesh axes
)

SMOKE = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab_size=512,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ssm_expand=2, ssm_chunk=16, norm="layernorm", dtype="float32",
)

register(CONFIG, SMOKE)
