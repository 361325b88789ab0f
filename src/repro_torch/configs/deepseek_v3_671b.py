"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168, 128 heads; first 3 layers dense (d_ff 18432), the rest MoE
with 2048-wide experts.  MLA: q_lora 1536, kv_lora 512, qk nope/rope 128/64,
v 128.  [arXiv:2412.19437]
"""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    attention_type="mla", head_dim=192,          # qk head dim = nope+rope
    mla_q_lora_rank=1536, mla_kv_lora_rank=512,
    mla_qk_nope_dim=128, mla_qk_rope_dim=64, mla_v_dim=128,
    moe_num_experts=256, moe_top_k=8, moe_d_ff=2048,
    moe_shared_experts=1, moe_dense_layers=3,
    mtp_heads=1,
    fsdp=True, opt_state_dtype="bfloat16", remat="full",
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    attention_type="mla", head_dim=48,
    mla_q_lora_rank=32, mla_kv_lora_rank=16,
    mla_qk_nope_dim=32, mla_qk_rope_dim=16, mla_v_dim=32,
    moe_num_experts=8, moe_top_k=2, moe_d_ff=64,
    moe_shared_experts=1, moe_dense_layers=1,
    mtp_heads=1, dtype="float32",
)

register(CONFIG, SMOKE)
