"""llama4-maverick-400b-a17b [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
(+1 shared), interleaved every other layer (maverick layout).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    top_k=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    moe_every=2,
    rope_theta=500000.0,
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    num_experts=8, top_k=1, num_shared_experts=1, moe_d_ff=128, moe_every=2,
    moe_group_size=64, dtype="float32", attn_impl="dense",
)
