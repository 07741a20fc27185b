"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536. Per 8-layer period:
attention at offset 4 (1:7 attn:mamba), MoE every other layer (16 MoE of 32).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    attn_period=8,
    attn_offset=4,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=0.0,   # jamba: no positional encoding (mamba provides order)
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid", num_layers=8, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    num_experts=4, top_k=2, moe_d_ff=128, moe_every=2, attn_period=8,
    attn_offset=4, mamba_d_state=8, mamba_dt_rank=8, moe_group_size=64,
    rope_theta=0.0, ssm_scan_chunk=8, dtype="float32", attn_impl="dense",
)
