"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400, MoE 64e top-6.
First layer keeps a dense FFN (paper's layout); d_ff=1408 is the
fine-grained expert width (assignment-exact).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    moe_first_dense=1,
    moe_every=1,
    rope_theta=10000.0,
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke", family="moe", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=512,
    num_experts=8, top_k=2, num_shared_experts=2, moe_d_ff=96,
    moe_first_dense=1, moe_every=1, moe_group_size=64,
    dtype="float32", attn_impl="dense",
)
