"""llama3-405b [dense] — GQA 128k vocab [arXiv:2407.21783; unverified].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256, head_dim=128.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
    grad_accum=16,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke", family="dense", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
    dtype="float32", attn_impl="dense",
)
