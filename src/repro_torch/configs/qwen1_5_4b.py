"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

40L d_model=2560 20H (kv=20, MHA) d_ff=6912 vocab=151936, head_dim=128.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    qkv_bias=True, dtype="float32", attn_impl="dense",
)
