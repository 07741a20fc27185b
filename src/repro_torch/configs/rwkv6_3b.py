"""rwkv6-3b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536, head_size=64
(40 wkv heads).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,        # wkv heads = d_model / head_size
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_size=64,
    rwkv_lora=64,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    rwkv_head_size=16, rwkv_lora=8, ssm_scan_chunk=8, dtype="float32",
)
