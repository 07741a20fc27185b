"""pixtral-12b [vlm] — pixtral-ViT frontend (stub) + mistral-nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified] 40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072. head_dim=128 (nemo: q-proj 5120→4096). The vision
tower is a stub: callers pass patch embeddings as ``image_embeds``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    num_image_tokens=256,
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    num_image_tokens=4,
    dtype="float32",
    attn_impl="dense",
)
