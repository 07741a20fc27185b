"""whisper-large-v3 [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].

32L (enc) + 32L (dec) d_model=1280 20H (kv=20) d_ff=5120 vocab=51866. The
conv/mel frontend is a stub: callers pass precomputed frame embeddings
``(B, encoder_seq, d_model)`` as ``frames``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    encoder_seq=1500,
    rope_theta=0.0,      # learned/sinusoidal positions
    grad_accum=2,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec", num_layers=2, encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512, encoder_seq=32, rope_theta=0.0, dtype="float32",
    attn_impl="dense",
)
