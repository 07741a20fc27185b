"""Config schema: model architecture + runtime knobs + the assigned shapes.

A copy of the reference package's schema with its field names, order and
defaults unchanged, so a config compares field by field across packages.
Dtypes stay strings; :func:`torch_dtype` maps them to ``torch.dtype``. The
assigned shape cells (``SHAPES``) and the rule that skips some of them
(:func:`shape_applicable`) are the reference's too.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 → d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_first_dense: int = 0
    moe_every: int = 1
    moe_group_size: int = 512
    capacity_factor: float = 1.25

    # --- hybrid (jamba) ---
    attn_period: int = 0
    attn_offset: int = 4
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0      # 0 → ceil(d_model / 16)

    # --- rwkv ---
    rwkv_head_size: int = 64
    rwkv_lora: int = 64

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- vlm (pixtral) ---
    num_image_tokens: int = 0

    # --- numerics / runtime ---
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    cache_dtype: str = "bfloat16"
    # kept for field parity with the reference; the port's attention is
    # chosen by device (hand-written kernel on CUDA, plain torch on CPU)
    attn_impl: str = "flash"
    # "" keeps cache_dtype; "int8" is a later slice of the port
    kv_dtype: str = ""
    q_chunk: int = 512
    kv_chunk: int = 1024
    scan_layers: bool = True
    remat: bool = True
    ssm_scan_chunk: int = 64
    grad_accum: int = 1
    kernel_impl: str = "ref"          # parity field; dispatch is by device

    # --- BCR sparsity (the paper's technique) ---
    bcr_keep_frac: float = 0.0        # 0 → dense; else kept density of linears
    bcr_block: Tuple[int, int] = (128, 128)

    # --- tensor parallelism (serving) — a later slice of the port ---
    tp_axis: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.mamba_dt_rank == 0:
            object.__setattr__(self, "mamba_dt_rank", -(-self.d_model // 16))

    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def c_dtype(self) -> torch.dtype:
        return torch_dtype(self.cache_dtype)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (seq_len × global_batch) input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Shape cells skipped per the assignment (sub-quadratic requirement / family).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether the cell ``cfg`` × ``shape`` runs, and why not: ``long_500k``
    needs a sub-quadratic family (``LONG_CONTEXT_FAMILIES``)."""
    if shape.name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, ("skipped: long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is a pure full-attention arch (DESIGN.md)")
    return True, ""
