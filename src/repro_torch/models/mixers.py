"""Sequence mixers beyond attention: the Mamba selective SSM (jamba's
mixer) and RWKV6 "Finch" time-mix / channel-mix (data-dependent decay), a
copy of the reference package's ``models/mixers.py`` in PyTorch.

Each has a sequence form (training and prefill; a chunked scan over time)
and a one-token step form (decode; O(1) state). Every projection goes
through ``core.sparse_linear.linear_apply``, so a BCR-packed layer runs
``bcr_spmm``. The recurrences themselves (the SSM scan, the WKV state
update) are ``lax.scan`` in the reference, XLA code outside any Pallas
kernel; here they are plain torch loops (``chunked_checkpoint_scan``).
Recurrent state stays in fp32, as the reference keeps it: mamba's ``h``
``(B, d_in, n)`` and RWKV's WKV state ``s`` ``(B, H, hs, hs)``, with the
decays computed in fp32.

The step forms take the layer's state dict and return the new state; the
caller writes it back (``causal_lm`` does so in place, into the pool's
tensors).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_linear import linear_apply, linear_init
from repro_torch.models.layers import chunked_checkpoint_scan

Params = Dict[str, Any]


def scan_chunk(cfg, s: int) -> int:
    """The callers' chunk rule: ``min(ssm_scan_chunk, S)``, or 1 when that
    does not divide S."""
    chunk = min(cfg.ssm_scan_chunk, s)
    return 1 if s % chunk else chunk


def _randn(generator: torch.Generator, shape, scale: float, dtype):
    return (torch.randn(shape, generator=generator, device=generator.device)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# Mamba (selective SSM): jamba's dominant mixer
# ---------------------------------------------------------------------------


def mamba_init(generator: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    r = cfg.mamba_dt_rank
    dt = cfg.p_dtype
    dev = generator.device
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": linear_init(generator, d, 2 * d_in, dtype=dt),
        "conv_w": _randn(generator, (cfg.mamba_d_conv, d_in), 0.1, dt),
        "conv_b": torch.zeros((d_in,), dtype=dt, device=dev),
        "x_proj": linear_init(generator, d_in, r + 2 * n, dtype=dt),
        "dt_proj": linear_init(generator, r, d_in, bias=True, dtype=dt),
        "A_log": torch.log(a.repeat(d_in, 1)).to(dt),
        "D": torch.ones((d_in,), dtype=dt, device=dev),
        "out_proj": linear_init(generator, d_in, d, dtype=dt),
    }


def _mamba_ssm_inputs(params: Params, x: torch.Tensor, cfg,
                      conv_state: Optional[torch.Tensor] = None):
    """The shared front half: in-proj, the causal depthwise conv (width
    ``mamba_d_conv``, continuing ``conv_state`` ``(B, k-1, d_in)`` when
    given), the SSM parameter projections. x ``(B, S, d)`` → ``(u, z,
    delta, B, C, new_conv_state)``: u ``(B, S, d_in)`` the conv + silu
    output, z the gate, delta ``(B, S, d_in)`` and B/C ``(B, S, n)`` in
    fp32."""
    d_in = cfg.mamba_expand * cfg.d_model
    n = cfg.mamba_d_state
    r = cfg.mamba_dt_rank
    xz = linear_apply(params["in_proj"], x)
    u, z = xz[..., :d_in], xz[..., d_in:]
    k = cfg.mamba_d_conv
    if conv_state is None:
        pad = torch.zeros((u.shape[0], k - 1, d_in), dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    u_pad = torch.cat([pad, u], dim=1)                  # (B, S+k-1, d_in)
    new_conv_state = u_pad[:, u_pad.shape[1] - (k - 1):]
    s = u.shape[1]
    conv = sum(u_pad[:, i:i + s] * params["conv_w"][i].to(u.dtype)
               for i in range(k)) + params["conv_b"].to(u.dtype)
    u = F.silu(conv)
    x_db = linear_apply(params["x_proj"], u).float()
    dt, bmat, cmat = torch.split(x_db, [r, n, n], dim=-1)
    delta = F.softplus(linear_apply(params["dt_proj"], dt.to(u.dtype))
                       .float())
    return u, z, delta, bmat, cmat, new_conv_state


def _mamba_step(a: torch.Tensor, d_skip: torch.Tensor, h: torch.Tensor,
                u_t, delta_t, b_t, c_t):
    """One SSM step; ``a = -exp(A_log)`` ``(d_in, n)`` fp32, h ``(B, d_in,
    n)`` fp32."""
    da = torch.exp(delta_t[..., None] * a)               # (B, d_in, n)
    db = delta_t[..., None] * b_t[:, None, :]            # (B, d_in, n)
    h = da * h + db * u_t[..., None].float()
    y = (torch.einsum("bdn,bn->bd", h, c_t)
         + d_skip.float() * u_t.float())
    return h, y


def mamba_apply_seq(params: Params, x: torch.Tensor, cfg,
                    return_state: bool = False):
    """x ``(B, S, d)`` → y ``(B, S, d)`` (and with ``return_state`` the
    state after the last position: ``{"h", "conv"}``)."""
    b, s, _ = x.shape
    d_in = cfg.mamba_expand * cfg.d_model
    u, z, delta, bmat, cmat, conv_tail = _mamba_ssm_inputs(params, x, cfg)
    a = -torch.exp(params["A_log"].float())
    d_skip = params["D"]

    def body(h, inp):
        return _mamba_step(a, d_skip, h, *inp)

    h0 = torch.zeros((b, d_in, cfg.mamba_d_state), dtype=torch.float32,
                     device=x.device)
    xs = tuple(t.transpose(0, 1) for t in (u, delta, bmat, cmat))
    h_final, ys = chunked_checkpoint_scan(body, h0, xs, scan_chunk(cfg, s))
    y = ys.transpose(0, 1).to(x.dtype) * F.silu(z)      # (B, S, d_in)
    out = linear_apply(params["out_proj"], y)
    if return_state:
        return out, {"h": h_final, "conv": conv_tail}
    return out


def mamba_init_cache(cfg, batch: int, dtype, device) -> Params:
    d_in = cfg.mamba_expand * cfg.d_model
    return {
        "h": torch.zeros((batch, d_in, cfg.mamba_d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, d_in), dtype=dtype,
                            device=device),
    }


def mamba_apply_step(params: Params, x: torch.Tensor, cache: Params, cfg
                     ) -> Tuple[torch.Tensor, Params]:
    """x ``(B, 1, d)`` → (y ``(B, 1, d)``, the new ``{"h", "conv"}``)."""
    u, z, delta, bmat, cmat, new_conv = _mamba_ssm_inputs(
        params, x, cfg, conv_state=cache["conv"])
    a = -torch.exp(params["A_log"].float())
    h, y = _mamba_step(a, params["D"], cache["h"], u[:, 0], delta[:, 0],
                       bmat[:, 0], cmat[:, 0])
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    out = linear_apply(params["out_proj"], y)
    return out, {"h": h, "conv": new_conv}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): time-mix with data-dependent decay + channel-mix
# ---------------------------------------------------------------------------


def rwkv_tm_init(generator: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    h = d // hs
    lora = cfg.rwkv_lora
    dt = cfg.p_dtype
    dev = generator.device
    mu = (torch.rand((5, d), generator=generator, device=dev) * 0.5).to(dt)
    return {
        "mu": mu,                                   # r, k, v, g, w shifts
        "wr": linear_init(generator, d, d, dtype=dt),
        "wk": linear_init(generator, d, d, dtype=dt),
        "wv": linear_init(generator, d, d, dtype=dt),
        "wg": linear_init(generator, d, d, dtype=dt),
        "wo": linear_init(generator, d, d, dtype=dt),
        # base decay: w = exp(-exp(w0 + lora)) ~ exp(-exp(-4))
        "w0": torch.full((d,), -4.0, dtype=dt, device=dev),
        "w_lora_a": _randn(generator, (lora, d), 0.01, dt),
        "w_lora_b": _randn(generator, (d, lora), 0.01, dt),
        "u": torch.zeros((h, hs), dtype=dt, device=dev),  # per-head bonus
        "ln_scale": torch.ones((d,), dtype=dt, device=dev),
    }


def _rwkv_tm_inputs(params: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift mixes and projections. x, x_prev ``(B, S, d)`` (x_prev
    the previous position's x) → r, k, v, g in x's dtype and the decay w
    ``(B, S, d)`` in fp32, in (0, 1)."""
    mu = params["mu"].to(x.dtype)

    def mix(i):
        return x + mu[i] * (x_prev - x)

    r = linear_apply(params["wr"], mix(0))
    k = linear_apply(params["wk"], mix(1))
    v = linear_apply(params["wv"], mix(2))
    g = F.silu(linear_apply(params["wg"], mix(3)))
    ww = torch.tanh(mix(4).float() @ params["w_lora_a"].float().T)
    ww = ww @ params["w_lora_b"].float().T
    w = torch.exp(-torch.exp(params["w0"].float() + ww))
    return r, k, v, g, w


def _rwkv_step(n_heads: int, hs: int, u: torch.Tensor, s: torch.Tensor,
               r_t, k_t, v_t, w_t):
    """One WKV6 step. s ``(B, H, hs, hs)`` fp32; r/k/v/w_t ``(B, d)``."""
    b = r_t.shape[0]
    r = r_t.float().reshape(b, n_heads, hs)
    k = k_t.float().reshape(b, n_heads, hs)
    v = v_t.float().reshape(b, n_heads, hs)
    w = w_t.reshape(b, n_heads, hs)
    kv = k[..., :, None] * v[..., None, :]              # (B, H, hs, hs)
    y = torch.einsum("bhk,bhkv->bhv", r, s + u[None, :, :, None] * kv)
    s = w[..., :, None] * s + kv
    return s, y


def _rwkv_out(params: Params, y: torch.Tensor, g: torch.Tensor):
    """Per-head RMS norm → gate → output projection. y ``(B, S, H, hs)``
    fp32."""
    b, s_len, h, hs = y.shape
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-5)).reshape(b, s_len, h * hs)
    y = (y * params["ln_scale"].float()).to(g.dtype) * g
    return linear_apply(params["wo"], y)


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """x one position later: zeros at position 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def rwkv_tm_apply_seq(params: Params, x: torch.Tensor, cfg,
                      return_state: bool = False):
    """x ``(B, S, d)`` → y (and with ``return_state`` ``{"s", "shift"}``:
    the WKV state after the last position and that position's x in
    ``cache_dtype``)."""
    b, s_len, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    r, k, v, g, w = _rwkv_tm_inputs(params, x, _shifted(x))
    u = params["u"].float()

    def body(s, inp):
        return _rwkv_step(h, hs, u, s, *inp)

    s0 = torch.zeros((b, h, hs, hs), dtype=torch.float32, device=x.device)
    xs = tuple(t.transpose(0, 1) for t in (r, k, v, w))
    s_final, ys = chunked_checkpoint_scan(body, s0, xs,
                                          scan_chunk(cfg, s_len))
    out = _rwkv_out(params, ys.transpose(0, 1), g)
    if return_state:
        return out, {"s": s_final, "shift": x[:, -1].to(cfg.c_dtype)}
    return out


def rwkv_tm_init_cache(cfg, batch: int, dtype, device) -> Params:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    return {
        "s": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32,
                         device=device),
        "shift": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv_tm_apply_step(params: Params, x: torch.Tensor, cache: Params, cfg
                       ) -> Tuple[torch.Tensor, Params]:
    """x ``(B, 1, d)`` → (y, the new ``{"s", "shift"}``)."""
    d = x.shape[-1]
    hs = cfg.rwkv_head_size
    h = d // hs
    x_prev = cache["shift"].to(x.dtype)[:, None, :]
    r, k, v, g, w = _rwkv_tm_inputs(params, x, x_prev)
    u = params["u"].float()
    s, y = _rwkv_step(h, hs, u, cache["s"], r[:, 0], k[:, 0], v[:, 0],
                      w[:, 0])
    out = _rwkv_out(params, y[:, None], g)
    return out, {"s": s, "shift": x[:, 0].to(cache["shift"].dtype)}


def rwkv_cm_init(generator: torch.Generator, cfg) -> Params:
    d, dff = cfg.d_model, cfg.d_ff
    dt = cfg.p_dtype
    mu = (torch.rand((2, d), generator=generator, device=generator.device)
          * 0.5).to(dt)
    return {
        "mu": mu,                                   # k, r shifts
        "wk": linear_init(generator, d, dff, dtype=dt),
        "wv": linear_init(generator, dff, d, dtype=dt),
        "wr": linear_init(generator, d, d, dtype=dt),
    }


def rwkv_cm_apply(params: Params, x: torch.Tensor,
                  x_prev: torch.Tensor) -> torch.Tensor:
    mu = params["mu"].to(x.dtype)
    xk = x + mu[0] * (x_prev - x)
    xr = x + mu[1] * (x_prev - x)
    k = torch.square(F.relu(linear_apply(params["wk"], xk)))
    kv = linear_apply(params["wv"], k)
    return torch.sigmoid(linear_apply(params["wr"], xr)) * kv


def rwkv_cm_apply_seq(params: Params, x: torch.Tensor) -> torch.Tensor:
    return rwkv_cm_apply(params, x, _shifted(x))


def rwkv_cm_apply_step(params: Params, x: torch.Tensor, shift: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, 1, d)``, ``shift`` the previous token's x ``(B, d)`` → (y,
    the new shift in ``shift``'s dtype)."""
    y = rwkv_cm_apply(params, x, shift.to(x.dtype)[:, None, :])
    return y, x[:, 0].to(shift.dtype)
