"""Sequence mixers beyond attention: the Mamba selective SSM (jamba's
mixer) and RWKV6 "Finch" time-mix / channel-mix (data-dependent decay), a
copy of the reference package's ``models/mixers.py`` in PyTorch.

Each has a sequence form (training and prefill) and a one-token step form
(decode; O(1) state). Every projection goes through
``core.sparse_linear.linear_apply``, so a BCR-packed layer runs
``bcr_spmm``. The recurrences themselves (the SSM scan, the WKV state
update) are ``lax.scan`` in the reference, XLA code outside any Pallas
kernel, one step a token. The sequence forms here run them in block form
(``layers.block_scan``, blocks of ``min(ssm_scan_chunk, S)`` positions,
the tail padded with identity steps): the work inside a block is batched
over many blocks at once, and only the state crosses from block to block,
so a layer dispatches a few hundred ops where a loop over tokens
dispatches some twenty a token. The step forms are that loop's body
(``_mamba_step``, ``_rwkv_step``); run over a sequence by
``layers.chunked_checkpoint_scan`` they are the plain version the tests
hold the block forms to.

- WKV6, a block of C positions: the inter-block part (``r_t`` against the
  carried state, decayed to t), the intra-block pairs ``r_t · (decay over
  τ+1..t-1) · k_τ v_τᵀ`` for τ < t, and the bonus ``u`` at τ = t. Every
  decay is the exp of a masked segment sum of ``log w`` (a cumulative sum
  down a masked (C+1)² grid), never a difference of long cumulative sums
  (which loses digits) nor a product ``exp(A_t)·exp(-A_τ)`` (which
  overflows when decays are strong). The carry is the state decayed over
  the block plus the block's ``k v`` terms.
- The selective SSM: its decay ``exp(Δ_t a)`` differs per (channel,
  state), so pairs would cost C² · d_in · n; it runs an associative scan
  over the pairs (decay, input) inside each block and again over the
  blocks of a group (``layers.linear_scan``), log2 steps each.

Under partitioning rules each scan runs on the local shards (``part.local``;
heads and channels never need another rank), after one redistribution of
each input to a layout whose time axis and reduced dims are whole.
Recurrent state stays in fp32, as the reference keeps it: mamba's ``h``
``(B, d_in, n)`` and RWKV's WKV state ``s`` ``(B, H, hs, hs)``, with the
decays computed in fp32.

The step forms take the layer's state dict and return the new state; the
caller writes it back (``causal_lm`` does so in place, into the pool's
tensors).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_linear import linear_apply, linear_init
from repro_torch.models.layers import block_scan, linear_scan
from repro_torch.runtime import partitioning as part

Params = Dict[str, Any]


def scan_chunk(cfg, s: int) -> int:
    """The reference's chunk rule for its scan, and so the plain version's
    (``layers.chunked_checkpoint_scan``): ``min(ssm_scan_chunk, S)``, or 1
    when that does not divide S. The block forms take blocks of
    ``min(ssm_scan_chunk, S)`` and pad the tail instead."""
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
    # whole sequences into in_proj (its gradient then meets no sequence
    # shard); the halves of a channel-sharded xz are not each rank's:
    # gather the channels once, then each half's channels over the model
    # axis (the gather's backward hands in_proj's gradient back as shards;
    # no-ops without rules)
    x = part.act(x, "batch", "seq", "embed")
    xz = part.act(linear_apply(params["in_proj"], x), "batch", "seq", None)
    u, z = (part.act(t, "batch", "seq", "mlp")
            for t in (xz[..., :d_in], xz[..., d_in:]))
    # the causal conv and its silu are per channel: each rank's channels
    ul = part.local(u)
    k = cfg.mamba_d_conv
    if conv_state is None:
        pad = torch.zeros((ul.shape[0], k - 1, ul.shape[2]), dtype=ul.dtype,
                          device=ul.device)
    else:
        pad = part.local(part.act(conv_state, "batch", None, "mlp"))
        pad = pad.to(ul.dtype)
    u_pad = torch.cat([pad, ul], dim=1)                 # (B, S+k-1, d_in)
    new_conv_state = part.like(u_pad[:, u_pad.shape[1] - (k - 1):], u,
                               dims=(0, None, 2))
    s = ul.shape[1]
    conv_w = part.local(part.act(params["conv_w"], None, "mlp"))
    conv_b = part.local(part.act(params["conv_b"], "mlp"))
    conv = sum(u_pad[:, i:i + s] * conv_w[i].to(ul.dtype)
               for i in range(k)) + conv_b.to(ul.dtype)
    u = part.like(F.silu(conv), u)
    x_db = linear_apply(params["x_proj"], u).float()
    dt, bmat, cmat = torch.split(x_db, [r, n, n], dim=-1)
    # delta laid out as the scan takes it (channels over the model axis);
    # the softplus runs on the local shards (DTensor has no rule for its
    # backward, which would otherwise run on the gathered whole)
    delta = part.act(linear_apply(params["dt_proj"], dt.to(u.dtype)).float(),
                     "batch", "seq", "mlp")
    delta = part.like(F.softplus(part.local(delta)), delta)
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


def _ssm_blocks(a: torch.Tensor, d_skip: torch.Tensor, h: torch.Tensor,
                u, delta, b, c):
    """A group of G blocks of C positions of the SSM (``block_scan``'s
    body): ``a`` ``(d_in, n)`` and ``d_skip`` ``(d_in,)`` fp32, ``h`` the
    state before the group ``(B, d_in, n)``, u and delta ``(B, G, C,
    d_in)``, B/C ``(B, G, C, n)`` → (the state after it, y ``(B, G, C,
    d_in)`` fp32). Each step's pair is ``_mamba_step``'s decay and input;
    a scan inside each block, then one over the blocks' last pairs, gives
    each block's starting state."""
    da = torch.exp(delta[..., None] * a)                 # (B, G, C, d_in, n)
    db = delta[..., None] * b[..., None, :] * u[..., None].float()
    acum, bcum = linear_scan(da, db, 2)                  # from block start
    pa, pb = linear_scan(acum[:, :, -1], bcum[:, :, -1], 1)
    h_end = pa * h[:, None] + pb                         # (B, G, d_in, n)
    h_in = torch.cat([h[:, None], h_end[:, :-1]], 1)
    hs = acum * h_in[:, :, None] + bcum
    y = torch.einsum("bgcdn,bgcn->bgcd", hs, c) + d_skip * u.float()
    return h_end[:, -1], y


def _ssm_seq(u, delta, bmat, cmat, a_log, d_param, cfg):
    """The selective scan over a sequence, in blocks (``_ssm_blocks``) on
    local shards: u ``(B, S, d_in)`` (x's dtype), delta ``(B, S, d_in)``
    and B/C ``(B, S, n)`` fp32, ``A_log`` and ``D`` the layer's → (y
    ``(B, S, d_in)`` fp32 before the gate, the state after the last
    position ``(B, d_in, n)``). Channels lie over the model axis, B/C whole
    on every rank; one redistribution each, no rank needs another's."""
    u, delta = (part.act(t, "batch", "seq", "mlp") for t in (u, delta))
    bmat, cmat = (part.act(t, "batch", "seq", None) for t in (bmat, cmat))
    a = part.local(part.act(-torch.exp(a_log.float()), "mlp", None))
    d_skip = part.local(part.act(d_param, "mlp")).float()
    xs = [part.local(t) for t in (u, delta, bmat, cmat)]
    bsz, s, d_in = xs[0].shape
    n = a.shape[-1]
    chunk = min(cfg.ssm_scan_chunk, s)
    h0 = torch.zeros((bsz, d_in, n), dtype=torch.float32, device=a.device)
    h, ys = block_scan(functools.partial(_ssm_blocks, a, d_skip), h0, xs,
                       chunk, (0.0,) * 4, 4 * bsz * chunk * d_in * n)
    return part.like(ys, u), part.like(h, u, dims=(0, 2, None))


def mamba_apply_seq(params: Params, x: torch.Tensor, cfg,
                    return_state: bool = False):
    """x ``(B, S, d)`` → y ``(B, S, d)`` (and with ``return_state`` the
    state after the last position: ``{"h", "conv"}``)."""
    u, z, delta, bmat, cmat, conv_tail = _mamba_ssm_inputs(params, x, cfg)
    ys, h_final = _ssm_seq(u, delta, bmat, cmat, params["A_log"],
                           params["D"], cfg)
    y = ys.to(x.dtype) * F.silu(z)                       # (B, S, d_in)
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
    the previous position's x) → r, k, v, g in x's dtype and the decay's
    log ``log w = -exp(w0 + lora)`` ``(B, S, d)`` in fp32 (w in (0, 1))."""
    mu = params["mu"].to(x.dtype)

    def mix(i):
        return x + mu[i] * (x_prev - x)

    def proj(name, i):
        # the mix on each rank's sequence shard, then whole sequences into
        # a column-parallel projection (no-ops without rules)
        return linear_apply(params[name],
                            part.act(mix(i), "batch", "seq", "embed"))

    r, k, v = proj("wr", 0), proj("wk", 1), proj("wv", 2)
    g = F.silu(proj("wg", 3))
    # the decay's lora and w0 are whole on every rank: each rank's rows
    m4 = part.act(mix(4), "batch", "seq_sp", "embed")
    lora = part.whole({n: params[n] for n in ("w_lora_a", "w_lora_b", "w0")})
    ww = torch.tanh(part.local(m4).float() @ lora["w_lora_a"].float().T)
    ww = ww @ lora["w_lora_b"].float().T
    lw = part.like(-torch.exp(lora["w0"].float() + ww), m4)
    return r, k, v, g, lw


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


def _wkv_blocks(u: torch.Tensor, s: torch.Tensor, r, k, v, lw):
    """A group of G blocks of C positions of WKV6 (``block_scan``'s body):
    ``u`` ``(H, hs)`` fp32, ``s`` the state before the group ``(B, H, hs,
    hs)``, r/k/v/lw ``(B, G, C, H, hs)`` fp32 (lw = log w) → (the state
    after it, y ``(B, G, C, H, hs)``). With a zero prepended to each
    block's log w, ``e[i, j] = exp(Σ log w over positions j..i-1)`` (0
    where i < j) holds every decay a block needs: ``e[t, τ+1]`` from τ+1
    to t-1, ``e[t, 0]`` from the block's start to t-1, ``e[C, τ+1]`` from
    τ+1 to its end and ``e[C, 0]`` over all of it."""
    r, k, v, lw = (t.transpose(2, 3) for t in (r, k, v, lw))  # (B,G,H,C,hs)
    c = r.shape[3]
    ones = torch.ones((c + 1, c + 1), dtype=torch.bool, device=r.device)
    x = F.pad(lw, (0, 0, 1, 0))                         # (B, G, H, C+1, hs)
    seg = x.unsqueeze(-2).expand(*x.shape[:-1], c + 1, x.shape[-1])
    seg = seg.masked_fill(ones.triu()[:, :, None], 0.0).cumsum(-3)
    e = seg.masked_fill(ones.triu(1)[:, :, None], float("-inf")).exp()
    pairs = ((e[..., :c, 1:, :] * k.unsqueeze(-3)) @ r.unsqueeze(-1))
    y = pairs.squeeze(-1) @ v                           # τ < t
    y = y + (r * u[:, None] * k).sum(-1, keepdim=True) * v     # τ = t
    kv = (k * e[..., c, 1:, :]).transpose(-1, -2) @ v   # (B, G, H, hs, hs)
    starts = []
    for decay, add in zip(e[..., c, 0, :, None].unbind(1), kv.unbind(1)):
        starts.append(s)
        s = decay * s + add
    y = y + (r * e[..., :c, 0, :]) @ torch.stack(starts, 1)
    return s, y.transpose(2, 3)


def _rwkv_out(params: Params, y: torch.Tensor, g: torch.Tensor):
    """Per-head RMS norm → gate → output projection. y ``(B, S, H, hs)``
    fp32."""
    b, s_len, h, hs = y.shape
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-5)).reshape(b, s_len, h * hs)
    y = (y * params["ln_scale"].float()).to(g.dtype) * g
    return linear_apply(params["wo"], y)


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """x one position later: zeros at position 0. Under rules laid out as
    the residual stream (``seq_sp``), so the token-shift mixes and the
    products with replicated weights (the decay's lora, the channel-mix's
    ``wr``) run on each rank's sequence shard, as the reference's
    partitioned program runs them, not on the whole sequence on every
    rank."""
    prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return part.act(prev, "batch", "seq_sp", "embed")


def _wkv_seq(r, k, v, lw, u, cfg):
    """The WKV recurrence over a sequence, in blocks (``_wkv_blocks``) on
    local shards: r/k/v ``(B, S, d)`` (x's dtype), lw ``(B, S, d)`` fp32,
    ``u`` the layer's bonus ``(H, hs)`` → (y ``(B, S, d)`` fp32, the state
    after the last position ``(B, H, hs, hs)``). Each rank keeps its heads
    whole: no mesh axis divides rwkv's heads (40; 4 at SMOKE width), so d
    stays whole on every rank, as the reference's partitioned scan keeps
    it; one redistribution each."""
    s_len, d = r.shape[1], r.shape[2]
    hs = cfg.rwkv_head_size
    h = d // hs
    ins = [part.act(t, "batch", "seq", None) for t in (r, k, v, lw)]
    xs = [part.local(t).float().unflatten(-1, (h, hs)) for t in ins]
    u = part.local(part.act(u, None, None)).float()
    bsz = xs[0].shape[0]
    chunk = min(cfg.ssm_scan_chunk, s_len)
    s0 = torch.zeros((bsz, h, hs, hs), dtype=torch.float32, device=u.device)
    s_final, ys = block_scan(functools.partial(_wkv_blocks, u), s0, xs, chunk,
                             (0.0,) * 4, 4 * bsz * d * (chunk + 1) ** 2)
    return (part.like(ys.flatten(2), ins[0]),
            part.like(s_final, ins[0], dims=(0, None, None, None)))


def rwkv_tm_apply_seq(params: Params, x: torch.Tensor, cfg,
                      return_state: bool = False):
    """x ``(B, S, d)`` → y (and with ``return_state`` ``{"s", "shift"}``:
    the WKV state after the last position and that position's x in
    ``cache_dtype``)."""
    hs = cfg.rwkv_head_size
    r, k, v, g, lw = _rwkv_tm_inputs(params, x, _shifted(x))
    y, s_final = _wkv_seq(r, k, v, lw, params["u"], cfg)
    out = _rwkv_out(params, y.unflatten(-1, (x.shape[-1] // hs, hs)), g)
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
    r, k, v, g, lw = _rwkv_tm_inputs(params, x, x_prev)
    u = params["u"].float()
    s, y = _rwkv_step(h, hs, u, cache["s"], r[:, 0], k[:, 0], v[:, 0],
                      torch.exp(lw[:, 0]))
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
    xk = part.act(x + mu[0] * (x_prev - x), "batch", "seq", "embed")
    xr = part.act(x + mu[1] * (x_prev - x), "batch", "seq_sp", "embed")
    k = torch.square(F.relu(linear_apply(params["wk"], xk)))
    k = part.act(k, "batch", "seq", "mlp")
    kv = linear_apply(params["wv"], k)
    # wr is whole on every rank: each rank's rows, then whole sequences
    # for the gate, so wv's gradient meets whole sequences too (a
    # sequence-sharded one sends DTensor's matmul strategy search through
    # strided shards; no-ops without rules)
    r = part.like(linear_apply(part.whole(params["wr"]), part.local(xr)), xr)
    return torch.sigmoid(part.act(r, "batch", "seq", "embed")) * kv


def rwkv_cm_apply_seq(params: Params, x: torch.Tensor) -> torch.Tensor:
    return rwkv_cm_apply(params, x, _shifted(x))


def rwkv_cm_apply_step(params: Params, x: torch.Tensor, shift: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, 1, d)``, ``shift`` the previous token's x ``(B, d)`` → (y,
    the new shift in ``shift``'s dtype)."""
    y = rwkv_cm_apply(params, x, shift.to(x.dtype)[:, None, :])
    return y, x[:, 0].to(shift.dtype)
