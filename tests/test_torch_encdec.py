"""Port vs reference, the encdec family (whisper-large-v3's SMOKE config,
fp32, 32 frames): ``layernorm``, ``sinusoidal_positions``,
``gelu_mlp_apply``, ``cross_kv`` and ``cross_attention_apply`` (one query
row and several), ``encode``, ``decode_train``, ``prefill`` (logits and
cross K/V) and a run of ragged ``decode_step`` calls, dense and BCR-packed
(keep 0.25, 16 x 16 blocks, through the reference's ``pack_params``); the
loss and the gradient of every leaf; one ``make_train_step`` with the
ADMM penalty. At whisper's 1500 frames on the SMOKE widths: ``encode``
(``attn_impl="dense"``) and ``decode_step`` against the reference's, and
``cross_attention_apply`` against the reference's own parts where the
reference asserts; inside the port, stepwise ``decode_step`` against
``decode_train``. Then what packing fuses, ``model_fns``, and the entry
points that refuse the family.

Inputs come from a numpy seed; parameters are the reference's, converted by
``convert.from_jax_params``. The reference runs its BCR kernels as Pallas in
interpret mode.

Tolerance: ``1e-4 x max(1, max |reference|)`` on activations, logits and
cache leaves (fp32; XLA and PyTorch sum in different orders); a gradient
within 1e-4 of its leaf's largest entry.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.core import admm as jadmm  # noqa: E402
from repro.core.sparse_linear import linear_apply as jlinear  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import (from_jax_params,  # noqa: E402
                                 from_jax_train_state)
from repro_torch.core import admm as tadmm  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.serve import generate, pack_params  # noqa: E402
from repro_torch.models import causal_lm  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

torch.set_num_threads(2)
ARCH = "whisper-large-v3"
B, S_DEC, STEPS, CAP = 2, 6, 4, 16
LONG = 1500                  # whisper's 30-second window of frames


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def _cfgs(**over):
    return (dataclasses.replace(jcfgs.get_smoke_config(ARCH),
                                kernel_impl="interpret", **over),
            dataclasses.replace(tcfgs.get_smoke_config(ARCH), **over))


_MODELS = {}


def _model(variant, **over):
    """(jcfg, reference params, tcfg, converted params) of the SMOKE
    config, dense or packed at keep 0.25 (16 x 16 blocks)."""
    key = (variant, tuple(sorted(over.items())))
    if key not in _MODELS:
        keep = 0.0 if variant == "dense" else 0.25
        jcfg, tcfg = _cfgs(bcr_block=(16, 16), cache_dtype="float32",
                           bcr_keep_frac=keep, **over)
        jp = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
        if keep:
            jp = jpack_params(jcfg, jp)
        tp = from_jax_params(_np_tree(jp), tcfg, device="cpu")
        _MODELS[key] = (jcfg, jp, tcfg, tp)
    return _MODELS[key]


def _inputs(cfg, frames=None, seed=0):
    rng = np.random.default_rng(seed)
    fr = rng.normal(size=(B, frames or cfg.encoder_seq,
                          cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S_DEC)).astype(np.int32)
    return fr, toks


# the key projection's bias: softmax ignores a shift shared by every key,
# so its gradient is zero in exact arithmetic and fp32 rounding noise in
# both packages (AdamW's normalized step turns that noise into updates of
# up to ~lr a step, of either sign)
KEY_BIAS = "['wk']['b']"


def _layer(tree, i):
    """Layer ``i`` of the reference's scanned stack."""
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layernorm_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    want = jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), 1e-5)
    got = tlayers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), 1e-5)
    _close(got, want, "layernorm")
    init = tlayers.layernorm_init(64, torch.float32, "cpu")
    jinit = jlayers.layernorm_init(64)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit[k]))


@pytest.mark.parametrize("seq,dim", [(32, 64), (LONG, 64), (LONG, 1280),
                                     (7, 2), (9, 6)])
def test_sinusoidal_positions_match_reference(seq, dim):
    """XLA's float32 ``exp`` and torch's differ by one ulp (2^-24 at a
    frequency near 1) on some frequencies; the angle ``pos · f`` multiplies
    that by the position, so the table is held to 1e-4 plus ``seq`` ulps of
    1 (1500 positions: 1.9e-4; measured 1.2e-4)."""
    got = tlayers.sinusoidal_positions(seq, dim)
    want = np.asarray(jlayers.sinusoidal_positions(seq, dim))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 + seq * 2.0 ** -24,
                               err_msg=f"sinusoidal_positions({seq}, {dim})")
    assert float(got[0, 0]) == 0.0 and float(got[0, -1]) == 1.0


def test_gelu_mlp_matches_reference():
    rng = np.random.default_rng(2)
    p = {"wi": {"w": rng.normal(size=(128, 64)).astype(np.float32) * 0.1,
                "b": rng.normal(size=128).astype(np.float32)},
         "wo": {"w": rng.normal(size=(64, 128)).astype(np.float32) * 0.1,
                "b": rng.normal(size=64).astype(np.float32)}}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    want = jlayers.gelu_mlp_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                  jnp.asarray(x))
    got = tlayers.gelu_mlp_apply(
        {k: {n: torch.from_numpy(a) for n, a in v.items()}
         for k, v in p.items()}, torch.from_numpy(x))
    _close(got, want, "gelu_mlp_apply")
    init = tlayers.gelu_mlp_init(torch.Generator().manual_seed(0), 64, 128)
    assert {k: sorted(v) for k, v in init.items()} == {
        "wi": ["b", "w"], "wo": ["b", "w"]}


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("variant", ["dense", "packed"])
def test_cross_kv_and_cross_attention_match_reference(variant, s):
    """Layer 0's cross attention: the encoder K/V (a fused ``wkv`` group
    when packed) and the attention of ``s`` decoder rows over them."""
    jcfg, jp, tcfg, tp = _model(variant)
    jl, tl = _layer(jp["dec_stack"]["cross_attn"], 0), \
        tp["dec_layers"][0]["cross_attn"]
    assert ("wkv" in tl) == (variant == "packed") and "wq" in tl
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(B, tcfg.encoder_seq, 64)).astype(np.float32)
    x = rng.normal(size=(B, s, 64)).astype(np.float32)
    kw = dict(n_kv=tcfg.num_kv_heads, head_dim=tcfg.head_dim)
    jkv = jlayers.cross_kv(jl, jnp.asarray(enc), impl=jcfg.kernel_impl, **kw)
    with torch.no_grad():
        tkv = tlayers.cross_kv(tl, torch.from_numpy(enc), **kw)
        got = tlayers.cross_attention_apply(
            tl, torch.from_numpy(x), tkv, n_heads=tcfg.num_heads, **kw)
    for k in ("k", "v"):
        _close(tkv[k], jkv[k], f"cross_kv {k}")
    want = jlayers.cross_attention_apply(
        jl, jnp.asarray(x), jkv, n_heads=jcfg.num_heads,
        impl=jcfg.kernel_impl, **kw)
    _close(got, want, f"cross_attention_apply S={s}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["dense", "packed"])
def test_encode_decode_train_prefill_match_reference(variant):
    jcfg, jp, tcfg, tp = _model(variant)
    fr, toks = _inputs(tcfg)
    jenc = jed.encode(jcfg, jp, jnp.asarray(fr))
    jlog = jed.decode_train(jcfg, jp, jnp.asarray(toks), jenc)
    jpl, jpc = jed.prefill(jcfg, jp, jnp.asarray(fr), jnp.asarray(toks))
    with torch.no_grad():
        tenc = ted.encode(tcfg, tp, torch.from_numpy(fr))
        tlog = ted.decode_train(tcfg, tp, torch.from_numpy(toks), tenc)
        tpl, tpc = ted.prefill(tcfg, tp, torch.from_numpy(fr),
                               torch.from_numpy(toks))
    _close(tenc, jenc, "encode")
    _close(tlog, jlog, "decode_train")
    _close(tpl, jpl, "prefill logits")
    assert set(tpc) == set(jpc) == {"cross_k", "cross_v"}
    for k in tpc:
        assert tuple(tpc[k].shape) == jpc[k].shape == (
            tcfg.num_layers, B, tcfg.encoder_seq, tcfg.num_kv_heads,
            tcfg.head_dim)
        _close(tpc[k], jpc[k], f"prefill {k}")


def _seated(cache, cross):
    """A fresh decode cache holding the prefill's cross K/V (both fp32)."""
    return dict(cache, cross_k=cross["cross_k"], cross_v=cross["cross_v"])


def _decode_run(jcfg, jp, tcfg, tp, fr, toks, lens0, what):
    """Prefill, seat the cross K/V into a fresh cache, then STEPS ragged
    teacher-forced ``decode_step`` calls (slot b at ``lens0[b] + i``) on
    both packages: each step's logits and the final self K/V."""
    jfns, tfns = jmodel_fns(jcfg), model_fns(tcfg)
    _, jcross = jfns.prefill(jp, {"frames": jnp.asarray(fr),
                                  "tokens": jnp.asarray(toks)})
    with torch.no_grad():
        _, tcross = tfns.prefill(tp, {"frames": torch.from_numpy(fr),
                                      "tokens": torch.from_numpy(toks)})
    jcache = _seated(jfns.init_cache(B, CAP), jcross)
    tcache = _seated(tfns.init_cache(B, CAP, device="cpu"), tcross)
    lens0 = np.asarray(lens0, np.int32)
    for i in range(STEPS):
        feed = toks[:, i:i + 1]
        jl, jcache = jfns.decode_step(jp, {
            "tokens": jnp.asarray(feed),
            "cache_len": jnp.asarray(lens0 + i)}, jcache)
        with torch.no_grad():
            tl, tcache = tfns.decode_step(tp, {
                "tokens": torch.from_numpy(feed),
                "cache_len": torch.from_numpy(lens0 + i)}, tcache)
        _close(tl, jl, f"{what} decode step {i}")
    for k in ("self_k", "self_v"):
        _close(tcache[k], jcache[k], f"{what} {k}")


@pytest.mark.parametrize("variant", ["dense", "packed"])
def test_decode_steps_match_reference(variant):
    jcfg, jp, tcfg, tp = _model(variant)
    fr, toks = _inputs(tcfg, seed=4)
    _decode_run(jcfg, jp, tcfg, tp, fr, toks, [0, 3], variant)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(remat):
    jcfg, jp, tcfg, tp = _model("dense", remat=remat)
    tp = from_jax_params(_np_tree(jp), tcfg, device="cpu")
    for leaf in leaves(tp):
        leaf.requires_grad_(True)
    fr, toks = _inputs(tcfg, seed=5)
    targets = np.roll(toks, -1, axis=1)
    mask = np.ones(toks.shape, np.float32)
    mask[1, -2:] = 0
    batch = {"frames": fr, "tokens": toks, "targets": targets, "mask": mask}
    want, jgrads = jax.value_and_grad(lambda p: jed.loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    loss = ted.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    want_g = from_jax_params(_np_tree(jgrads), tcfg, device="cpu")
    assert len(leaves(want_g)) == len(leaves(tp))
    top = max(float(g.abs().max()) for g in leaves(want_g))
    for (path, p), g in zip(flatten(tp), leaves(want_g)):
        if path.endswith(KEY_BIAS):
            assert max(float(p.grad.abs().max()),
                       float(g.abs().max())) <= 1e-6 * top, path
            continue
        gs = max(float(g.abs().max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * gs, err_msg=path)


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_with_admm_matches_reference(accum):
    """Two steps of ``make_train_step`` in the ADMM phase (keep 0.25, 16 x
    16 blocks) on an encdec batch (``frames``, ``tokens``, ``targets``)
    from converted state: loss each step, then every param; AdamW decays
    the leaves of rank >= 2 in the reference's scanned layout."""
    jcfg, tcfg = _cfgs(bcr_keep_frac=0.25, bcr_block=(16, 16),
                       grad_accum=accum)
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=6)
    jp = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    jspecs = jadmm.specs_for(jp, jtrain.default_prune_filter(jcfg))
    jstate = jtrain.TrainState(jp, jadamw.init(jp),
                               jadmm.admm_init(jp, jspecs), None)
    tstate = from_jax_train_state(_np_tree(jstate), tcfg, device="cpu")
    tspecs = tadmm.specs_for(tstate.params, ttrain.default_prune_filter(tcfg))
    # 6 per encoder layer, 10 per decoder layer, lm_head (the reference
    # counts a stacked leaf once)
    assert (len(tspecs), len(jspecs)) == (6 * 2 + 10 * 2 + 1, 6 + 10 + 1)
    admm_cfg = dict(steps_per_admm=5)
    jstep = jax.jit(jtrain.make_train_step(
        jcfg, jadamw.AdamWConfig(**opt), jadmm.ADMMConfig(**admm_cfg),
        jspecs))
    tstep = ttrain.make_train_step(
        tcfg, tadamw.AdamWConfig(**opt), tadmm.ADMMConfig(**admm_cfg),
        tspecs)
    rng = np.random.default_rng(6)
    for step in range(2):
        toks = rng.integers(0, tcfg.vocab_size, size=(4, 8)).astype(np.int32)
        b = {"frames": rng.normal(size=(4, tcfg.encoder_seq, tcfg.d_model))
             .astype(np.float32),
             "tokens": toks, "targets": np.roll(toks, -1, axis=1)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
    want = from_jax_params(_np_tree(jstate.params), tcfg, device="cpu")
    for (path, g), w in zip(flatten(tstate.params), leaves(want)):
        if path.endswith(KEY_BIAS):     # zero at init, moved by noise only
            bound = 2 * opt["lr"]
            assert max(float(g.detach().abs().max()),
                       float(w.abs().max())) <= bound
            continue
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=0,
                                   atol=5e-5, err_msg=path)


def test_decay_mask_decays_the_encdec_stacks():
    """The reference scans ``enc_stack``/``dec_stack`` whatever
    ``scan_layers`` says, so their norms and biases are decayed; the
    unstacked norms and ``dec_pos`` follow their own rank."""
    _, _, tcfg, tp = _model("dense")
    for scan in (True, False):
        fns = model_fns(dataclasses.replace(tcfg, scan_layers=scan))
        mask = dict(flatten(tadamw.decay_mask(tp, stacked=fns.stacked)))
        assert mask["['enc_layers'][0]['norm1']['bias']"] == 1.0
        assert mask["['dec_layers'][1]['self_attn']['wq']['b']"] == 1.0
        assert mask["['enc_norm']['scale']"] == 0.0
        assert mask["['dec_pos']"] == 1.0


# ---------------------------------------------------------------------------
# whisper's 1500 frames, on the SMOKE widths
# ---------------------------------------------------------------------------


def test_encode_and_decode_step_at_1500_frames_match_reference():
    jcfg, jp, tcfg, tp = _model("dense", encoder_seq=LONG)
    fr, toks = _inputs(tcfg, seed=7)
    jenc = jed.encode(jcfg, jp, jnp.asarray(fr[:1]))
    with torch.no_grad():
        tenc = ted.encode(tcfg, tp, torch.from_numpy(fr[:1]))
    _close(tenc, jenc, "encode at 1500 frames")
    # decode_step over a 1500-row cross cache (one query row: plain
    # decode attention in both packages), the cross K/V from cross_kv
    jfns, tfns = jmodel_fns(jcfg), model_fns(tcfg)
    jcross = jax.vmap(lambda lp: jlayers.cross_kv(
        lp["cross_attn"], jenc, n_kv=4, head_dim=16))(jp["dec_stack"])
    jcache = dict(jfns.init_cache(1, CAP), cross_k=jcross["k"],
                  cross_v=jcross["v"])
    with torch.no_grad():
        tcross = [tlayers.cross_kv(lp["cross_attn"], tenc, n_kv=4,
                                   head_dim=16) for lp in tp["dec_layers"]]
    tcache = dict(tfns.init_cache(1, CAP, device="cpu"),
                  cross_k=torch.stack([c["k"] for c in tcross]),
                  cross_v=torch.stack([c["v"] for c in tcross]))
    for i in range(STEPS):
        feed = toks[:1, i:i + 1]
        jl, jcache = jfns.decode_step(jp, {"tokens": jnp.asarray(feed),
                                           "cache_len": jnp.asarray([i])},
                                      jcache)
        with torch.no_grad():
            tl, tcache = tfns.decode_step(tp, {
                "tokens": torch.from_numpy(feed),
                "cache_len": torch.tensor([i])}, tcache)
        _close(tl, jl, f"decode step {i} at 1500 frames")


def test_prefill_at_1500_frames_where_the_reference_asserts():
    """The reference's ``prefill`` and ``loss_fn`` cannot take whisper's
    1500 frames: ``cross_attention_apply`` with more than one query row
    calls the XLA ``flash_attention`` at its default ``kv_chunk`` 1024,
    which asserts ``1500 % 1024 == 0``. The port computes what it means:
    its cross attention agrees with the reference's own parts
    (``linear_apply`` → ``dense_attention(causal=False)`` →
    ``linear_apply``), and its ``prefill`` logits with the last row of its
    ``decode_train``, which stepwise ``decode_step`` calls reproduce."""
    jcfg, jp, tcfg, tp = _model("dense", encoder_seq=LONG)
    fr, toks = _inputs(tcfg, seed=8)
    with pytest.raises(AssertionError):
        jed.prefill(jcfg, jp, jnp.asarray(fr), jnp.asarray(toks))
    # cross attention of S_DEC rows over 1500 encoder rows
    rng = np.random.default_rng(9)
    enc = rng.normal(size=(B, LONG, 64)).astype(np.float32)
    x = rng.normal(size=(B, S_DEC, 64)).astype(np.float32)
    jl = _layer(jp["dec_stack"]["cross_attn"], 1)
    jkv = jlayers.cross_kv(jl, jnp.asarray(enc), n_kv=4, head_dim=16)
    q = jlinear(jl["wq"], jnp.asarray(x)).reshape(B, S_DEC, 4, 16)
    o = jlayers.dense_attention(q, jkv["k"], jkv["v"], causal=False)
    want = jlinear(jl["wo"], o.reshape(B, S_DEC, 64))
    tl = tp["dec_layers"][1]["cross_attn"]
    with torch.no_grad():
        tkv = tlayers.cross_kv(tl, torch.from_numpy(enc), n_kv=4,
                               head_dim=16)
        got = tlayers.cross_attention_apply(tl, torch.from_numpy(x), tkv,
                                            n_heads=4, n_kv=4, head_dim=16)
    _close(got, want, "cross attention over 1500 rows")
    # inside the port: prefill, decode_train and stepwise decode agree
    fns = model_fns(tcfg)
    with torch.no_grad():
        logits, cross = fns.prefill(tp, {"frames": torch.from_numpy(fr),
                                         "tokens": torch.from_numpy(toks)})
        enc_out = ted.encode(tcfg, tp, torch.from_numpy(fr))
        full = ted.decode_train(tcfg, tp, torch.from_numpy(toks), enc_out)
        _close(logits, full[:, -1:].numpy(), "prefill vs decode_train")
        cache = dict(fns.init_cache(B, CAP, device="cpu"), **cross)
        for i in range(S_DEC):
            step, cache = fns.decode_step(tp, {
                "tokens": torch.from_numpy(toks[:, i:i + 1]),
                "cache_len": torch.full((B,), i, dtype=torch.int32)}, cache)
            _close(step, full[:, i:i + 1].numpy(),
                   f"decode_step {i} vs decode_train")


# ---------------------------------------------------------------------------
# packing, model_fns, refusals
# ---------------------------------------------------------------------------


def test_pack_params_fuses_cross_kv_but_never_cross_q():
    """The port's ``pack_params`` of the converted dense SMOKE tree against
    the reference's (``plan_params`` included): the same keys — self
    ``wqkv`` with its ``(3, N)`` bias, cross ``wq`` alone beside a fused
    ``wkv`` with a ``(2, N)`` bias, MLP ``wi``/``wo`` — and the same tiles
    and index planes, layer by layer; embeddings and ``dec_pos`` dense."""
    jcfg, jp, tcfg, tp = _model("dense")
    pc = dataclasses.replace(jcfg, bcr_keep_frac=0.25)
    tpc = dataclasses.replace(tcfg, bcr_keep_frac=0.25)
    want = from_jax_params(_np_tree(jpack_params(pc, jp)), tpc, device="cpu")
    got = pack_params(tpc, tp)
    for i, layer in enumerate(got["dec_layers"]):
        assert sorted(layer["self_attn"]) == ["wo", "wqkv"]
        assert sorted(layer["cross_attn"]) == ["wkv", "wo", "wq"]
        assert tuple(layer["cross_attn"]["wkv"]["b"].shape) == (2, 64)
        assert tuple(layer["self_attn"]["wqkv"]["b"].shape) == (3, 64)
        assert "w_packed" in layer["cross_attn"]["wq"]
        assert sorted(layer["mlp"]) == ["wi", "wo"]
        assert sorted(want["dec_layers"][i]["cross_attn"]) == [
            "wkv", "wo", "wq"]
    for layer in got["enc_layers"]:
        assert sorted(layer["attn"]) == ["wo", "wqkv"]
    assert "w_packed" in got["lm_head"]
    assert set(got["dec_embed"]) == {"table"}
    gf, wf = dict(flatten(got)), dict(flatten(want))
    assert set(gf) >= {p for p in wf if "gather_planes" not in p
                       and "scatter_planes" not in p}
    for path, g in gf.items():
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), wf[path].numpy(),
                                          err_msg=path)


def test_model_fns_serves_encdec_and_causal_lm_refuses_it():
    _, _, tcfg, tp = _model("dense")
    fns = model_fns(tcfg)
    assert fns.prefill_append is None
    fr, toks = _inputs(tcfg, seed=10)
    with torch.no_grad():
        logits, cross = fns.prefill(tp, {"frames": torch.from_numpy(fr),
                                         "tokens": torch.from_numpy(toks)})
        cache = fns.init_cache(B, CAP, device="cpu")
        assert all(cache[k].dtype == tcfg.c_dtype for k in cache)
        cache.update(cross)
        step, cache2 = fns.decode_step(tp, {
            "tokens": torch.from_numpy(toks[:, :1]),
            "cache_len": torch.zeros((B,), dtype=torch.int32)}, cache)
    assert tuple(logits.shape) == tuple(step.shape) == (B, 1, 512)
    assert cache2 is cache and bool(torch.isfinite(step).all())
    p = fns.init_params(0, device="cpu")
    assert len(p["enc_layers"]) == len(p["dec_layers"]) == 2
    assert tuple(p["dec_pos"].shape) == (ted.MAX_DEC_POS, 64)
    assert "b" in p["enc_layers"][0]["attn"]["wq"]
    with pytest.raises(NotImplementedError):
        causal_lm.init_params(tcfg, device="cpu")


def test_engine_generate_and_http_cli_refuse_encdec():
    """The reference's engine and ``generate`` serve decoder-only families;
    so do the port's, and the HTTP CLI refuses through the engine."""
    from repro_torch.launch import api
    _, _, tcfg, tp = _model("dense")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        InferenceEngine(tcfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        generate(tcfg, tp, torch.zeros((1, 4), dtype=torch.int32),
                 gen_tokens=2)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        api.build_server(api.parse_args(["--arch", ARCH, "--smoke",
                                         "--device", "cpu"]))
