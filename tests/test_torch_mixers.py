"""Port vs reference, the recurrent mixers: ``models/mixers.py`` (RWKV6
time-mix and channel-mix, the mamba selective SSM), sequence and step
forms, and ``chunked_checkpoint_scan``.

Inputs come from a numpy seed; parameters are the reference's SMOKE
models' layers (rwkv6-3b, jamba-v0.1-52b; fp32), converted by
``convert.from_jax_params``, dense and BCR-packed (keep 0.25, 16 x 16
blocks; the reference runs its BCR kernel in Pallas interpret mode).

Tolerance: ``atol = rtol = 1e-5`` on outputs and states (fp32; XLA and
PyTorch sum in different orders).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mixers as jmix  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mixers as tmix  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B = 2

_MODELS = {}


def _model(arch, variant):
    """(jcfg, the reference's first-layer params of each kind, tcfg, the
    port's) for a SMOKE config, dense or packed at keep 0.25."""
    key = (arch, variant)
    if key not in _MODELS:
        keep = 0.0 if variant == "dense" else 0.25
        over = dict(bcr_block=(16, 16), cache_dtype="float32",
                    bcr_keep_frac=keep)
        jcfg = dataclasses.replace(jcfgs.get_smoke_config(arch),
                                   kernel_impl="interpret", **over)
        tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch), **over)
        jp = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
        if keep:
            jp = jpack_params(jcfg, jp)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
        # the first scanned repeat of each layer of the pattern, in order
        jlayers_ = [jax.tree_util.tree_map(lambda a: a[0], lp)
                    for lp in jp["stack"]]
        _MODELS[key] = (jcfg, jlayers_, tcfg, tp["layers"])
    return _MODELS[key]


def _x(cfg, s, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


# ---------------------------------------------------------------------------
# chunked_checkpoint_scan
# ---------------------------------------------------------------------------


def _scan_body_jax(c, inp):
    a, b = inp
    c = 0.9 * c + a * b
    return c, jnp.tanh(c) + b


def _scan_body_torch(c, inp):
    a, b = inp
    c = 0.9 * c + a * b
    return c, torch.tanh(c) + b


@pytest.mark.parametrize("chunk", [1, 8, 24])
def test_chunked_checkpoint_scan_matches_reference(chunk):
    """The same recurrence over 24 steps at chunk 1, 8 and the whole
    length: final carry and stacked outputs equal the reference's."""
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(24, 3, 5)).astype(np.float32) for _ in range(2))
    c0 = rng.normal(size=(3, 5)).astype(np.float32)
    jc, jys = jlayers.chunked_checkpoint_scan(
        _scan_body_jax, jnp.asarray(c0), (jnp.asarray(a), jnp.asarray(b)),
        chunk)
    tc, tys = tlayers.chunked_checkpoint_scan(
        _scan_body_torch, torch.as_tensor(c0),
        (torch.as_tensor(a), torch.as_tensor(b)), chunk)
    _close(tc, jc, "carry")
    _close(tys, jys, "outputs")


def test_chunked_checkpoint_scan_gradient_matches_plain_loop():
    """Under a gradient each chunk is checkpointed: the gradients equal
    those of the unchunked loop, and a chunk that does not divide the time
    axis raises, as the reference asserts."""
    rng = np.random.default_rng(2)
    a0, b0 = (rng.normal(size=(16, 2, 4)).astype(np.float32)
              for _ in range(2))
    grads = []
    for chunk in (16, 4):
        a = torch.tensor(a0, requires_grad=True)
        b = torch.tensor(b0, requires_grad=True)
        c, ys = tlayers.chunked_checkpoint_scan(
            _scan_body_torch, torch.zeros(2, 4), (a, b), chunk)
        (c.sum() + ys.square().sum()).backward()
        grads.append((a.grad.clone(), b.grad.clone()))
    for g1, g2 in zip(*grads):
        torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tlayers.chunked_checkpoint_scan(
            _scan_body_torch, torch.zeros(2, 4),
            (torch.as_tensor(a0), torch.as_tensor(b0)), 5)


@pytest.mark.parametrize("s,want", [(5, 5), (16, 8), (12, 1), (64, 8)])
def test_scan_chunk_rule(s, want):
    """``min(ssm_scan_chunk, S)``, falling back to 1 when it does not
    divide S (SMOKE ``ssm_scan_chunk`` 8)."""
    cfg = tcfgs.get_smoke_config("rwkv6-3b")
    assert tmix.scan_chunk(cfg, s) == want


# ---------------------------------------------------------------------------
# RWKV6 time-mix and channel-mix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["dense", "packed"])
@pytest.mark.parametrize("s", [16, 12])
def test_rwkv_time_mix_seq_matches_reference(variant, s):
    """The sequence form with its returned state (WKV ``s`` and the last
    token's ``shift``), at S = 16 (chunk 8) and 12 (the chunk-1
    fallback)."""
    jcfg, jl, tcfg, tl = _model("rwkv6-3b", variant)
    x = _x(tcfg, s)
    jy, js = jmix.rwkv_tm_apply_seq(jl[0]["mixer"], jnp.asarray(x), jcfg,
                                    impl=jcfg.kernel_impl, return_state=True)
    ty, ts = tmix.rwkv_tm_apply_seq(tl[0]["mixer"], torch.as_tensor(x),
                                    tcfg, return_state=True)
    _close(ty, jy, "y")
    for key in ("s", "shift"):
        _close(ts[key], js[key], key)


@pytest.mark.parametrize("variant", ["dense", "packed"])
def test_rwkv_time_mix_step_matches_reference(variant):
    """Three steps from a carried state (the sequence form's, after 12
    tokens), each step's output and state against the reference's."""
    jcfg, jl, tcfg, tl = _model("rwkv6-3b", variant)
    x = _x(tcfg, 15)
    _, jc = jmix.rwkv_tm_apply_seq(jl[0]["mixer"], jnp.asarray(x[:, :12]),
                                   jcfg, impl=jcfg.kernel_impl,
                                   return_state=True)
    _, tc = tmix.rwkv_tm_apply_seq(tl[0]["mixer"],
                                   torch.as_tensor(x[:, :12]), tcfg,
                                   return_state=True)
    for t in range(12, 15):
        jy, jc = jmix.rwkv_tm_apply_step(jl[0]["mixer"],
                                         jnp.asarray(x[:, t:t + 1]), jc,
                                         jcfg, impl=jcfg.kernel_impl)
        ty, tc = tmix.rwkv_tm_apply_step(tl[0]["mixer"],
                                         torch.as_tensor(x[:, t:t + 1]), tc,
                                         tcfg)
        _close(ty, jy, f"y at {t}")
        for key in ("s", "shift"):
            _close(tc[key], jc[key], f"{key} at {t}")


@pytest.mark.parametrize("variant", ["dense", "packed"])
def test_rwkv_channel_mix_matches_reference(variant):
    """The channel-mix over a sequence, then one step from the previous
    token's shift."""
    jcfg, jl, tcfg, tl = _model("rwkv6-3b", variant)
    x = _x(tcfg, 9, seed=3)
    jp, tp = jl[0]["ffn"], tl[0]["ffn"]
    _close(tmix.rwkv_cm_apply_seq(tp, torch.as_tensor(x)),
           jmix.rwkv_cm_apply_seq(jp, jnp.asarray(x), jcfg,
                                  impl=jcfg.kernel_impl), "seq")
    shift = x[:, 7]
    jy, jc = jmix.rwkv_cm_apply_step(jp, jnp.asarray(x[:, 8:9]),
                                     {"shift": jnp.asarray(shift)}, jcfg,
                                     impl=jcfg.kernel_impl)
    ty, tshift = tmix.rwkv_cm_apply_step(tp, torch.as_tensor(x[:, 8:9]),
                                         torch.as_tensor(shift))
    _close(ty, jy, "step y")
    _close(tshift, jc["shift"], "step shift")


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def _mamba_layer(variant):
    """jamba's first layer (a mamba mixer, dense FFN) in both packages."""
    jcfg, jl, tcfg, tl = _model("jamba-v0.1-52b", variant)
    assert "A_log" in tl[0]["mixer"]
    return jcfg, jl[0]["mixer"], tcfg, tl[0]["mixer"]


@pytest.mark.parametrize("variant", ["dense", "packed"])
@pytest.mark.parametrize("s", [16, 12, 3])
def test_mamba_seq_matches_reference(variant, s):
    """The sequence form and its state (``h`` fp32, the conv tail) at S =
    16 (chunk 8), 12 (chunk 1) and 3 (shorter than the conv width + 1)."""
    jcfg, jp, tcfg, tp = _mamba_layer(variant)
    x = _x(tcfg, s, seed=4)
    jy, js = jmix.mamba_apply_seq(jp, jnp.asarray(x), jcfg,
                                  impl=jcfg.kernel_impl, return_state=True)
    ty, ts = tmix.mamba_apply_seq(tp, torch.as_tensor(x), tcfg,
                                  return_state=True)
    _close(ty, jy, "y")
    for key in ("h", "conv"):
        _close(ts[key], js[key], key)
    assert ts["h"].dtype == torch.float32


@pytest.mark.parametrize("variant", ["dense", "packed"])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba_step_matches_reference(variant, carried):
    """Four steps, from a zero state or from the state the sequence form
    left after 10 tokens (``h`` and the ``conv`` tail carried)."""
    jcfg, jp, tcfg, tp = _mamba_layer(variant)
    x = _x(tcfg, 14, seed=5)
    if carried:
        _, jc = jmix.mamba_apply_seq(jp, jnp.asarray(x[:, :10]), jcfg,
                                     impl=jcfg.kernel_impl, return_state=True)
        _, tc = tmix.mamba_apply_seq(tp, torch.as_tensor(x[:, :10]), tcfg,
                                     return_state=True)
    else:
        jc = jmix.mamba_init_cache(jcfg, B, jnp.float32)
        tc = tmix.mamba_init_cache(tcfg, B, torch.float32, "cpu")
    for t in range(10, 14):
        jy, jc = jmix.mamba_apply_step(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                       jcfg, impl=jcfg.kernel_impl)
        ty, tc = tmix.mamba_apply_step(tp, torch.as_tensor(x[:, t:t + 1]),
                                       tc, tcfg)
        _close(ty, jy, f"y at {t}")
        for key in ("h", "conv"):
            _close(tc[key], jc[key], f"{key} at {t}")


def test_mamba_steps_equal_the_sequence_form():
    """Inside the port: stepping token by token from a zero state gives the
    sequence form's outputs and final state."""
    _, _, tcfg, tp = _mamba_layer("dense")
    x = torch.as_tensor(_x(tcfg, 8, seed=6))
    y_seq, st = tmix.mamba_apply_seq(tp, x, tcfg, return_state=True)
    c = tmix.mamba_init_cache(tcfg, B, torch.float32, "cpu")
    ys = []
    for t in range(8):
        y, c = tmix.mamba_apply_step(tp, x[:, t:t + 1], c, tcfg)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_seq, **TOL)
    for key in ("h", "conv"):
        torch.testing.assert_close(c[key], st[key], **TOL)


def _flat(tree, path=""):
    """{"/in_proj/w": leaf, ...} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: np.asarray(tree)}


def test_mixer_init_shapes_match_reference():
    """The port's random init builds the reference's leaves, shapes and
    constants (``A_log``, ``D``, ``w0``, ``u``, ``ln_scale``,
    ``conv_b``; fp32 within 1e-6)."""
    inits = {"mamba": (jmix.mamba_init, tmix.mamba_init),
             "rwkv": (jmix.rwkv_tm_init, tmix.rwkv_tm_init),
             "rwkv_cm": (jmix.rwkv_cm_init, tmix.rwkv_cm_init)}
    for arch, kinds in (("jamba-v0.1-52b", ("mamba",)),
                        ("rwkv6-3b", ("rwkv", "rwkv_cm"))):
        jcfg = jcfgs.get_smoke_config(arch)
        tcfg = tcfgs.get_smoke_config(arch)
        gen = torch.Generator().manual_seed(0)
        for kind in kinds:
            jinit, tinit = inits[kind]
            jp = _flat(jinit(jax.random.PRNGKey(0), jcfg))
            tp = _flat(tinit(gen, tcfg))
            assert sorted(jp) == sorted(tp), kind
            for name, v in jp.items():
                assert tp[name].shape == v.shape, (kind, name)
                if name.split("/")[-1] in ("A_log", "D", "w0", "u",
                                           "ln_scale", "conv_b"):
                    # log() may round the last bit differently
                    np.testing.assert_allclose(tp[name], v, rtol=1e-6)
