"""Port vs reference, training of the families that also serve: the MoE
family (deepseek-moe-16b with shared experts and a first dense layer;
llama4-maverick with ``moe_every`` 2), the vlm (pixtral-12b, with
``image_embeds`` in the loss), the ssm (rwkv6-3b) and the hybrid
(jamba-v0.1-52b: mamba, attention and experts). SMOKE configs, fp32, BCR
keep 0.25 on 16 x 16 blocks, on the CPU:

* the prune specs (``default_prune_filter`` through ``specs_for``): the
  same leaves and block shapes, each of the port's per-layer paths mapped
  onto the reference's (which names a stacked leaf once for all repeats);
* the loss and the gradient of every leaf (``cfg.remat`` on, and off for
  the recurrent families);
* ADMM over stacked ``(E, N, K)`` expert leaves and the mamba and RWKV
  projections: ``admm_init``, a dual update, ``primal_residual``,
  ``finalize`` (masks equal, each expert a BCR member) and ``apply_masks``;
* ``make_train_step`` from converted state (Z/U with None on unpruned
  leaves beside the stacked experts, or the frozen masks) on the same numpy
  batches, grad accumulation 1 and 2;
* the port alone: ``train_loop`` through dense → ADMM → retrain for the
  MoE, ssm and hybrid families, and a MoE run resumed mid-ADMM repeating
  the uninterrupted losses (the reference's loop cannot resume there).

This file holds the checks and runs them on the MoE configs (the prune
specs also on the dense and encdec SMOKE trees);
``tests/test_torch_train_vlm_ssm.py`` runs them on pixtral and rwkv6,
``tests/test_torch_train_hybrid.py`` on jamba (one file a test worker,
each under ~2 minutes on two cores). Parameters are the reference's,
converted by ``convert.from_jax_params``.

Tolerances (as ``tests/test_torch_encdec.py`` and
``tests/test_torch_train.py``): loss within 1e-5 relative; a gradient
within 1e-4 of its leaf's largest entry, and a leaf whose reference
gradient is below 1e-6 of the tree's largest holds zero up to that bound
on both sides (llama4-maverick's top-1 router: its one normalised gate is
1 whatever the logits, so its gradient is zero in exact arithmetic); the
train step's loss within 1e-5 relative per step and params within 5e-5
absolute after 3 steps.

The train steps run AdamW with ``eps`` 1e-4 (the default is 1e-8). Adam's
first step maps a gradient entry g to g / (|g| + eps); with eps 1e-8 an
entry that routing leaves near zero (an expert weight few tokens reach, a
router with one expert a token) turns the fp32 summation noise of its
~1e-9 gradient, which XLA and PyTorch sum in different orders, into a step
of up to 2 x lr. eps 1e-4 keeps that map linear at the noise scale, so the
params comparison measures the step, not the noise. AdamW itself, at the
default eps, is held in ``tests/test_torch_train.py``.
"""

import dataclasses
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.core import admm as jadmm  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.models.causal_lm import stack_plan as jstack_plan  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import (from_jax_params,  # noqa: E402
                                 from_jax_train_state)
from repro_torch.core import admm as tadmm  # noqa: E402
from repro_torch.core import bcr as tbcr  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import causal_lm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

torch.set_num_threads(2)
MOE = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")
PRUNE = dict(bcr_keep_frac=0.25, bcr_block=(16, 16))
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=6, eps=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **over):
    return (dataclasses.replace(jcfgs.get_smoke_config(arch), **over),
            dataclasses.replace(tcfgs.get_smoke_config(arch), **over))


_PARAMS = {}


def _params(arch):
    """The reference's SMOKE params (seed 0) and their conversion (the
    prune settings change no init)."""
    if arch not in _PARAMS:
        jcfg, tcfg = _cfgs(arch, **PRUNE)
        jp = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, from_jax_params(_np_tree(jp), tcfg,
                                             device="cpu"))
    return _PARAMS[arch]


def _batch(tcfg, rng, b, s):
    """tokens, targets, a loss mask and (vlm) ``image_embeds``, numpy."""
    toks = rng.integers(0, tcfg.vocab_size, size=(b, s)).astype(np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if tcfg.num_image_tokens:
        out["image_embeds"] = rng.normal(
            size=(b, tcfg.num_image_tokens, tcfg.d_model)).astype(np.float32)
    return out


def _ref_path(jcfg, path: str):
    """The reference's path of the port's leaf ``path``, and how many of
    the port's leaves it stands for: decoder layer ``i`` is ``['prefix'][i]``
    among the unstacked leading layers, else the position of its layer in
    the stacked repeating pattern (once for all ``repeats``); an encdec
    layer is its stack (once for all layers)."""
    m = re.match(r"\['(layers|enc_layers|dec_layers)'\]\[(\d+)\](.*)", path)
    if not m:
        return path, 1
    key, i, rest = m[1], int(m[2]), m[3]
    if key == "enc_layers":
        return f"['enc_stack']{rest}", jcfg.encoder_layers or jcfg.num_layers
    if key == "dec_layers":
        return f"['dec_stack']{rest}", jcfg.num_layers
    sp = jstack_plan(jcfg)
    if i < len(sp.prefix):
        return f"['prefix'][{i}]{rest}", 1
    return (f"['stack'][{(i - len(sp.prefix)) % len(sp.pattern)}]{rest}",
            sp.repeats)


def _close_trees(got, want, atol, what=""):
    for (path, g), w in zip(flatten(got), leaves(want)):
        if w is None:
            assert g is None, path
            continue
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   w.detach().float().numpy(), rtol=0,
                                   atol=atol, err_msg=f"{what}{path}")


def _members(params, specs):
    """Every pruned leaf (each expert of a stacked one) is a balanced-BCR
    member."""
    flat = dict(flatten(params))
    for path, spec in specs.items():
        w = flat[path].detach()
        for mat in w.reshape(-1, *w.shape[-2:]):
            assert tbcr.is_bcr_set_member(mat, spec), path


# ---------------------------------------------------------------------------
# Prune specs
# ---------------------------------------------------------------------------


def _check_prune_specs(arch):
    """The same leaves pruned, with the same block shape, keep and
    alignment; a stacked reference leaf stands for each of the port's
    layers it stacks; expert leaves are ``(E, N, K)`` in the port."""
    jcfg, tcfg = _cfgs(arch, **PRUNE)
    jp, tp = _params(arch)
    jspecs = {jax.tree_util.keystr(k): v for k, v in jadmm.specs_for(
        jp, jtrain.default_prune_filter(jcfg)).items()}
    tspecs = tadmm.specs_for(tp, ttrain.default_prune_filter(tcfg))
    by_ref, count = {}, {}
    for path, spec in tspecs.items():
        ref, count[ref] = _ref_path(jcfg, path)
        by_ref.setdefault(ref, []).append(spec)
    assert sorted(by_ref) == sorted(jspecs)
    for ref, specs in by_ref.items():
        want = dataclasses.astuple(jspecs[ref])
        assert {dataclasses.astuple(s) for s in specs} == {want}, ref
        assert len(specs) == count[ref], ref
    flat = dict(flatten(tp))
    experts = [p for p in tspecs if "['experts']" in p]
    assert bool(experts) == bool(tcfg.num_experts)
    for path in experts:
        assert flat[path].shape[0] == tcfg.num_experts and \
            flat[path].dim() == 3, path
    mixer = {"rwkv6-3b": ("['mixer']['wr']", "['ffn']['wk']"),
             "jamba-v0.1-52b": ("['in_proj']", "['out_proj']")}
    for key in mixer.get(arch, ()):
        assert any(key in p for p in tspecs), key


# ---------------------------------------------------------------------------
# The weight-decay mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("arch", MOE + ("jamba-v0.1-52b",))
def test_decay_mask_follows_the_reference_layout(arch, scan_layers):
    """The reference decays the leaves of rank >= 2 in its own layout: a
    leaf of its scanned stack carries a repeat axis, a leaf of its
    unstacked ``prefix`` (deepseek's first dense layer) does not, nor does
    any leaf without ``scan_layers``. The port's mask (``model_fns(cfg)
    .stacked``) equals that rule on the reference's tree, leaf by leaf."""
    from repro_torch.models.api import model_fns

    jcfg, tcfg = _cfgs(arch, scan_layers=scan_layers)
    jp = (_params(arch)[0] if scan_layers
          else jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(path): float(leaf.ndim >= 2) for path, leaf
            in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = from_jax_params(_np_tree(jp), tcfg, device="cpu")
    got = flatten(tadamw.decay_mask(tp, stacked=model_fns(tcfg).stacked))
    assert len(got) == sum(1 for _ in leaves(tp))
    for path, m in got:
        assert m == want[_ref_path(jcfg, path)[0]], path
    if arch == "deepseek-moe-16b":
        norm = dict(got)["['layers'][0]['norm1']['scale']"]
        assert norm == 0.0          # the unstacked first dense layer


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


def _check_loss_and_grads(arch, remat):
    jcfg, tcfg = _cfgs(arch, remat=remat)
    jp, _ = _params(arch)            # the same draw: remat changes no init
    tp = from_jax_params(_np_tree(jp), tcfg, device="cpu")
    for leaf in leaves(tp):
        leaf.requires_grad_(True)
    b = _batch(tcfg, np.random.default_rng(5), 2, 16)
    b["mask"] = np.ones(b["tokens"].shape, np.float32)
    b["mask"][1, -3:] = 0
    want, jgrads = jax.value_and_grad(lambda p: jmodel_fns(jcfg).loss_fn(
        p, {k: jnp.asarray(v) for k, v in b.items()}))(jp)
    loss = causal_lm.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    want_g = from_jax_params(_np_tree(jgrads), tcfg, device="cpu")
    top = max(float(g.abs().max()) for g in leaves(want_g))
    for (path, p), g in zip(flatten(tp), leaves(want_g)):
        gs = float(g.abs().max())
        if gs < 1e-6 * top:
            assert float(p.grad.abs().max()) <= 1e-6 * top, path
            continue
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * gs, err_msg=path)
    if tcfg.num_image_tokens:
        # the image embeddings enter the loss: without them it changes
        plain = {k: v for k, v in b.items() if k != "image_embeds"}
        with torch.no_grad():
            other = causal_lm.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                                 for k, v in plain.items()})
        assert abs(float(other) - float(loss.detach())) > 1e-4


# ---------------------------------------------------------------------------
# ADMM over stacked experts and mixer projections
# ---------------------------------------------------------------------------


def _check_admm_and_finalize(arch):
    """Z/U after ``admm_init`` and after a dual update (W moved by the same
    numpy perturbation on both sides), ``primal_residual``, then the
    ``finalize`` masks (bit-equal, each expert a BCR member) and the
    pruned params, and ``apply_masks`` on moved weights."""
    jcfg, tcfg = _cfgs(arch, **PRUNE)
    jp, _ = _params(arch)
    jspecs = jadmm.specs_for(jp, jtrain.default_prune_filter(jcfg))
    tp = from_jax_params(_np_tree(jp), tcfg, device="cpu")
    tspecs = tadmm.specs_for(tp, ttrain.default_prune_filter(tcfg))

    def conv(tree):
        return from_jax_params(_np_tree(tree), tcfg, device="cpu")

    js, ts = jadmm.admm_init(jp, jspecs), tadmm.admm_init(tp, tspecs)
    _close_trees(ts.z, conv(js.z), 0, "z ")
    _close_trees(ts.u, conv(js.u), 0, "u ")
    rng = np.random.default_rng(2)
    delta = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.01, jp)
    jp = jax.tree_util.tree_map(lambda a, d: a + d, jp, delta)
    tp = conv(jp)
    js = jadmm.admm_dual_update(jp, js, jspecs)
    ts = tadmm.admm_dual_update(tp, ts, tspecs)
    _close_trees(ts.z, conv(js.z), 1e-6, "z ")
    _close_trees(ts.u, conv(js.u), 1e-6, "u ")
    assert float(tadmm.primal_residual(tp, ts, tspecs)) == pytest.approx(
        float(jadmm.primal_residual(jp, js, jspecs)), rel=1e-5)
    jpruned, jmasks = jadmm.finalize(jp, jspecs)
    tpruned, tmasks = tadmm.finalize(tp, tspecs)
    _close_trees(tmasks, conv(jmasks), 0, "mask ")
    _close_trees(tpruned, conv(jpruned), 0, "pruned ")
    _members(tpruned, tspecs)
    flat = dict(flatten(tmasks))
    for path in tspecs:
        if "['experts']" in path:        # each expert its own support
            m = flat[path].reshape(tcfg.num_experts, -1)
            assert len({tuple(r.tolist()) for r in m}) > 1, path
    moved = jax.tree_util.tree_map(lambda a, d: a + d, jpruned, delta)
    tmoved = conv(moved)
    _close_trees(tadmm.apply_masks(tmoved, tmasks),
                 conv(jadmm.apply_masks(moved, jmasks)), 0, "masked ")


# ---------------------------------------------------------------------------
# make_train_step from converted state, on the same batches
# ---------------------------------------------------------------------------


def _check_make_train_step(arch, accum, phase):
    jcfg, tcfg = _cfgs(arch, grad_accum=accum, **PRUNE)
    jp, _ = _params(arch)
    jspecs = jadmm.specs_for(jp, jtrain.default_prune_filter(jcfg))
    if phase == "admm":
        jstate = jtrain.TrainState(jp, jadamw.init(jp),
                                   jadmm.admm_init(jp, jspecs), None)
    else:
        pruned, masks = jadmm.finalize(jp, jspecs)
        jstate = jtrain.TrainState(pruned, jadamw.init(pruned), None, masks)
    tstate = from_jax_train_state(_np_tree(jstate), tcfg, device="cpu")
    tspecs = tadmm.specs_for(tstate.params, ttrain.default_prune_filter(tcfg))
    zu = leaves(tstate.admm.z) if phase == "admm" else leaves(tstate.masks)
    assert sum(x is not None for x in zu) == len(tspecs)
    admm_cfg = dict(steps_per_admm=5)
    jstep = jax.jit(jtrain.make_train_step(
        jcfg, jadamw.AdamWConfig(**OPT), jadmm.ADMMConfig(**admm_cfg),
        jspecs))
    tstep = ttrain.make_train_step(
        tcfg, tadamw.AdamWConfig(**OPT), tadmm.ADMMConfig(**admm_cfg), tspecs)
    rng = np.random.default_rng(1)
    for step in range(3):
        b = _batch(tcfg, rng, 4, 16)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5), step
    _close_trees(tstate.params, from_jax_params(_np_tree(jstate.params), tcfg,
                                                device="cpu"), 5e-5)
    assert int(tstate.opt.step) == 3
    if phase == "retrain":
        _members(tstate.params, tspecs)


# ---------------------------------------------------------------------------
# train_loop (the port alone)
# ---------------------------------------------------------------------------


def _quiet(*a):
    pass


def _loop(arch, **kw):
    _, tcfg = _cfgs(arch, **PRUNE)
    tc = dict(batch=4, seq=16, admm_start=2, retrain_start=6,
              data_kind="markov", log_every=100, device="cpu")
    tc.update(kw)
    steps = tc.pop("steps", 8)
    opt = tadamw.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=8)
    return ttrain.train_loop(tcfg, ttrain.TrainerConfig(steps=steps, **tc),
                             opt, log=_quiet)


def _check_train_loop_phases(arch):
    """Dense → ADMM (one dual update, at step 5) → frozen-mask retraining:
    finite losses, the phases in order, every pruned leaf (each expert) a
    balanced-BCR member at the end."""
    out = _loop(arch)
    assert np.isfinite(out["history"]).all()
    assert out["phases"] == ["dense"] * 2 + ["admm"] * 4 + ["retrain"] * 2
    assert len(out["transition_ms"]["dual_update"]) == 1
    assert out["state"].masks is not None and out["state"].admm is None
    _members(out["state"].params, out["specs"])


@pytest.mark.parametrize("arch", MOE)
def test_moe_resume_mid_admm_matches_uninterrupted(arch, tmp_path):
    """A checkpoint written at step 4, inside ADMM (Z/U beside the stacked
    experts, before the dual update at step 5), resumes to the losses,
    phases and params of the run that never stopped."""
    whole = _loop(arch)
    _loop(arch, steps=4, ckpt_dir=str(tmp_path), ckpt_every=4)
    resumed = _loop(arch, ckpt_dir=str(tmp_path), ckpt_every=100)
    np.testing.assert_allclose(resumed["history"], whole["history"][4:],
                               rtol=1e-5)
    assert resumed["phases"] == whole["phases"][4:]
    _close_trees(resumed["state"].params, whole["state"].params, 1e-5)


# ---------------------------------------------------------------------------
# The MoE family (the vlm and ssm in test_torch_train_vlm_ssm.py, the hybrid
# in test_torch_train_hybrid.py: the same checks, one file a worker)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE + ("llama3.2-1b", "whisper-large-v3"))
def test_prune_specs_match_reference(arch):
    """Also the dense and encdec families' trees, which the other files
    train."""
    _check_prune_specs(arch)


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference(arch):
    _check_loss_and_grads(arch, remat=True)


@pytest.mark.parametrize("arch", MOE)
def test_admm_and_finalize_match_reference(arch):
    _check_admm_and_finalize(arch)


@pytest.mark.parametrize("phase", ["admm", "retrain"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", MOE)
def test_make_train_step_matches_reference(arch, accum, phase):
    _check_make_train_step(arch, accum, phase)


def test_train_loop_phases_and_pruned_members():
    _check_train_loop_phases("deepseek-moe-16b")
