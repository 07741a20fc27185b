"""Port vs reference, the assigned shape cells and their inputs:
``input_specs`` (every arch in ``ARCH_IDS`` × every shape in ``SHAPES``:
the batch's keys, shapes and dtypes; a decode cell's cache leaves, count
and shapes, with the reference's scanned stack unstacked into the port's
per-layer layout), ``shape_applicable``, ``LONG_CONTEXT_FAMILIES`` and
``all_cells``; then ``synth_inputs``: the reference's rules and value
ranges, the same inputs for the same seed, and, as the reference's
``tests/test_models.py`` does per arch, one finite train step with nonzero
gradients, a finite prefill and a decode step at SMOKE size on the CPU.

``synth_inputs`` cannot be bit-equal across packages (``jax.random``
against a ``torch.Generator``), so values are compared by rule and range,
not one by one. The specs are meta-device tensors: building them for
``llama3-405b`` at 32768 positions allocates nothing.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.causal_lm import stack_plan as jstack_plan  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

torch.set_num_threads(2)
ARCHS = tcfgs.ARCH_IDS
SHAPE_NAMES = list(tbase.SHAPES)
# a port cache leaf → the reference's (sub-tree, leaf) in one layer's cache
_REF_LEAF = {"k": ("mixer", "k"), "v": ("mixer", "v"), "h": ("mixer", "h"),
             "conv": ("mixer", "conv"), "s": ("mixer", "s"),
             "shift": ("mixer", "shift"), "cm_shift": ("ffn", "shift")}
SMALL = {kind: tbase.ShapeSpec(kind[0], 16, 2, kind)
         for kind in ("train", "prefill", "decode")}


def _dtype(x) -> str:
    """A dtype's name in either package (``int32``, ``bfloat16``, ...)."""
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    return str(np.dtype(x))


def _ref_cache_layers(jcfg, cache):
    """The reference's causal-LM cache as one ``{port leaf: shape}`` per
    layer, in execution order (each stacked leaf's repeat axis dropped)."""
    sp = jstack_plan(jcfg)
    layers = [(lc, False) for lc in cache["prefix"]]
    for _ in range(sp.repeats):
        layers += [(lc, True) for lc in cache["stack"]]
    out = []
    for lc, stacked in layers:
        got = {}
        for key, (sub, name) in _REF_LEAF.items():
            leaf = lc.get(sub, {}).get(name)
            if leaf is not None:
                shp = tuple(leaf.shape)
                got[key] = (shp[1:] if stacked else shp, _dtype(leaf.dtype))
        out.append(got)
    return out


def test_registry_and_cells_match_reference():
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS
    assert tcfgs.all_cells() == jcfgs.all_cells()
    assert len(tcfgs.all_cells()) == len(ARCHS) * len(SHAPE_NAMES)
    assert tcfgs.LONG_CONTEXT_FAMILIES == jcfgs.LONG_CONTEXT_FAMILIES
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_matches_reference(arch):
    for name in SHAPE_NAMES:
        got = tbase.shape_applicable(tcfgs.get_config(arch),
                                     tbase.SHAPES[name])
        want = jbase.shape_applicable(jcfgs.get_config(arch),
                                      jbase.SHAPES[name])
        assert got == want, (arch, name)
    skipped = [n for n in SHAPE_NAMES if not tbase.shape_applicable(
        tcfgs.get_config(arch), tbase.SHAPES[n])[0]]
    family = tcfgs.get_config(arch).family
    assert skipped == ([] if family in ("ssm", "hybrid") else ["long_500k"])


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    want = japi.input_specs(jcfg, jbase.SHAPES[shape])
    got = tapi.input_specs(tcfg, tbase.SHAPES[shape])
    assert sorted(got) == sorted(want)
    assert sorted(got["batch"]) == sorted(want["batch"])
    for key, spec in got["batch"].items():
        ref = want["batch"][key]
        assert spec.device.type == "meta", key
        assert (tuple(spec.shape), _dtype(spec.dtype)) == \
            (tuple(ref.shape), _dtype(ref.dtype)), key
    if "cache" not in want:
        return
    for leaf in leaves(got["cache"]):
        assert leaf.device.type == "meta"
    if tcfg.family == "encdec":
        assert sorted(got["cache"]) == sorted(want["cache"])
        for key, leaf in got["cache"].items():
            ref = want["cache"][key]
            assert (tuple(leaf.shape), _dtype(leaf.dtype)) == \
                (tuple(ref.shape), _dtype(ref.dtype)), key
        return
    ref_layers = _ref_cache_layers(jcfg, want["cache"])
    assert len(got["cache"]) == len(ref_layers) == tcfg.num_layers
    n_ref = len(jax.tree_util.tree_leaves(want["cache"]))
    sp = jstack_plan(jcfg)
    per_layer = sum(len(lc) for lc in ref_layers)
    # the reference holds each stacked leaf once for all its repeats
    assert n_ref == sum(len(lc) for lc in ref_layers[:len(sp.prefix)]) + (
        (per_layer - sum(len(lc) for lc in ref_layers[:len(sp.prefix)]))
        // max(sp.repeats, 1))
    for i, (layer, ref) in enumerate(zip(got["cache"], ref_layers)):
        assert {k: (tuple(v.shape), _dtype(v.dtype))
                for k, v in layer.items()} == ref, f"layer {i}"


# ---------------------------------------------------------------------------
# synth_inputs
# ---------------------------------------------------------------------------


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      and x.dtype == torch.bfloat16 else x, dtype=np.float64)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_synth_inputs_follow_the_reference_rules(arch, kind):
    """Shapes and dtypes as ``input_specs``; ``cache_len`` = ``seq_len - 1``;
    token ids in ``[0, min(vocab, 1024))``; floats ``N(0, 1) × 0.02`` (the
    reference's and the port's sample std both within 10% of 0.02, means
    near 0); the same seed gives the same inputs, another seed others."""
    shape = SMALL[kind]
    tcfg, jcfg = tcfgs.get_smoke_config(arch), jcfgs.get_smoke_config(arch)
    got = tapi.synth_inputs(tcfg, shape, seed=3, device="cpu")
    want = japi.synth_inputs(jcfg, jbase.ShapeSpec(*dataclasses.astuple(
        shape)), seed=3)
    specs = tapi.input_specs(tcfg, shape)
    high = min(tcfg.vocab_size, 1024)
    ref_by_kind = {"int": [], "float": []}
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        name = jax.tree_util.keystr(path)
        if "cache_len" in name:
            assert (np.asarray(leaf) == shape.seq_len - 1).all()
        elif jnp.issubdtype(leaf.dtype, jnp.integer):
            ref_by_kind["int"].append(np.asarray(leaf))
        else:
            ref_by_kind["float"].append(np.asarray(leaf, np.float64))
    port_by_kind = {"int": [], "float": []}
    for (path, leaf), spec in zip(flatten(got), leaves(specs)):
        assert leaf.device.type == "cpu"
        assert (leaf.shape, leaf.dtype) == (spec.shape, spec.dtype), path
        if "cache_len" in path:
            assert (leaf == shape.seq_len - 1).all(), path
        elif leaf.dtype.is_floating_point:
            port_by_kind["float"].append(_np(leaf))
        else:
            port_by_kind["int"].append(leaf.numpy())
    for ints in (port_by_kind["int"], ref_by_kind["int"]):
        for a in ints:
            assert a.min() >= 0 and a.max() < high
    for a in port_by_kind["int"]:
        # uniform over the range: a 16-token row reaches past its middle
        assert a.max() >= high // 2 or a.size < 8
    for floats in (port_by_kind["float"], ref_by_kind["float"]):
        if floats:
            flat = np.concatenate([f.ravel() for f in floats])
            assert abs(flat.std() / 0.02 - 1) < 0.1
            assert abs(flat.mean()) < 0.02 * 5 / np.sqrt(flat.size)
    assert bool(port_by_kind["float"]) == bool(ref_by_kind["float"])
    again = tapi.synth_inputs(tcfg, shape, seed=3, device="cpu")
    other = tapi.synth_inputs(tcfg, shape, seed=4, device="cpu")
    for a, b, c in zip(leaves(got), leaves(again), leaves(other)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, c) for a, c in zip(leaves(got),
                                                      leaves(other)))


_STATES = {}


def _state(arch):
    if arch not in _STATES:
        cfg = tcfgs.get_smoke_config(arch)
        fns = tapi.model_fns(cfg)
        _STATES[arch] = (cfg, fns, ttrain.init_state(cfg, 0, "cpu"))
    return _STATES[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_finite(arch):
    """One ``make_train_step`` on a ``synth_inputs`` train batch (frames
    for encdec, ``image_embeds`` for the vlm): a finite loss, every
    gradient finite, a nonzero gradient norm, and the params moved."""
    cfg, fns, state = _state(arch)
    batch = tapi.synth_inputs(cfg, SMALL["train"], seed=0,
                              device="cpu")["batch"]
    before = [p.detach().clone() for p in leaves(state.params)]
    step = ttrain.make_train_step(cfg, tadamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=4))
    loss = fns.loss_fn(state.params, batch)
    loss.backward()
    grads = [p.grad for p in leaves(state.params) if p.grad is not None]
    assert np.isfinite(float(loss.detach()))
    assert all(torch.isfinite(g).all() for g in grads)
    gnorm = sum(float(g.float().abs().sum()) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0
    for p in leaves(state.params):
        p.grad = None
    new_state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()),
                                                   rel=1e-5)
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    moved = sum(int(not torch.equal(b, p.detach()))
                for b, p in zip(before, leaves(new_state.params)))
    assert moved > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_synth_inputs(arch):
    """The reference's per-arch prefill and decode checks on the port:
    finite prefill logits; a decode step on a synthetic cache gives
    ``(B, 1, V)`` finite logits and leaves the cache's nesting as it was."""
    cfg, fns, state = _state(arch)
    with torch.no_grad():
        ins = tapi.synth_inputs(cfg, SMALL["prefill"], seed=1, device="cpu")
        logits, _ = fns.prefill(state.params, ins["batch"])
        assert torch.isfinite(logits.float()).all()
        ins = tapi.synth_inputs(cfg, SMALL["decode"], seed=2, device="cpu")
        before = [path for path, _ in flatten(ins["cache"])]
        logits, cache = fns.decode_step(state.params, ins["batch"],
                                        ins["cache"])
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    assert [path for path, _ in flatten(cache)] == before
