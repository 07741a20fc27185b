"""The port's ``serving/tp.py`` against the reference's on the CPU:
``shard_params`` (each rank's local tree) equal to the reference's
``prepare_params`` global arrays cut by their ``PartitionSpec``s on one JAX
device, for packed, fused, int8 and dense params, the replicated
odd-vocab ``lm_head`` and the unshardable-attention error; ``cache_axes``
against the reference's probe (dense, vlm, int8 KV); ``shardable`` and
``localize_cfg`` for every arch of ``configs``."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.launch.serve import build_params as jbuild_params  # noqa: E402
from repro.serving import tp as jtp  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.serving import tp as ttp  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

torch.set_num_threads(2)


def _cfgs(**over):
    base = dict(num_kv_heads=4, attn_impl="dense", dtype="float32",
                cache_dtype="float32")
    base.update(over)
    return (dataclasses.replace(jcfgs.get_smoke_config("llama3.2-3b"),
                                **base),
            dataclasses.replace(tcfgs.get_smoke_config("llama3.2-3b"),
                                **base))


def _cut(prepared, specs, tp, rank):
    """The slice of every prepared global array a device of the mesh
    holds: along each axis its ``PartitionSpec`` names ``"model"``."""
    def one(spec, x):
        if x is None:
            return None
        x = np.asarray(x)
        for ax, name in enumerate(spec):
            if name == jtp.AXIS:
                n = x.shape[ax] // tp
                x = np.take(x, np.arange(rank * n, (rank + 1) * n), axis=ax)
        return x
    return jax.tree_util.tree_map(
        one, specs, prepared,
        is_leaf=lambda s: isinstance(s, P) or s is None)


def _variant(name):
    if name == "dense":
        jcfg, tcfg = _cfgs()
    elif name == "odd_vocab":
        # 520 rows = 65 row blocks of 8: lm_head does not split in two
        jcfg, tcfg = _cfgs(bcr_keep_frac=0.5, bcr_block=(8, 8),
                           vocab_size=520)
    else:
        jcfg, tcfg = _cfgs(bcr_keep_frac=0.5, bcr_block=(8, 8))
    params = jbuild_params(jcfg, log=lambda *a, **k: None, decode_m=4)
    if name == "fused":
        # the reference's tuner votes per shape; fuse every group here
        params = _fuse_all(params)
    if name == "int8":
        params = jplan.quantize_packed_params(params)
    return jcfg, tcfg, params


def _fuse_all(tree):
    """Fuse K/V and gate/up of every layer dict with the reference's
    ``pack_group`` (whatever its tuner would vote)."""
    if isinstance(tree, dict):
        out = {k: _fuse_all(v) for k, v in tree.items()}
        for fused, members in (("wkv", ("wk", "wv")), ("wgi", ("wg", "wi"))):
            if all(k in out and "w_packed" in out[k] for k in members):
                packs = [out.pop(k)["w_packed"] for k in members]
                out[fused] = {"w_group": jplan.pack_group(packs)}
        return out
    if isinstance(tree, list):
        return [_fuse_all(v) for v in tree]
    return tree


@pytest.mark.parametrize("variant,tp", [
    (v, tp) for v in ("packed", "fused", "int8", "dense") for tp in (2, 4)]
    + [("odd_vocab", 2)])
def test_shard_params_equals_the_reference_cut(variant, tp):
    jcfg, tcfg, params = _variant(variant)
    prepared, specs = jtp.prepare_params(params, tp)
    whole = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                            tcfg, device="cpu")
    if variant == "fused":
        assert any("['w_group']" in path for path, _ in flatten(whole))
    for rank in range(tp):
        want = from_jax_params(_cut(prepared, specs, tp, rank), tcfg,
                               device="cpu")
        got = ttp.shard_params(whole, tp, rank)
        gf, wf = flatten(got), flatten(want)
        assert [p for p, _ in gf] == [p for p, _ in wf]
        for (path, g), (_, w) in zip(gf, wf):
            if isinstance(w, torch.Tensor):
                assert g.dtype == w.dtype and torch.equal(g, w), path
            else:
                assert g == w, path
    shard0 = ttp.shard_params(whole, tp, 0)
    # the embedding is indexed by token id: always replicated
    assert shard0["embed"]["table"] is whole["embed"]["table"]
    lm = shard0["lm_head"]
    rows = (lm["w_packed"].shape[0] if "w_packed" in lm
            else lm["w"].shape[0])
    assert rows == (tcfg.vocab_size if variant == "odd_vocab"
                    else tcfg.vocab_size // tp)


def test_unshardable_attention_projection_raises():
    jcfg, tcfg = _cfgs(num_kv_heads=2)
    params = jbuild_params(jcfg, log=lambda *a, **k: None, decode_m=4)
    whole = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                            tcfg, device="cpu")
    with pytest.raises(ValueError, match="attention projection"):
        jtp.prepare_params(params, 3)     # 64 rows do not split 3 ways
    with pytest.raises(ValueError, match="attention projection"):
        ttp.shard_params(whole, 3, 0)


@pytest.mark.parametrize("name,over", [
    ("llama3.2-3b", dict(num_kv_heads=4)),
    ("pixtral-12b", {}),
    ("llama3.2-3b", dict(num_kv_heads=4, kv_dtype="int8")),
])
def test_cache_axes_match_the_reference(name, over):
    """The Hkv axis of every pool leaf, codes and int8 scales, counted from
    the end: the reference stacks its layers on a leading axis, the port
    keeps one dict a layer."""
    jcfg = dataclasses.replace(jcfgs.get_smoke_config(name), **over)
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(name), **over)
    for kw in (dict(kv_pages=8, page_size=4), {}):
        want = jtp.cache_axes(jcfg, 4, 32, **kw)
        shapes = jax.eval_shape(lambda: __import__(
            "repro.models.causal_lm", fromlist=["init_cache"]).init_cache(
                jcfg, 4, 32, **kw))
        got = ttp.cache_axes(tcfg, 4, 32, **kw)
        tshapes = ttp.model_fns(tcfg).init_cache(batch=4, capacity=32,
                                                 device="meta", **kw)
        # the reference's stack: one pattern position, its mixer's leaves
        # (L, ...)
        jax_axes, jax_shapes = (want["stack"][0]["mixer"],
                                shapes["stack"][0]["mixer"])
        jl = {k: (ax, jax_shapes[k].ndim) for k, ax in jax_axes.items()}
        for layer, tl in zip(got, tshapes):
            assert set(layer) == set(jl)
            for k, ax in layer.items():
                jax_ax, jnd = jl[k]
                assert (ax - tl[k].dim()) == (jax_ax - jnd), k
                assert tl[k].shape[ax] == tcfg.num_kv_heads
        specs = ttp.cache_specs(tcfg, 4, 32, **kw)
        assert specs == [{k: (None if a < 0 else a) for k, a in l.items()}
                         for l in got]


@pytest.mark.parametrize("arch", sorted(tcfgs.ARCH_IDS))
def test_shardable_and_localize_cfg_match_the_reference(arch):
    for tp in (2, 4):
        for page_size in (0, 4):
            jcfg = jcfgs.get_smoke_config(arch)
            tcfg = tcfgs.get_smoke_config(arch)
            assert ttp.shardable(tcfg, tp, page_size) == \
                jtp.shardable(jcfg, tp, page_size)
        if ttp.shardable(tcfg, tp, 4) is None:
            got, want = ttp.localize_cfg(tcfg, tp), jtp.localize_cfg(jcfg,
                                                                     tp)
            for f in dataclasses.fields(want):
                a, b = getattr(got, f.name), getattr(want, f.name)
                assert (tuple(a) if isinstance(a, (list, tuple)) else a) == \
                    (tuple(b) if isinstance(b, (list, tuple)) else b), f.name
    assert ttp.per_device_kv_bytes(1000, 2) == jtp.per_device_kv_bytes(1000,
                                                                       2)
    assert ttp.per_device_kv_bytes(1000, 0) == 1000
