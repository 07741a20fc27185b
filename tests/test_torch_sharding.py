"""The port's sharding and partitioning rules (``runtime/sharding.py``,
``runtime/partitioning.py``) against the reference's, leaf by leaf.

The reference's spec functions read only a mesh's ``axis_names`` and
``devices.shape``, so a stand-in object with those two attributes runs
them here without 256 devices; the port's read the same. The port's params
are fake (meta-backed, no storage) under ``FakeTensorMode``, the
reference's come from ``jax.eval_shape``. Where the reference stacks a
layer's leaves on a repeat axis, its spec for the stacked leaf, with that
axis's entry dropped, is the port's spec for the unstacked leaf.
"""

import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jcfgs
from repro.models import causal_lm as jlm
from repro.models.api import input_specs as jinput_specs
from repro.models.api import model_fns as jmodel_fns
from repro.runtime import partitioning as jpart
from repro.runtime import sharding as jshard
from repro_torch import configs as tcfgs
from repro_torch.models.api import input_specs, model_fns
from repro_torch.runtime import partitioning as part
from repro_torch.runtime import sharding as shard
from repro_torch.tree import flatten

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def stand_in(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _canon(spec):
    """A spec with each one-axis tuple entry written as that axis (as
    ``PartitionSpec`` writes it; the same layout)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _norm(spec, ndim):
    """A reference ``PartitionSpec`` as a tuple of ``ndim`` entries."""
    s = _canon(spec)
    return s + (None,) * (ndim - len(s))


def _ref_layer_path(cfg, path):
    """The port's ``['layers'][i]...`` path → (the reference's path, its
    stacked? flag)."""
    if cfg.family == "encdec":
        for port, ref in (("['enc_layers']", "['enc_stack']"),
                          ("['dec_layers']", "['dec_stack']")):
            if path.startswith(port):
                rest = path[len(port):]
                return ref + rest[rest.index("]") + 1:], True
        return path, False
    if not path.startswith("['layers']"):
        return path, False
    rest = path[len("['layers']"):]
    i = int(rest[1:rest.index("]")])
    rest = rest[rest.index("]") + 1:]
    sp = jlm.stack_plan(cfg)
    if i < len(sp.prefix):
        return f"['prefix'][{i}]{rest}", False
    pos = (i - len(sp.prefix)) % len(sp.pattern)
    return f"['stack'][{pos}]{rest}", True


_PARAMS = {}


def _params(arch, smoke):
    key = (arch, smoke)
    if key not in _PARAMS:
        get = tcfgs.get_smoke_config if smoke else tcfgs.get_config
        jget = jcfgs.get_smoke_config if smoke else jcfgs.get_config
        tcfg, jcfg = get(arch), jget(arch)
        with FakeTensorMode():
            port = model_fns(tcfg).init_params(0, device="cpu")
        ref = jax.eval_shape(jmodel_fns(jcfg).init_params,
                             jax.random.PRNGKey(0))
        ref_leaves = {jax.tree_util.keystr(p): (p, l) for p, l in
                      jax.tree_util.tree_flatten_with_path(ref)[0]}
        _PARAMS[key] = (tcfg, jcfg, port, ref_leaves)
    return _PARAMS[key]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, smoke):
    tcfg, jcfg, port, ref = _params(arch, smoke)
    stacks = shard.stack_sizes(tcfg)
    seen = set()
    for mesh_name in MESHES:
        mesh = stand_in(mesh_name)
        for fsdp in (False, True):
            specs = shard.param_specs(port, mesh, fsdp=fsdp, stacks=stacks)
            for path, leaf in flatten(port):
                rpath, stacked = _ref_layer_path(jcfg, path)
                keypath, rleaf = ref[rpath]
                seen.add(rpath)
                want = _norm(jshard.param_pspec(keypath, rleaf, mesh,
                                                fsdp=fsdp),
                             len(rleaf.shape))
                if stacked:
                    assert tuple(rleaf.shape[1:]) == tuple(leaf.shape), path
                    assert want[0] is None
                    want = want[1:]
                else:
                    assert tuple(rleaf.shape) == tuple(leaf.shape), path
                assert _canon(specs[path]) == want, (path, mesh_name, fsdp)
    assert seen == set(ref), sorted(set(ref) - seen)


def _ref_cache_path(jcfg, path):
    """The port's cache path → (the reference's, stacked?)."""
    if jcfg.family == "encdec":
        return path, False
    i = int(path[1:path.index("]")])
    key = path[path.index("]") + 1:]
    sp = jlm.stack_plan(jcfg)
    if key == "['cm_shift']":
        tail = "['ffn']['shift']"
    else:
        tail = f"['mixer']{key}"
    if i < len(sp.prefix):
        return f"['prefix'][{i}]{tail}", False
    pos = (i - len(sp.prefix)) % len(sp.pattern)
    return f"['stack'][{pos}]{tail}", True


@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    tcfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    stacks = shard.stack_sizes(tcfg)
    for shape_name, tshape in tcfgs.SHAPES.items():
        jshape = jcfgs.SHAPES[shape_name]
        port, ref = input_specs(tcfg, tshape), jinput_specs(jcfg, jshape)
        for mesh_name in MESHES:
            mesh = stand_in(mesh_name)
            rbatch = {jax.tree_util.keystr(p): l for p, l in
                      jax.tree_util.tree_flatten_with_path(ref["batch"])[0]}
            assert {p for p, _ in flatten(port["batch"])} == set(rbatch)
            for path, leaf in flatten(port["batch"]):
                assert _canon(shard.batch_pspec(leaf.shape, mesh)) == _norm(
                    jshard.batch_pspec(rbatch[path].shape, mesh), leaf.dim())
            if "cache" not in port:
                continue
            rcache = {jax.tree_util.keystr(p): l for p, l in
                      jax.tree_util.tree_flatten_with_path(ref["cache"])[0]}
            specs = shard.cache_specs(port["cache"], mesh,
                                      batch=tshape.global_batch,
                                      capacity=tshape.seq_len, stacks=stacks)
            seen = set()
            for path, leaf in flatten(port["cache"]):
                rpath, stacked = _ref_cache_path(jcfg, path)
                seen.add(rpath)
                rleaf = rcache[rpath]
                want = _norm(jshard.cache_pspec(
                    rleaf.shape, mesh, batch=jshape.global_batch,
                    capacity=jshape.seq_len), len(rleaf.shape))
                if stacked:
                    assert want[0] is None
                    want = want[1:]
                assert _canon(specs[path]) == want, (path, shape_name,
                                                     mesh_name)
            assert seen == set(rcache)


def test_expert_rule_precedes_generic():
    """The reference's regression for perf iteration B2 (rule shadowing)."""
    idx = {pat: i for i, (pat, _) in enumerate(shard.PARAM_RULES)}
    assert idx["*ffn*experts*wo*w"] < idx["*wo*w"]
    assert shard.PARAM_RULES == jshard.PARAM_RULES


def test_cache_pspec_never_shards_layer_dim():
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((1, 1)))
    spec = shard.cache_pspec((16, 128, 32768, 8, 64), mesh, batch=128,
                             capacity=32768)
    assert spec[0] is None  # dim0 (=16 stacked layers) stays unsharded
    # the port's unstacked leaf, told of the reference's stack
    assert shard.cache_pspec((128, 32768, 8, 64), mesh, batch=128,
                             capacity=32768, stack=16) == spec[1:]


def test_rules_are_the_reference_rules():
    assert part.TRAIN_RULES == jpart.TRAIN_RULES
    assert part.DECODE_RULES == jpart.DECODE_RULES


def test_act_noop_without_rules():
    import torch
    x = torch.ones((4, 4))
    assert part.act(x, "batch", "embed") is x
    assert not part.rules_active() and not part.divides(16, "batch")


def test_act_skips_nondivisible_and_plain_tensors():
    import torch
    mesh = types.SimpleNamespace(mesh_dim_names=("model",), shape=(1,))
    with part.use_rules({"heads": "model"}, mesh):
        assert part.rules_active()
        x = torch.ones((5,))
        assert part.act(x, "heads") is x    # a plain tensor: unchanged
        assert part.spec_for((5,), "heads") == (None,)   # size-1 axis
    assert not part.rules_active()


def test_rules_drop_absent_axes():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4))
    with part.use_rules(part.TRAIN_RULES, mesh):
        # "batch" maps to (pod, data); pod absent → data only
        assert part.spec_for((2, 3), "batch", None) == (("data",), None)
        assert part.spec_for((3, 8), "seq_sp", "mlp") == (None, "model")
        assert part.spec_for((6, 8), "heads", "embed") == (None, None)
        with pytest.raises(ValueError):
            part.spec_for((2, 3), "batch")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules", ["train", "decode"])
def test_divides_equals_the_reference(mesh_name, rules):
    t, j = ((part.TRAIN_RULES, jpart.TRAIN_RULES) if rules == "train"
            else (part.DECODE_RULES, jpart.DECODE_RULES))
    ref_mesh = stand_in(mesh_name)
    shape, names = MESHES[mesh_name]
    port_mesh = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    sizes = [1, 2, 8, 16, 20, 32, 40, 48, 128, 256, 512, 1024, 1500, 51866]
    with jpart.use_rules(j, ref_mesh):
        want = {(n, name): jpart.divides(n, name) for n in sizes
                for name in j}
    with part.use_rules(t, port_mesh):
        got = {(n, name): part.divides(n, name) for n in sizes
               for name in t}
    assert got == want


def test_placements_and_act_redistribute_on_a_fake_mesh():
    """``placements`` and ``act`` on ``DTensor``s over a fake 16×16 group
    (in a subprocess: the fake group must not become this process's)."""
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.dryrun import fake_group
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.runtime import partitioning as part
        from repro_torch.runtime import sharding as shard
        fake_group(256)
        mesh = make_production_mesh(device="cpu")
        assert shard.placements((("data",), None, "model"), mesh) == (
            Shard(0), Shard(2))
        assert shard.replicated(mesh) == (Replicate(), Replicate())
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(16, 64, 4), mesh,
                                   [Shard(0), Replicate()], run_check=False,
                                   shape=(256, 64, 4), stride=(256, 4, 1))
            assert part.act(x, "batch", "seq_sp", "embed") is x  # no rules
            with part.use_rules(part.TRAIN_RULES, mesh):
                y = part.act(x, "batch", "seq_sp", "embed")
                assert y.placements == (Shard(0), Shard(1)), y.placements
                assert tuple(y.to_local().shape) == (16, 4, 4)
                z = part.act(y, "batch", "seq", "embed")  # seq gathered
                assert z.placements == (Shard(0), Replicate())
                assert part.act(z, "batch", "seq", "embed") is z
                # 20 heads do not divide 16: that dim stays replicated
                h = DTensor.from_local(torch.empty(16, 20), mesh,
                                       [Shard(0), Replicate()],
                                       run_check=False, shape=(256, 20),
                                       stride=(20, 1))
                assert part.act(h, "batch", "heads").placements == (
                    Shard(0), Replicate())
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]


def test_shardings_are_the_placements_of_the_specs():
    """``param_shardings``, ``batch_shardings`` and ``cache_shardings`` give
    each leaf its spec's DTensor placements (mesh order), over a stand-in
    mesh: no process group is needed to name a layout."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = stand_in("2x16x16")
    tcfg, _, port, _ = _params("llama3.2-1b", True)
    stacks = shard.stack_sizes(tcfg)
    specs = shard.param_specs(port, mesh, fsdp=True, stacks=stacks)
    got = shard.param_shardings(port, mesh, fsdp=True, stacks=stacks)
    assert got == {k: shard.placements(v, mesh) for k, v in specs.items()}
    shape = tcfgs.SHAPES["decode_32k"]
    specs_in = input_specs(tcfg, shape)
    batch = shard.batch_shardings(specs_in["batch"], mesh)
    assert batch["['tokens']"] == (Shard(0), Shard(0), Replicate())
    cache = shard.cache_shardings(specs_in["cache"], mesh, batch=128,
                                  capacity=32768, stacks=stacks)
    # K/V: batch over pod × data, the context over model
    assert cache["[0]['k']"] == (Shard(0), Shard(0), Shard(1))
    assert shard.replicated(mesh) == (Replicate(),) * 3
