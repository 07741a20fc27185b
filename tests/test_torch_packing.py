"""Port vs reference, pack time: configs field by field, BCR indices, TBCRC
packing, plans and groups, and the param converter (including the unstacked
scan axis). Inputs come from numpy with a fixed seed."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.core import bcr as jbcr  # noqa: E402
from repro.core import bcrc as jbcrc  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import bcr as tbcr  # noqa: E402
from repro_torch.core import bcrc as tbcrc  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402

torch.set_num_threads(2)

DENSE = ["llama3.2-1b", "llama3.2-3b", "llama3-405b", "qwen1.5-4b"]


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_reference(arch, smoke):
    get_j = jcfgs.get_smoke_config if smoke else jcfgs.get_config
    get_t = tcfgs.get_smoke_config if smoke else tcfgs.get_config
    jc, tc = get_j(arch), get_t(arch)
    jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    assert jf == tf
    assert str(jnp.dtype(jc.dtype)) == str(tc.act_dtype).split(".")[-1]


def test_other_families_raise():
    with pytest.raises(NotImplementedError):
        tcfgs.get_config("rwkv6-3b")


SPECS = [  # (shape, block, keep, align)
    ((64, 96), (16, 32), 0.25, 4),
    ((256, 128), (128, 128), 0.25, 8),
    ((48, 40), (8, 8), 0.1, 2),
]


@pytest.mark.parametrize("shape,block,keep,align", SPECS)
def test_bcr_indices_and_pack_match_reference(shape, block, keep, align):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jspec = jbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align)
    tspec = tbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align)
    assert jspec.kept_counts() == tspec.kept_counts()
    assert jbcr.choose_block_shape(shape, block) == \
        tbcr.choose_block_shape(shape, block)
    assert jbcr.kept_align(block) == tbcr.kept_align(block)

    jr, jc = jbcr.bcr_indices(jnp.asarray(w), jspec)
    tr, tc = tbcr.bcr_indices(torch.as_tensor(w), tspec)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())

    jp = jbcrc.tbcrc_pack(jnp.asarray(w), jspec)
    tp = tbcrc.tbcrc_pack(torch.as_tensor(w), tspec)
    np.testing.assert_array_equal(np.asarray(jp.vals), tp.vals.numpy())
    np.testing.assert_array_equal(np.asarray(jp.plan.gather_cols),
                                  tp.plan.gather_cols.numpy())
    np.testing.assert_array_equal(np.asarray(jp.plan.scatter_rows),
                                  tp.plan.scatter_rows.numpy())
    np.testing.assert_array_equal(np.asarray(jbcrc.tbcrc_unpack(jp)),
                                  tbcrc.tbcrc_unpack(tp).numpy())
    jd = jplan.default_plan(jp.row_idx, jp.col_idx, block)
    td = tplan.default_plan(tp.row_idx, tp.col_idx, block)
    np.testing.assert_array_equal(np.asarray(jd.gather_cols),
                                  td.gather_cols.numpy())


@pytest.mark.parametrize("g", [2, 3])
def test_pack_group_matches_reference(g):
    rng = np.random.default_rng(1)
    spec_j = jbcr.BCRSpec(block_shape=(16, 16), keep_frac=0.25, align=4)
    spec_t = tbcr.BCRSpec(block_shape=(16, 16), keep_frac=0.25, align=4)
    ws = [rng.normal(size=(32, 64)).astype(np.float32) for _ in range(g)]
    jg = jplan.pack_group([jbcrc.tbcrc_pack(jnp.asarray(w), spec_j)
                           for w in ws])
    tg = tplan.pack_group([tbcrc.tbcrc_pack(torch.as_tensor(w), spec_t)
                           for w in ws])
    assert tg.group_size == jg.group_size and tg.shape == jg.shape
    for name in ("vals", "row_idx", "col_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(tg, name).numpy())
    np.testing.assert_array_equal(np.asarray(jg.plan.gather_cols),
                                  tg.plan.gather_cols.numpy())
    np.testing.assert_array_equal(np.asarray(jg.plan.scatter_rows),
                                  tg.plan.scatter_rows.numpy())
    assert tplan.groupable([tbcrc.tbcrc_pack(torch.as_tensor(w), spec_t)
                            for w in ws])


@pytest.fixture(scope="module")
def jax_packed():
    """Reference smoke params, dense and packed (GA-planned), per arch."""
    out = {}
    for arch in ("llama3.2-1b", "qwen1.5-4b"):
        cfg = dataclasses.replace(jcfgs.get_smoke_config(arch),
                                  bcr_keep_frac=0.25, bcr_block=(16, 16))
        params = jmodel_fns(cfg).init_params(jax.random.PRNGKey(0))
        out[arch] = (cfg, params, jpack_params(cfg, params))
    return out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen1.5-4b"])
def test_converter_unstacks_reference_params(jax_packed, arch):
    jcfg, _, packed = jax_packed[arch]
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch),
                               bcr_keep_frac=0.25, bcr_block=(16, 16))
    tree = jax.tree_util.tree_map(np.asarray, packed)
    tp = from_jax_params(tree, tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.num_layers
    np.testing.assert_array_equal(tree["embed"]["table"],
                                  tp["embed"]["table"].numpy())
    stack = tree["stack"][0]
    for li, layer in enumerate(tp["layers"]):
        mixer, ffn = layer["mixer"], layer["ffn"]
        for key, node in (("mixer", mixer), ("ffn", ffn)):
            jnode = stack[key]
            for name, entry in node.items():
                if "w_group" in entry:
                    jg, tg = jnode[name]["w_group"], entry["w_group"]
                    for f in ("vals", "row_idx", "col_idx"):
                        np.testing.assert_array_equal(
                            np.asarray(getattr(jg, f))[li],
                            getattr(tg, f).numpy())
                    np.testing.assert_array_equal(
                        np.asarray(jg.plan.scatter_rows)[li],
                        tg.plan.scatter_rows.numpy())
                    if "b" in entry:
                        np.testing.assert_array_equal(
                            np.asarray(jnode[name]["b"])[li],
                            entry["b"].numpy())
                elif "w_packed" in entry:
                    jpk, tpk = jnode[name]["w_packed"], entry["w_packed"]
                    np.testing.assert_array_equal(
                        np.asarray(jpk.vals)[li], tpk.vals.numpy())
                    np.testing.assert_array_equal(
                        np.asarray(jpk.plan.gather_cols)[li],
                        tpk.plan.gather_cols.numpy())
                else:
                    np.testing.assert_array_equal(
                        np.asarray(jnode[name]["w"])[li], entry["w"].numpy())
    lm = tp["lm_head"]["w_packed"]
    np.testing.assert_array_equal(np.asarray(tree["lm_head"]["w_packed"].vals),
                                  lm.vals.numpy())


def test_port_pack_params_matches_reference_indices(jax_packed):
    """The port's pack_params on the same dense weights keeps the same
    survivors as the reference (seeded normal weights: no energy ties)."""
    from repro_torch.launch.serve import pack_params as tpack_params
    jcfg, dense, packed = jax_packed["llama3.2-1b"]
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                               bcr_keep_frac=0.25, bcr_block=(16, 16))
    tdense = from_jax_params(jax.tree_util.tree_map(np.asarray, dense), tcfg,
                             device="cpu")
    tpacked = tpack_params(tcfg, tdense)
    jl = np.asarray(packed["lm_head"]["w_packed"].row_idx)
    np.testing.assert_array_equal(jl, tpacked["lm_head"]["w_packed"]
                                  .row_idx.numpy())
    jwo = packed["stack"][0]["ffn"]["wo"]["w_packed"]
    for li, layer in enumerate(tpacked["layers"]):
        np.testing.assert_array_equal(np.asarray(jwo.col_idx)[li],
                                      layer["ffn"]["wo"]["w_packed"]
                                      .col_idx.numpy())
        assert "wgi" in layer["ffn"] and "wkv" in layer["mixer"]
