"""Port vs reference, the paper's GRU (``models/gru.py``): one cell step,
the whole ``gru_apply`` and the latency unit ``gru_step_latency_fn``, dense
and BCR-packed (the reference's packed path through its ``ref`` kernels);
the converter; and ~10 masked training steps of the ``gru_rnn`` recipe.
d_model 32, S 8, 2 layers, vocab 16, 4 classes. Params come from the
reference's init (converted), inputs from numpy with a fixed seed.

Tolerances (fp32 throughout): forward outputs within 1e-5 × max(1, |want|)
(the same products summed in another order; packed, the plain gather
against the reference's reconstruction-free einsum); training losses within
1e-4 relative per step and the frozen masks identical (Adam's normalised
step amplifies fp32 noise near zero grads; the masks are top-k selections
over weights that differ by that noise, with no near-tie at this seed)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import admm as jadmm  # noqa: E402
from repro.core.bcr import BCRSpec as JBCRSpec  # noqa: E402
from repro.core.bcr import choose_block_shape as jchoose  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models import gru as jgru  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import from_jax_gru  # noqa: E402
from repro_torch.core.bcrc import TBCRC  # noqa: E402
from repro_torch.examples import gru_rnn as tex  # noqa: E402
from repro_torch.launch.serve import pack_params  # noqa: E402
from repro_torch.models import gru as tgru  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

torch.set_num_threads(2)

VOCAB, D, LAYERS, CLASSES, B, S = 16, 32, 2, 4, 3, 8
FWD_TOL = 1e-5


def _cfgs():
    kw = dict(name="gru", family="dense", num_layers=LAYERS, d_model=D,
              num_heads=1, num_kv_heads=1, head_dim=D, d_ff=D,
              vocab_size=VOCAB, bcr_keep_frac=0.1, bcr_block=(8, 8))
    return JModelConfig(**kw), ModelConfig(dtype="float32", **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jfil(path, leaf):
    """The reference example's prune filter."""
    if not jax.tree_util.keystr(path).endswith("['w']") or leaf.ndim != 2:
        return None
    return JBCRSpec(block_shape=jchoose(leaf.shape, (8, 8)), keep_frac=0.1,
                    align=2)


def _close(got, want, tol=FWD_TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


_MODELS = {}


def _models():
    """(reference dense masked, reference packed, port dense, port packed
    from the converted reference pack), built once."""
    if not _MODELS:
        jcfg, tcfg = _cfgs()
        params = jgru.gru_init(jax.random.PRNGKey(0), VOCAB, D, LAYERS,
                               CLASSES)
        specs = jadmm.specs_for(params, _jfil)
        dense, _ = jadmm.finalize(params, specs)
        packed = jpack_params(jcfg, dense)
        _MODELS.update(
            jdense=dense, jpacked=packed,
            tdense=from_jax_gru(_np(dense), tcfg, "cpu"),
            tpacked=from_jax_gru(_np(packed), tcfg, "cpu"))
    return _MODELS


def _tokens():
    return np.random.default_rng(0).integers(0, VOCAB, size=(B, S)).astype(
        np.int32)


def test_converter_keeps_the_tree():
    m = _models()
    assert set(m["tpacked"]) == {"embed", "cells", "head"}
    for cell in m["tpacked"]["cells"]:
        assert set(cell) == {"wz", "uz", "wr", "ur", "wh", "uh"}
        for lin in cell.values():
            assert isinstance(lin["w_packed"], TBCRC)
            assert lin["w_packed"].vals.shape == (4, 4, 2, 4)
            assert lin["w_packed"].vals.dtype == torch.float32
    # the head (4 x 32) is too small for (8, 8) blocks at pack time
    assert set(m["tpacked"]["head"]) == {"w"}
    with pytest.raises(ValueError):
        from_jax_gru({"embed": 0}, _cfgs()[1], "cpu")


def test_port_pack_matches_the_reference_pack():
    """The port's ``pack_params`` of the converted dense masked weights
    keeps the reference's index planes and values."""
    m = _models()
    tcfg = _cfgs()[1]
    mine = pack_params(tcfg, m["tdense"])
    for (path, got), want in zip(flatten(mine), leaves(m["tpacked"])):
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                          err_msg=path)
        else:
            assert got == want, path


@pytest.mark.parametrize("packed", [False, True])
def test_cell_step_matches_reference(packed):
    m = _models()
    jp = m["jpacked" if packed else "jdense"]["cells"][0]
    tp = m["tpacked" if packed else "tdense"]["cells"][0]
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, D)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    want = jgru.gru_cell_step(jp, jnp.asarray(h), jnp.asarray(x), impl="ref")
    got = tgru.gru_cell_step(tp, torch.from_numpy(h), torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_gru_apply_matches_reference(packed):
    m = _models()
    toks = _tokens()
    want = jgru.gru_apply(m["jpacked" if packed else "jdense"],
                          jnp.asarray(toks), impl="ref")
    got = tgru.gru_apply(m["tpacked" if packed else "tdense"],
                         torch.from_numpy(toks))
    assert got.shape == (B, CLASSES)
    _close(got, want)


def test_packed_equals_dense_masked_forward():
    m = _models()
    toks = torch.from_numpy(_tokens())
    _close(tgru.gru_apply(m["tpacked"], toks),
           tgru.gru_apply(m["tdense"], toks).numpy())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("batch", [1, 32])
def test_step_latency_fn_matches_reference(packed, batch):
    m = _models()
    rng = np.random.default_rng(2)
    h = rng.normal(size=(batch, D)).astype(np.float32)
    x = rng.normal(size=(batch, D)).astype(np.float32)
    key = "packed" if packed else "dense"
    want = jgru.gru_step_latency_fn(m["j" + key])(jnp.asarray(h),
                                                  jnp.asarray(x))
    got = tgru.gru_step_latency_fn(m["t" + key])(torch.from_numpy(h),
                                                 torch.from_numpy(x))
    _close(got, want)


def test_gru_init_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    p = tgru.gru_init(gen, VOCAB, D, LAYERS, CLASSES, dtype=torch.bfloat16)
    j = jgru.gru_init(jax.random.PRNGKey(0), VOCAB, D, LAYERS, CLASSES)
    assert {path: tuple(t.shape) for path, t in flatten(p)} == \
        {jax.tree_util.keystr(path): tuple(a.shape)
         for path, a in jax.tree_util.tree_flatten_with_path(j)[0]}
    assert all(t.dtype == torch.bfloat16 for t in leaves(p))


TRAIN_STEPS, TRAIN_N = 10, 64


def _reference_train(params, x, y, steps):
    """The reference example's recipe (``examples/gru_rnn.py``), its sizes
    cut: losses and the frozen masks."""
    opt_cfg = jadamw.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=steps,
                                 weight_decay=0.0)
    opt = jadamw.init(params)
    specs = jadmm.specs_for(params, _jfil)
    none_masks = jax.tree_util.tree_map(lambda _: None, params)
    masks = None

    def loss_fn(p, masks):
        p = jax.tree_util.tree_map(
            lambda w, m: w if m is None else w * m, p, masks,
            is_leaf=lambda v: v is None)
        logits = jgru.gru_apply(p, x)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])

    @jax.jit
    def step(p, o, masks):
        loss, g = jax.value_and_grad(lambda q: loss_fn(q, masks))(p)
        p, o, _ = jadamw.update(opt_cfg, g, o, p)
        return p, o, loss

    losses = []
    for s in range(steps):
        if s == steps // 3:
            _, masks = jadmm.finalize(params, specs)
            opt = jadamw.init(params)
        params, opt, loss = step(params, opt,
                                 masks if masks is not None else none_masks)
        losses.append(float(loss))
    return losses, masks


def test_masked_training_matches_reference():
    from repro.data.pipeline import sequence_dataset
    x, y = sequence_dataset(n=TRAIN_N, seq=S, vocab=VOCAB, classes=CLASSES)
    params = jgru.gru_init(jax.random.PRNGKey(0), VOCAB, D, LAYERS, CLASSES)
    tparams = from_jax_gru(_np(params), _cfgs()[1], "cpu")
    want, jmasks = _reference_train(params, jnp.asarray(x), jnp.asarray(y),
                                    TRAIN_STEPS)
    _, tmasks, got = tex.train(tparams, torch.from_numpy(x),
                               torch.from_numpy(y), TRAIN_STEPS,
                               log=lambda *a: None)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    jm = [m for m in jax.tree_util.tree_leaves(jmasks)]
    tm = [m for m in leaves(tmasks) if m is not None]
    assert len(tm) == len(jm) == 6 * LAYERS + 1
    for g, w in zip(tm, jm):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

