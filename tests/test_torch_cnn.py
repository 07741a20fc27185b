"""Port vs reference, the paper's CNN path (``examples/cnn_im2col.py``):
``im2col`` from ``F.unfold`` against ``conv_general_dilated_patches``, the
conv as a dense GEMM and as a packed BCR GEMM (the port's ``bcr_matmul``
against the reference's ``bcr_spmm_ref``), the whole small CNN, the
synthetic images, the im2col skip count, and masked training steps. Inputs
come from numpy with a fixed seed.

Tolerances: ``im2col`` exact (both copy the same values into the same
order); the images exact (the same numpy draws); GEMM and CNN outputs
within 1e-5 × max(1, |want|) at fp32 (the same products summed in another
order); training losses within 1e-4 relative per step (Adam's normalised
step amplifies that noise)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import bcr as jbcr  # noqa: E402
from repro.core import bcrc as jbcrc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.core import bcr as tbcr  # noqa: E402
from repro_torch.core import bcrc as tbcrc  # noqa: E402
from repro_torch.examples import cnn_im2col as tex  # noqa: E402
from repro_torch.kernels.ops import bcr_matmul  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5


def _jim2col(x, kh, kw):
    """The reference example's ``im2col`` (NHWC, SAME, stride 1)."""
    b, h, w, c = x.shape
    patches = jax.lax.conv_general_dilated_patches(
        x, (kh, kw), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return patches.reshape(b * h * w, kh * kw * c)


def _jconv_as_gemm(x, w_flat, kh, kw, out_c):
    b, h, w, c = x.shape
    return (_jim2col(x, kh, kw) @ w_flat.T).reshape(b, h, w, out_c)


def _jcnn_apply(params, x):
    h = jax.nn.relu(_jconv_as_gemm(x, params["conv1"], 3, 3, 16))
    h = jax.nn.relu(_jconv_as_gemm(h, params["conv2"], 3, 3, 32))
    return h.reshape(h.shape[0], -1) @ params["head"].T


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * scale)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"conv1": (rng.normal(size=(16, 9)) * 0.2).astype(np.float32),
            "conv2": (rng.normal(size=(32, 144)) * 0.1).astype(np.float32),
            "head": (rng.normal(size=(8, 2048)) * 0.02).astype(np.float32)}


@pytest.mark.parametrize("kh,kw", [(1, 1), (3, 3), (5, 5), (3, 5)])
@pytest.mark.parametrize("c", [1, 3, 16])
def test_im2col_matches_conv_patches(kh, kw, c):
    x = np.random.default_rng(1).normal(size=(2, 8, 6, c)).astype(np.float32)
    got = tex.im2col(torch.from_numpy(x), kh, kw)
    want = np.asarray(_jim2col(jnp.asarray(x), kh, kw))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv_as_gemm_matches_reference():
    x = np.random.default_rng(2).normal(size=(3, 8, 8, 16)).astype(
        np.float32)
    w = _params()["conv2"]
    _close(tex.conv_as_gemm(torch.from_numpy(x), torch.from_numpy(w), 3, 3,
                            32),
           _jconv_as_gemm(jnp.asarray(x), jnp.asarray(w), 3, 3, 32))


@pytest.mark.parametrize("shape,block,keep", [
    ((32, 144), (8, 16), 0.25),        # the example's conv2
    ((64, 576), (8, 16), 0.25),        # a 3x3x64 -> 64 conv
])
def test_packed_conv_gemm_matches_reference(shape, block, keep):
    """The packed conv GEMM (the port's ``bcr_matmul`` on the port's pack,
    and through ``conv_as_gemm``) against the reference's ``bcr_spmm_ref``
    on its own pack of the same weight; the index planes are equal."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=shape).astype(np.float32)
    cin = shape[1] // 9
    x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
    jp = jbcrc.tbcrc_pack(jnp.asarray(w), jbcr.BCRSpec(
        block_shape=block, keep_frac=keep, align=1))
    tp = tbcrc.tbcrc_pack(torch.from_numpy(w), tbcr.BCRSpec(
        block_shape=block, keep_frac=keep, align=1))
    np.testing.assert_array_equal(tp.row_idx.numpy(), np.asarray(jp.row_idx))
    np.testing.assert_array_equal(tp.col_idx.numpy(), np.asarray(jp.col_idx))
    cols = _jim2col(jnp.asarray(x), 3, 3)
    want = jref.bcr_spmm_ref(cols, jp)
    got = bcr_matmul(tex.im2col(torch.from_numpy(x), 3, 3), tp)
    _close(got, want)
    _close(tex.conv_as_gemm(torch.from_numpy(x), tp, 3, 3, shape[0]),
           np.asarray(want).reshape(2, 8, 8, shape[0]))


def test_cnn_apply_matches_reference():
    p = _params()
    x, _ = tex.make_images(16, 8)
    _close(tex.cnn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x)),
           _jcnn_apply({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x)))


def test_make_images_is_the_reference_data():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "cnn_im2col.py"
    spec = importlib.util.spec_from_file_location("ref_cnn_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for got, want in zip(tex.make_images(50, 8, seed=4),
                         mod.make_images(50, 8, seed=4)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_im2col_skip_count_matches_reference():
    w = _params(5)["conv2"]
    tspec = tex.spec_for(torch.from_numpy(w))
    jspec = jbcr.BCRSpec(block_shape=tspec.block_shape, keep_frac=0.25,
                         align=1)
    got = int((tbcr.bcr_mask(torch.from_numpy(w), tspec).sum(0) == 0).sum())
    want = int((np.asarray(jbcr.bcr_mask(jnp.asarray(w), jspec)).sum(0)
                == 0).sum())
    assert got == want
    assert tspec.block_shape == (8, 16)


def test_masked_training_matches_reference():
    """The example's recipe for 9 steps (masks frozen at step 3) on 64
    images, against the same loop written with the reference's AdamW and
    BCR masks."""
    steps = 9
    x, y = tex.make_images(64, 8)
    p = _params(6)
    opt_cfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps,
                                 weight_decay=0.0)
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    opt = jadamw.init(jparams)

    @jax.jit
    def step(q, o, masks):
        def loss(q):
            q = {k: v * masks[k] if k in masks else v for k, v in q.items()}
            logits = _jcnn_apply(q, jnp.asarray(x))
            return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)),
                                                        jnp.asarray(y)])
        val, g = jax.value_and_grad(loss)(q)
        q, o, _ = jadamw.update(opt_cfg, g, o, q)
        return q, o, val

    want, masks = [], {}
    for s in range(steps):
        if s == steps // 3:
            masks = {k: jbcr.bcr_mask(v, jbcr.BCRSpec(
                block_shape=jbcr.choose_block_shape(v.shape, (8, 16)),
                keep_frac=0.25, align=1))
                for k, v in jparams.items() if k.startswith("conv")}
        jparams, opt, val = step(jparams, opt, masks)
        want.append(float(val))
    _, tmasks, got = tex.train({k: torch.from_numpy(v.copy())
                                for k, v in p.items()},
                               torch.from_numpy(x), torch.from_numpy(y),
                               steps, log=lambda *a: None)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for k in ("conv1", "conv2"):
        np.testing.assert_array_equal(tmasks[k].numpy(),
                                      np.asarray(masks[k]))
