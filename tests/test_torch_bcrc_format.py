"""Port vs reference, GRIM's storage formats: the six-array BCRC format (its
arrays, the round trip, the index bytes), the CSR baseline's bytes, and
``tbcrc_stats``. Inputs come from numpy with a fixed seed.

Tolerances: none. BCRC and CSR are integer bookkeeping over the same numpy
matrix, so every array and byte count must be identical; the round trip is
exact. ``tbcrc_stats`` counts the same packed shapes, so its dict is equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import bcr as jbcr  # noqa: E402
from repro.core import bcrc as jbcrc  # noqa: E402

from repro_torch.core import bcr as tbcr  # noqa: E402
from repro_torch.core import bcrc as tbcrc  # noqa: E402

torch.set_num_threads(2)

ARRAYS = ("reorder", "row_offset", "occurrence", "column_stride",
          "compact_column", "weights")


def _bcr_sparse(shape, block, keep, align, balanced=True, dtype=np.float32):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    spec = jbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align,
                        balanced=balanced)
    return np.asarray(jbcr.bcr_project(jnp.asarray(w), spec)).astype(dtype)


def _random_sparse(shape, density, seed=1):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    return np.where(rng.random(shape) < density, w, 0).astype(np.float32)


MATRICES = {
    # the CNN example's conv2: (8, 16) blocks at keep 0.25
    "bcr_conv2": lambda: _bcr_sparse((32, 144), (8, 16), 0.25, 1),
    # the GRU example's spec: (8, 8) blocks, keep 0.1, granule 2
    "bcr_gru": lambda: _bcr_sparse((96, 96), (8, 8), 0.1, 2),
    "bcr_quickstart": lambda: _bcr_sparse((128, 256), (64, 128), 0.125, 8),
    "bcr_unbalanced": lambda: _bcr_sparse((64, 96), (16, 32), 0.25, 1,
                                          balanced=False),
    "bcr_fp16": lambda: _bcr_sparse((48, 40), (8, 8), 0.25, 2,
                                    dtype=np.float16),
    "random_sparse": lambda: _random_sparse((40, 24), 0.2),
    "dense": lambda: _random_sparse((12, 20), 1.1),
    "with_zero_rows": lambda: np.vstack([
        _random_sparse((10, 16), 0.3), np.zeros((5, 16), np.float32),
        _random_sparse((7, 16), 0.5, seed=2)]),
    "all_zero": lambda: np.zeros((6, 9), np.float32),
}


@pytest.fixture(params=sorted(MATRICES))
def matrix(request):
    return MATRICES[request.param]()


def test_bcrc_arrays_match_reference(matrix):
    got, want = tbcrc.bcrc_pack(matrix), jbcrc.bcrc_pack(matrix)
    assert got.shape == want.shape
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_bcrc_round_trip_and_bytes(matrix):
    packed = tbcrc.bcrc_pack(matrix)
    np.testing.assert_array_equal(tbcrc.bcrc_unpack(packed), matrix)
    np.testing.assert_array_equal(tbcrc.bcrc_unpack(packed),
                                  jbcrc.bcrc_unpack(jbcrc.bcrc_pack(matrix)))
    want = jbcrc.bcrc_pack(matrix)
    for ib in (2, 4):
        assert packed.nbytes_extra(ib) == want.nbytes_extra(ib)
        assert packed.nbytes_weights(ib) == want.nbytes_weights(ib)
        assert tbcrc.csr_extra_bytes(matrix, ib) \
            == jbcrc.csr_extra_bytes(matrix, ib)


def test_bcrc_deduplicates_shared_column_sets():
    """Column-only BCR (row_frac 1: every row of a block row keeps the same
    columns) gives one stored column set per block row, so BCRC's index
    bytes fall far under CSR's."""
    w = np.random.default_rng(4).normal(size=(64, 96)).astype(np.float32)
    spec = jbcr.BCRSpec(block_shape=(16, 32), keep_frac=0.25, col_frac=0.25,
                        row_frac=1.0, align=1)
    w = np.asarray(jbcr.bcr_project(jnp.asarray(w), spec))
    packed = tbcrc.bcrc_pack(w)
    assert len(packed.occurrence) - 1 == 64 // 16
    assert packed.compact_column.size == packed.weights.size // 16
    assert packed.nbytes_extra() < tbcrc.csr_extra_bytes(w) / 2
    np.testing.assert_array_equal(packed.compact_column,
                                  jbcrc.bcrc_pack(w).compact_column)


@pytest.mark.parametrize("shape,block,keep,align", [
    ((32, 144), (8, 16), 0.25, 1), ((96, 96), (8, 8), 0.1, 2),
    ((128, 256), (64, 128), 0.125, 8)])
@pytest.mark.parametrize("weight_bytes", [1, 2, 4])
def test_tbcrc_stats_match_reference(shape, block, keep, align, weight_bytes):
    w = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    jp = jbcrc.tbcrc_pack(jnp.asarray(w), jbcr.BCRSpec(
        block_shape=block, keep_frac=keep, align=align))
    tp = tbcrc.tbcrc_pack(torch.from_numpy(w), tbcr.BCRSpec(
        block_shape=block, keep_frac=keep, align=align))
    assert tbcrc.tbcrc_stats(tp, weight_bytes) \
        == jbcrc.tbcrc_stats(jp, weight_bytes)
