"""Port vs reference, GRIM §4.2 matrix reordering: the permutation, the
row groups, the divergence statistic, and the two permutation helpers, on
BCR masks and random masks made from numpy with a fixed seed.

Tolerances: none. Both packages run the same numpy arithmetic on the same
masks, so permutations and groups are identical and the statistic equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bcr as jbcr  # noqa: E402
from repro.core import reorder as jreorder  # noqa: E402

from repro_torch.core import reorder as treorder  # noqa: E402


def _bcr_mask(shape, block, keep, align, balanced=True):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    spec = jbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align,
                        balanced=balanced)
    return np.asarray(jbcr.bcr_mask(jnp.asarray(w), spec))


MASKS = {
    "bcr_gru": lambda: _bcr_mask((96, 96), (8, 8), 0.1, 2),
    "bcr_conv2": lambda: _bcr_mask((32, 144), (8, 16), 0.25, 1),
    "bcr_unbalanced": lambda: _bcr_mask((64, 96), (16, 32), 0.25, 1,
                                        balanced=False),
    "random": lambda: (np.random.default_rng(1).random((50, 30)) < 0.3),
    "ragged_nnz": lambda: np.tril(np.ones((20, 20), np.float32)),
    "empty": lambda: np.zeros((9, 7), np.float32),
}


@pytest.fixture(params=sorted(MASKS))
def mask(request):
    return MASKS[request.param]()


def test_permutation_and_groups_match_reference(mask):
    got = treorder.row_reorder_permutation(mask)
    want = jreorder.row_reorder_permutation(mask)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert treorder.group_rows(mask, got) == jreorder.group_rows(mask, want)


@pytest.mark.parametrize("n_threads", [1, 4, 8, 32])
def test_divergence_stat_matches_reference(mask, n_threads):
    perm = treorder.row_reorder_permutation(mask)
    for m in (mask, treorder.apply_row_reorder(mask, perm)):
        assert treorder.divergence_stat(m, n_threads) \
            == jreorder.divergence_stat(m, n_threads)


def test_reorder_groups_identical_rows_and_lowers_divergence(mask):
    """After the permutation, rows of one group share their pattern, the
    groups cover every row once, and the divergence proxy does not rise."""
    perm = treorder.row_reorder_permutation(mask)
    assert sorted(perm.tolist()) == list(range(mask.shape[0]))
    groups = treorder.group_rows(mask, perm)
    assert groups[0][0] == 0 and groups[-1][1] == len(perm)
    bools = np.asarray(mask) != 0
    for lo, hi in groups:
        for r in perm[lo:hi]:
            np.testing.assert_array_equal(bools[r], bools[perm[lo]])
    reordered = treorder.apply_row_reorder(mask, perm)
    assert treorder.divergence_stat(reordered) \
        <= treorder.divergence_stat(mask) + 1e-12


def test_fold_permutation_into_next_matches_reference():
    """Layer L's rows permuted and layer L+1's columns folded give the same
    two-layer product as the unpermuted pair."""
    rng = np.random.default_rng(2)
    w1 = rng.normal(size=(24, 16)).astype(np.float32)
    w2 = rng.normal(size=(8, 24)).astype(np.float32)
    x = rng.normal(size=(16,)).astype(np.float32)
    perm = treorder.row_reorder_permutation(w1 > 0.5)
    got1 = treorder.apply_row_reorder(w1, perm)
    got2 = treorder.fold_permutation_into_next(perm, w2)
    np.testing.assert_array_equal(got1, jreorder.apply_row_reorder(w1, perm))
    np.testing.assert_array_equal(
        got2, jreorder.fold_permutation_into_next(perm, w2))
    np.testing.assert_allclose(got2 @ (got1 @ x), w2 @ (w1 @ x), rtol=1e-5,
                               atol=1e-5)
