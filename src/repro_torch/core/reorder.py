"""Matrix reordering (GRIM §4.2), in numpy: a copy of the reference's
``core/reorder.py``.

Groups rows with identical or similar surviving-column patterns so that (a)
BCRC can deduplicate column index sets and (b) execution units see uniform
work. On the card balanced BCR already gives every block the same kept
counts, so a CTA's work does not depend on the pattern; reordering serves
BCRC's deduplication and locality, and a row permutation can be folded into
the next layer's columns at pack time (:func:`fold_permutation_into_next`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def row_reorder_permutation(mask: np.ndarray) -> np.ndarray:
    """Permutation grouping rows by (nnz, column-pattern), paper Fig. 7.

    Returns ``perm`` such that ``mask[perm]`` has identical-pattern rows
    adjacent, sorted by ascending nnz then pattern bytes.
    """
    mask = np.asarray(mask) != 0
    keys = [(int(row.sum()), row.tobytes()) for row in mask]
    return np.asarray(sorted(range(mask.shape[0]), key=lambda r: keys[r]),
                      dtype=np.int32)


def group_rows(mask: np.ndarray, perm: np.ndarray) -> List[Tuple[int, int]]:
    """(start, end) ranges of identical-pattern row groups after reorder."""
    mask = np.asarray(mask) != 0
    groups, start = [], 0
    prev = None
    for i, r in enumerate(perm):
        key = mask[r].tobytes()
        if key != prev and i != 0:
            groups.append((start, i))
            start = i
        prev = key
    groups.append((start, len(perm)))
    return groups


def divergence_stat(mask: np.ndarray, n_threads: int = 8) -> float:
    """Thread-divergence proxy matching the paper's execution model: rows
    are issued in waves of ``n_threads``; every wave waits for its slowest
    row. Returns mean over waves of (max nnz / mean nnz) within the wave —
    1.0 = no divergence. Reorder makes adjacent rows similar, driving this
    toward 1 (paper Fig. 14).
    """
    mask = np.asarray(mask) != 0
    nnz = mask.sum(axis=1).astype(np.float64)
    ratios = []
    for start in range(0, len(nnz), n_threads):
        wave = nnz[start:start + n_threads]
        m = wave.mean()
        if m > 0:
            ratios.append(wave.max() / m)
    return float(np.mean(ratios)) if ratios else 1.0


def apply_row_reorder(w: np.ndarray, perm: np.ndarray) -> np.ndarray:
    return np.asarray(w)[perm]


def fold_permutation_into_next(perm: np.ndarray,
                               w_next: np.ndarray) -> np.ndarray:
    """Fold a row permutation of layer L into the columns of layer L+1.

    Instead of permuting activations at run time (an extra pass over device
    memory), the permutation is folded into the next layer's weight columns
    at pack time, so reordering costs nothing at inference.
    """
    return np.asarray(w_next)[:, perm]
