"""Data pipeline: a deterministic synthetic LM stream and a memory-mapped
binary token corpus, step-indexed and stateless (the reference's
``data/pipeline.py``).

Determinism contract: ``batch(step)`` is a pure function of (seed, step) —
a restarted job resumes bit-identically from the checkpointed step, with no
loader state to restore. The host batches are the reference's numpy arrays,
bit for bit; ``device_batch`` moves them to a torch device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"          # synthetic | markov | file
    path: Optional[str] = None       # for kind="file": flat uint16 tokens


class TokenSource:
    """batch(step) -> {"tokens", "targets"} as numpy int32 arrays."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.kind == "file":
            if not cfg.path:
                raise ValueError("file source needs a path")
            self._data = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        elif cfg.kind == "markov":
            rng = np.random.default_rng(cfg.seed)
            # a learnable synthetic task: order-1 markov chain over the vocab
            v = cfg.vocab_size
            self._trans = rng.dirichlet(np.ones(min(v, 64)) * 0.1,
                                        size=v).astype(np.float64)
            self._support = rng.integers(0, v, size=(v, min(v, 64)))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        if cfg.kind == "synthetic":
            toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1),
                                dtype=np.int64)
        elif cfg.kind == "markov":
            toks = np.empty((b, s + 1), dtype=np.int64)
            toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
            for t in range(s):
                prev = toks[:, t]
                toks[:, t + 1] = np.array([
                    rng.choice(self._support[p], p=self._trans[p])
                    for p in prev])
        elif cfg.kind == "file":
            n = len(self._data) - (s + 1)
            starts = rng.integers(0, n, size=b)
            toks = np.stack([self._data[st:st + s + 1].astype(np.int64)
                             for st in starts])
        else:
            raise ValueError(cfg.kind)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }

    def device_batch(self, step: int, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
        """Host batch → int32 tensors on ``device``."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.batch(step).items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def classification_dataset(n: int, dim: int, classes: int, seed: int = 0):
    """Separable-but-noisy synthetic classification task."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, dim))
    y = rng.integers(0, classes, size=n)
    x = centers[y] + rng.normal(size=(n, dim)) * 1.2
    return x.astype(np.float32), y.astype(np.int32)


def sequence_dataset(n: int, seq: int, vocab: int, classes: int,
                     seed: int = 0):
    """Synthetic sequence task: label = f(token histogram) with a long-range
    dependency (the first token matters)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, size=(n, seq))
    w = rng.normal(size=(vocab,))
    score = w[x].mean(axis=1) + 0.3 * w[x[:, 0]]
    edges = np.quantile(score, np.linspace(0, 1, classes + 1)[1:-1])
    y = np.digitize(score, edges)
    return x.astype(np.int32), y.astype(np.int32)
