"""Checkpointing: atomic, async, resumable (the reference's
``checkpoint/checkpointing.py``).

Layout:  <dir>/step_<N>/shard_<proc>.npz  +  <dir>/step_<N>/COMMITTED
Writes go to ``step_<N>.tmp`` and are published with one ``os.replace``
(atomic on POSIX), then the COMMITTED marker is dropped — a reader never
sees a torn checkpoint, and a crashed writer leaves only a ``.tmp`` to GC.

``save_async`` copies every tensor to host memory at once (the train loop
then updates its tensors in place), then serializes on a background thread
so the loop does not wait on disk. ``restore`` reads into the structure of
a ``like`` tree, casting each leaf to ``like``'s dtype and device.

An npz entry is named ``<index>::<path>`` (the leaf's position and its
:mod:`repro_torch.tree` path); bf16 leaves are stored as their raw 16 bits
with a ``%bf16`` tag, since numpy has no bf16.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

PyTree = Any

_SEP = "::"
_BF16_TAG = "%bf16"


def _host_arrays(tree: PyTree) -> Dict[str, np.ndarray]:
    """Host copies of every non-None leaf, keyed ``<index>::<path>``."""
    out = {}
    present = [(p, leaf) for p, leaf in flatten(tree) if leaf is not None]
    for i, (path, leaf) in enumerate(present):
        key = f"{i:05d}{_SEP}{path}"
        t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            key += _BF16_TAG
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        out[key] = arr
    return out


def _from_host(key: str, arr: np.ndarray) -> torch.Tensor:
    if key.endswith(_BF16_TAG):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    process_index: int = 0

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "COMMITTED")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- write ------------------------------------------------------------
    def _write(self, step: int, host_arrays: Dict[str, np.ndarray]) -> None:
        with self._lock:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"shard_{self.process_index}.npz"),
                     **host_arrays)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            with open(os.path.join(final, "COMMITTED"), "w") as f:
                f.write("ok\n")
            self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, tree: PyTree) -> None:
        self._write(step, _host_arrays(tree))

    def save_async(self, step: int, tree: PyTree) -> None:
        """Snapshot to host now; write on a background thread."""
        self.wait()  # one in-flight write at a time
        host = _host_arrays(tree)

        def run():
            try:
                self._write(step, host)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- read -------------------------------------------------------------
    def restore(self, step: int, like: PyTree) -> PyTree:
        """Restore into the structure of ``like``: each leaf is cast to
        ``like``'s dtype, placed on its device and keeps its
        ``requires_grad`` (npz may widen)."""
        path = os.path.join(self._step_dir(step),
                            f"shard_{self.process_index}.npz")
        with np.load(path) as z:
            keys = sorted(z.files, key=lambda k: int(k.split(_SEP)[0]))
            stored = [_from_host(k, z[k]) for k in keys]
        flat = flatten(like)
        want = [leaf for _, leaf in flat if leaf is not None]
        if len(stored) != len(want):
            raise ValueError(f"checkpoint step {step} holds {len(stored)} "
                             f"leaves, the tree to restore has {len(want)}")
        it = iter(stored)
        out = []
        for _, leaf in flat:
            if leaf is None:
                out.append(None)
                continue
            ref = torch.as_tensor(leaf)
            t = next(it).to(device=ref.device, dtype=ref.dtype)
            if t.shape != ref.shape:
                raise ValueError(f"leaf shape {tuple(t.shape)} != "
                                 f"{tuple(ref.shape)}")
            out.append(t.requires_grad_(ref.requires_grad)
                       if ref.is_floating_point() else t)
        return unflatten(like, out)
