"""The port's GPipe schedule (``runtime/pipeline_parallel.py``) against the
reference's: the reference's own case (``tests/test_pipeline_parallel.py``:
L 8, d 16, 6 microbatches of 4, tanh layers) on 4 and 2 gloo ranks on the
CPU, each rank a process of its own (``tests/torch_pipeline_ranks.py``)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.pipeline_parallel import \
    pipeline_bubble_fraction as ref_bubble
from repro_torch.runtime.pipeline_parallel import (pipeline_bubble_fraction,
                                                   split_stages)
from repro_torch.serving.tp import make_model_group

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_pipeline_ranks  # noqa: E402

L, D, N_MICRO, MB = 8, 16, 6, 4


def _case():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return ws, x


@pytest.mark.parametrize("n_stages", [4, 2])
def test_pipeline_matches_sequential(n_stages, tmp_path):
    ws, x = _case()
    # the reference's sequential result (its test's `ref`)
    ref = jnp.asarray(x)
    for i in range(L):
        ref = jnp.tanh(ref @ jnp.asarray(ws[i]))
    ref = np.asarray(ref)
    # the port's own sequential result: the same stage functions, in turn
    stages = split_stages([torch.as_tensor(w) for w in ws], n_stages)
    seq = []
    for m in range(N_MICRO):
        xb = torch.as_tensor(x[m])
        for p in stages:
            xb = torch_pipeline_ranks.tanh_stage(p, xb)
        seq.append(xb)
    seq = torch.stack(seq).numpy()

    group = make_model_group(n_stages, ["cpu"] * n_stages, timeout_s=120,
                             init_method=f"file://{tmp_path / 'rdv'}")
    try:
        got = group.call(torch_pipeline_ranks.pipeline, n_stages, ws, x)
    finally:
        group.close(timeout=60)
    assert [g["rank"] for g in got] == list(range(n_stages))
    for g in got:
        assert g["layers"] == L // n_stages
        assert g["steps"] == N_MICRO + n_stages - 1
        assert g["launched"] == N_MICRO          # no stage computes idle
        np.testing.assert_array_equal(g["out"], seq)   # bit-equal
        assert float(np.max(np.abs(g["out"] - ref))) < 1e-5
    # every stage but the last hands each microbatch on once
    per = MB * D * 4
    assert [g["bytes_sent"] for g in got] == \
        [N_MICRO * per] * (n_stages - 1) + [0]


def test_split_stages_stacked_and_list():
    ws, _ = _case()
    staged = split_stages({"w": torch.as_tensor(ws)}, 4)
    assert tuple(staged["w"].shape) == (4, 2, D, D)
    torch.testing.assert_close(staged["w"][1, 0], torch.as_tensor(ws[2]),
                               rtol=0, atol=0)
    groups = split_stages(list(range(L)), 2)
    assert groups == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(AssertionError):
        split_stages(list(range(L)), 3)


@pytest.mark.parametrize("n_micro,n_stages", [(1, 4), (16, 4), (64, 2),
                                              (6, 4), (4, 2)])
def test_bubble_fraction(n_micro, n_stages):
    got = pipeline_bubble_fraction(n_micro, n_stages)
    assert got == ref_bubble(n_micro, n_stages)
    # the reference test's bounds
    assert pipeline_bubble_fraction(1, 4) == pytest.approx(0.75)
    assert pipeline_bubble_fraction(16, 4) < 0.16
    assert pipeline_bubble_fraction(64, 2) < 0.02
