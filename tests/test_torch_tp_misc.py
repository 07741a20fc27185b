"""The host and single-tensor pieces that come with tensor parallelism, held
to the reference on the CPU: ``optim/grad_compress.py`` (the int8 codec,
top-k, error feedback, wire bytes), ``runtime/fault_tolerance.py``'s
heartbeat monitor and elastic planner, ``maybe_gather`` without a group,
and the engine's mesh-1 identity ``kv_bytes_read == kv_bytes_read_device``
on every pool."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import grad_compress as jgc  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch.serve import build_params  # noqa: E402
from repro_torch.optim import grad_compress as tgc  # noqa: E402
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402
from repro_torch.runtime.collectives import (axis_size,  # noqa: E402
                                             maybe_gather)
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402

torch.set_num_threads(2)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32) * 1e-3,
                  rng.standard_normal((3, 4, 2)).astype(np.float32) * 50]}


def _t(tree):
    return jax.tree_util.tree_map(torch.as_tensor, tree)


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves_np(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves_np(v)]
    return [np.asarray(tree)]


def test_quantize_int8_matches_the_reference():
    for x in _leaves_np(_grads()):
        q, s = tgc.quantize_int8(torch.as_tensor(x))
        jq, js = jgc.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8
        np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
        np.testing.assert_allclose(tgc.dequantize_int8(q, s).numpy(),
                                   np.asarray(jgc.dequantize_int8(jq, js)),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("frac", [0.05, 0.3, 1e-6])
def test_topk_sparsify_matches_the_reference(frac):
    for x in _leaves_np(_grads(1)):
        got = tgc.topk_sparsify(torch.as_tensor(x), frac).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jgc.topk_sparsify(jnp.asarray(x), frac)))


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_error_feedback_matches_the_reference(codec):
    """Three rounds of ``ef_compress`` from ``ef_init``: the compressed
    gradients and the residuals agree each round."""
    tstate = tgc.ef_init(_t(_grads()))
    jstate = jgc.ef_init(_grads())
    for r in range(3):
        g = _grads(10 + r)
        tg, tstate = tgc.ef_compress(_t(g), tstate, codec=codec,
                                     topk_frac=0.1)
        jg, jstate = jgc.ef_compress(g, jstate, codec=codec, topk_frac=0.1)
        for a, b in zip(_leaves_np(jax.tree_util.tree_map(
                lambda t: t.numpy(), tg)), _leaves_np(jg)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        for a, b in zip(_leaves_np(jax.tree_util.tree_map(
                lambda t: t.numpy(), tstate.residual)),
                _leaves_np(jstate.residual)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tgc.ef_compress(_t(_grads()), tstate, codec="fp4")


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_compressed_bytes_matches_the_reference(codec):
    assert tgc.compressed_bytes(_t(_grads()), codec, 0.1) == \
        jgc.compressed_bytes(_grads(), codec, 0.1)
    with pytest.raises(ValueError):
        tgc.compressed_bytes(_t(_grads()), "fp4")


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_heartbeat_monitor_and_elastic_planner_match_the_reference():
    tclk, jclk = _Clock(), _Clock()
    tmon = tft.HeartbeatMonitor(timeout_s=10.0, clock=tclk)
    jmon = jft.HeartbeatMonitor(timeout_s=10.0, clock=jclk)
    for t, host in ((0.0, 0), (1.0, 1), (2.0, 2), (5.0, 3), (13.0, 1),
                    (14.5, 3)):
        tclk.now = jclk.now = t
        tmon.beat(host)
        jmon.beat(host)
        assert tmon.alive_hosts() == jmon.alive_hosts()
        assert tmon.dead_hosts() == jmon.dead_hosts()
    assert tmon.dead_hosts(t=30.0) == jmon.dead_hosts(t=30.0)
    assert tmon.alive_hosts(t=11.0) == jmon.alive_hosts(t=11.0)
    for last in (None, 1200):
        assert tft.ElasticPlanner(tmon, chips_per_host=4).replan(last) == \
            jft.ElasticPlanner(jmon, chips_per_host=4).replan(last)


@pytest.mark.parametrize("n", [4, 12, 16, 24, 96, 256, 512, 520, 1024, 2048])
def test_plan_elastic_mesh_matches_the_reference(n):
    for kw in ({}, dict(prefer_model=8, min_model=2, chips_per_pod=64)):
        assert tft.plan_elastic_mesh(n, **kw) == jft.plan_elastic_mesh(n,
                                                                       **kw)
    with pytest.raises(ValueError):
        tft.plan_elastic_mesh(3)


def test_maybe_gather_without_a_group_is_the_identity():
    x = torch.randn(2, 3, 8)
    assert maybe_gather(x, 4, "") is x
    assert axis_size("") == 1
    with pytest.raises(RuntimeError, match="no process group"):
        axis_size("nowhere")


@pytest.mark.parametrize("page_size", [4, 0])
def test_engine_mesh1_kv_bytes_identity(page_size):
    """At mesh 1 the per-device and aggregate KV counters agree exactly,
    on the paged pool and on the capacity-dense one."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-3b"),
                              attn_impl="dense")
    eng = InferenceEngine(cfg, build_params(cfg, log=lambda *a: None,
                                            device="cpu", decode_m=2),
                          EngineConfig(n_slots=2, capacity=32,
                                       page_size=page_size), device="cpu")
    eng.generate([np.arange(5) % cfg.vocab_size,
                  np.arange(8) % cfg.vocab_size], max_new_tokens=4)
    st = eng.stats_snapshot()
    assert st["kv_bytes_read"] > 0
    assert st["kv_bytes_read"] == st["kv_bytes_read_device"]
    assert eng.tp == 1 and eng.group is None
    eng.close()
