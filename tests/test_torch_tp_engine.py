"""The port's tensor-parallel engine on gloo CPU ranks (``serving/tp.py``),
held to the reference's bar (``tests/test_sharded_serving.py``, its SETUP
config: llama3.2-3b SMOKE with ``num_kv_heads=4``, fp32):

* greedy tokens at mesh 2 and mesh 4 equal the port's mesh 1 bit for bit,
  and the reference's single-device engine's (converted params, the rule
  of ``tests/test_torch_serving.py``), for the dense, packed, prefix-cache
  and int8-KV variants; ``kv_bytes_read_device · tp == kv_bytes_read``;
* after a mixed admit/cancel/preempt sweep at mesh 2, conservation and the
  pool's consistency hold;
* the 200-step chaos soak at mesh 2 with ``shard_skew`` on a ``FakeClock``
  leaves one terminal status a rid, no leaked page, and survivors equal
  to the fault-free run;

plus ``hierarchical_psum`` (pod 2 × data 2: exact, and int8 within the
reference's 2%) and ``ring_allgather_kv``'s order on 4 gloo ranks. One
model group is started per world size (mesh 2 serves the sweep, the soak
and every mesh-2 variant) and every group is joined with a timeout; each
rendezvous goes through a file under ``tmp_path``, so parallel test
workers never share a port."""

import dataclasses
from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch.serve import build_params as jbuild_params  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (EngineConfig, FakeClock,  # noqa: E402
                                 FaultInjector, InferenceEngine)
from repro_torch.serving.tp import make_model_group  # noqa: E402

import torch_tp_ranks  # noqa: E402

torch.set_num_threads(2)

JOIN_S = 60

BASE = dict(num_kv_heads=4, attn_impl="dense", dtype="float32",
            cache_dtype="float32")
VARIANTS = {
    "dense": ({}, {}),
    "packed": (dict(bcr_keep_frac=0.5, bcr_block=(8, 8)), {}),
    "prefix": ({}, {"prefix_cache": True}),
    "int8": ({}, {"kv_dtype": "int8"}),
}
EC = dict(n_slots=4, capacity=64, page_size=4, kv_pages=40)


def _cfgs(over):
    return (dataclasses.replace(jcfgs.get_smoke_config("llama3.2-3b"),
                                **BASE, **over),
            dataclasses.replace(tcfgs.get_smoke_config("llama3.2-3b"),
                                **BASE, **over))


def _prompts(vocab, ns, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).tolist() for n in ns]


def _traffic(vocab):
    """The reference's six prompts, then the longest again and a prefix
    of it, so the prefix cache adopts pages (and copies a shared partial
    page) on every rank."""
    ps = _prompts(vocab, (5, 9, 3, 12, 7, 4))
    return ps + [ps[3], ps[3][:10]]


class _Groups:
    """One model group at a time in this process (one default process
    group): a new world size closes the last group first."""

    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.group = None

    def get(self, tp):
        if self.group is not None and self.group.tp == tp:
            return self.group
        self.close()
        path = self.tmp.mktemp(f"tp{tp}") / "rendezvous"
        self.group = make_model_group(tp, ["cpu"] * tp, timeout_s=120,
                                      init_method=f"file://{path}")
        return self.group

    def close(self):
        if self.group is not None:
            procs = list(self.group._procs)
            self.group.close(timeout=JOIN_S)
            assert not any(p.is_alive() for p in procs), "a rank never ended"
            self.group = None


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = _Groups(tmp_path_factory)
    yield g
    g.close()


@pytest.fixture(scope="module")
def ref_runs():
    """Per variant: the reference's single-device tokens, its params
    converted, and the port's mesh-1 tokens and KV counters."""
    out = {}
    for name, (over, eck) in VARIANTS.items():
        jcfg, tcfg = _cfgs(over)
        jparams = jbuild_params(jcfg, log=lambda *a, **k: None, decode_m=4)
        jeng = JInferenceEngine(jcfg, jparams, JEngineConfig(**EC, **eck))
        prompts = _traffic(jcfg.vocab_size)
        want = [list(map(int, r)) for r in jeng.generate(
            prompts, max_new_tokens=12)]
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, jeng.params), tcfg,
            device="cpu")
        eng = InferenceEngine(tcfg, params, EngineConfig(**EC, **eck),
                              device="cpu")
        got = eng.generate(prompts, max_new_tokens=12)
        st = eng.stats_snapshot()
        out[name] = dict(cfg=tcfg, params=params, eck=eck, prompts=prompts,
                         ref=want, mesh1=got,
                         kv=(st["kv_bytes_read"], st["kv_bytes_read_device"]))
    return out


def _engine(groups, cfg, params, tp, clock=None, **eck):
    ec = EngineConfig(**EC, mesh_model=tp, mesh_devices=("cpu",) * tp, **eck)
    return InferenceEngine(cfg, params, ec, device="cpu", clock=clock,
                           group=groups.get(tp))


def test_sharded_pool_invariants_after_mixed_sweep(groups, ref_runs):
    """100 steps of mixed admit/cancel/preempt traffic against a mesh-2
    engine, then conservation and page-refcount consistency on the
    head-parallel pool."""
    run = ref_runs["dense"]
    cfg = run["cfg"]
    eng = _engine(groups, cfg, run["params"], 2, preempt_after_stalls=2,
                  max_waiting=6)
    rng = np.random.default_rng(11)
    rids = []
    for step in range(100):
        if step % 2 == 0 and len(rids) < 30:
            rids.append(eng.submit(
                rng.integers(0, cfg.vocab_size,
                             (int(rng.integers(3, 14)),)).tolist(),
                max_new_tokens=int(rng.integers(4, 12))))
        if step % 7 == 3 and rids:
            eng.cancel(int(rng.choice(rids)))
        eng.step()
    for _ in range(300):
        if not eng.sched.has_work():
            break
        eng.step()
    assert not eng.sched.has_work()
    eng.check_conservation()
    eng.pool.check_consistency()
    assert len(eng.sched.finished) == len(rids)
    assert eng.pool.idle_pages() == eng.pool.n_pages - 1
    assert any(r.status == "FINISHED" for r in eng.sched.finished)
    eng.close()


def test_chaos_soak_mesh2_with_shard_skew(groups, ref_runs):
    """The seeded 200-step chaos soak on the mesh-2 engine, ``shard_skew``
    in the mix: one terminal status per rid, no leaked page, FINISHED
    requests equal to the fault-free run (a slow rank is not a wrong
    one)."""
    run = ref_runs["dense"]
    cfg, params = run["cfg"], run["params"]
    n_req, gen = 16, 8
    ps = _prompts(cfg.vocab_size, [int(x) for x in np.random.default_rng(
        5).integers(3, 14, n_req)])
    ref_eng = _engine(groups, cfg, params, 2)
    ref = ref_eng.generate(ps, max_new_tokens=gen)
    ref_eng.check_conservation()
    ref_eng.close()

    clk = FakeClock()
    faults = FaultInjector(seed=13, sleep=clk.sleep).random_schedule(
        200, {"shard_skew": 0.08, "cancel": 0.03, "nan_logits": 0.02,
              "page_alloc": 0.05, "slow_step": 0.02}, slow_s=0.3)
    eng = _engine(groups, cfg, params, 2, clock=clk, fault_injector=faults,
                  preempt_after_stalls=2, max_waiting=8)
    rids, submitted = [], 0
    for step in range(200):
        if step % 3 == 0 and submitted < n_req:
            rids.append(eng.submit(ps[submitted], max_new_tokens=gen))
            submitted += 1
        if eng.sched.has_work():
            eng.step()
        clk.advance(0.01)
    for _ in range(500):
        if not eng.sched.has_work():
            break
        eng.step()
        clk.advance(0.01)
    eng.check_conservation()
    finished = eng.sched.finished
    assert Counter(r.rid for r in finished) == Counter(rids)
    assert any(r.status == "FINISHED" for r in finished)
    assert all(list(map(int, r.generated)) == ref[rids.index(r.rid)]
               for r in finished if r.status == "FINISHED")
    skews = [d for _, k, d in faults.fired if k == "shard_skew"]
    assert skews and all(0 <= int(d) < 2 for d in skews)
    eng.close()


def test_speculative_and_int8_weights_at_mesh_2(groups, ref_runs):
    """TP composes with speculative decoding (a 2-layer model drafter on
    rank 0, unsharded, as the reference's drafter runs outside its mesh)
    and int8 tiles: the tokens of mesh 2 equal mesh 1's."""
    from repro_torch.launch.serve import build_draft
    run = ref_runs["packed"]
    cfg, params = run["cfg"], run["params"]
    draft_cfg, draft_params = build_draft(cfg, device="cpu",
                                          log=lambda *a: None)
    eck = dict(spec_k=2, draft_cfg=draft_cfg, weight_dtype="int8")
    want = InferenceEngine(cfg, params, EngineConfig(**EC, **eck),
                           device="cpu", draft_params=draft_params
                           ).generate(run["prompts"], max_new_tokens=8)
    ec = EngineConfig(**EC, mesh_model=2, mesh_devices=("cpu",) * 2, **eck)
    eng = InferenceEngine(cfg, params, ec, device="cpu",
                          draft_params=draft_params, group=groups.get(2))
    assert eng.generate(run["prompts"], max_new_tokens=8) == want
    assert eng.stats["spec_steps"] > 0
    eng.check_conservation()
    eng.close()


@pytest.mark.parametrize("tp", [2, 4])
def test_mesh_equivalence_bit_identical(groups, ref_runs, tp):
    """Greedy tokens at mesh ``tp`` equal the port's mesh 1 and the
    reference's single device, token for token, for every variant; the
    per-rank KV traffic is the aggregate over the mesh."""
    for name, run in ref_runs.items():
        eng = _engine(groups, run["cfg"], run["params"], tp, **run["eck"])
        got = eng.generate(run["prompts"], max_new_tokens=12)
        assert got == run["mesh1"], f"{name}: mesh-{tp} tokens diverged"
        assert got == run["ref"], f"{name}: not the reference's tokens"
        eng.check_conservation()
        st = eng.stats_snapshot()
        assert st["kv_bytes_read_device"] * tp == st["kv_bytes_read"]
        assert st["kv_bytes_read"] == run["kv"][0], name
        if name == "prefix":
            assert st["prefix_hit_tokens"] > 0
        eng.close()
    for name, run in ref_runs.items():
        assert run["kv"][0] == run["kv"][1], name    # mesh 1: equal


def test_hierarchical_psum_and_ring_on_four_ranks(groups):
    """On the mesh-4 group's ranks (``ModelGroup.call``)."""
    got = dict(enumerate(groups.get(4).call(torch_tp_ranks.collectives)))
    assert [res["rank"] for res in got.values()] == [0, 1, 2, 3]
    g = [torch_tp_ranks.grads(r) for r in range(4)]
    # data (ranks 0+1, 2+3) first, then pod: the numpy sum in that order
    want = (g[0] + g[1]) + (g[2] + g[3])
    for rank, res in got.items():
        np.testing.assert_array_equal(res["exact"], want)
        # one flat ring over 4 ranks adds in its own order
        np.testing.assert_allclose(res["flat"], want, rtol=1e-6, atol=1e-6)
        exact4 = 4 * g[0]
        rel = (np.linalg.norm(res["int8"] - exact4) / np.linalg.norm(exact4))
        assert rel < 0.02, rel
        d, m = res["coords"]
        assert res["shape"] == [2, 2] and rank == 2 * d + m
        peer = 2 * d + (1 - m)
        assert res["ring"] == [rank, rank, peer, peer]
