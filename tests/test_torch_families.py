"""Port vs reference, the vlm, ssm and hybrid families (pixtral-12b,
rwkv6-3b, jamba-v0.1-52b SMOKE configs, fp32): ``forward``, ``prefill``
(logits and every layer's cache leaves) and a teacher-forced decode loop,
dense and BCR-packed (keep 0.25, 16 x 16 blocks), and pixtral's
``image_embeds``; then the port on its own: decode against ``forward``,
prefill against token-by-token priming, the engine's tokens against its
naive ``generate`` (rwkv on the capacity-dense pool, jamba on a paged pool
with slot leaves, also under preemption and ``recover()``, pixtral with the
prefix cache), the options the recurrent families refuse, the projections
``pack_params`` fuses, and the pools' seating of recurrent state.

Inputs come from a numpy seed; parameters are the reference's, converted by
``convert.from_jax_params``. The reference runs its BCR kernel as Pallas in
interpret mode.

Tolerance: ``1e-4 x max(1, max |reference|)`` on logits and cache leaves
(fp32; XLA and PyTorch sum in different orders); engine tokens bit for bit.
"""

import dataclasses
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.models.causal_lm import forward as jforward  # noqa: E402
from repro.models.causal_lm import layer_plan as jlayer_plan  # noqa: E402
from repro.models.causal_lm import stack_plan as jstack_plan  # noqa: E402
from repro.serving.kv_slots import seat_prefill as jseat_prefill  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.train import default_prune_filter  # noqa: E402
from repro_torch.launch.serve import (build_params, generate,  # noqa: E402
                                      pack_params)
from repro_torch.models import causal_lm  # noqa: E402
from repro_torch.serving import (EngineConfig, FINISHED,  # noqa: E402
                                 InferenceEngine, OracleDraft)
from repro_torch.serving.kv_slots import (PagedSlotPool,  # noqa: E402
                                          SlotPool, seat_prefill)

torch.set_num_threads(2)
ARCHS = ("pixtral-12b", "rwkv6-3b", "jamba-v0.1-52b")
B, S, STEPS, CAP = 2, 12, 3, 32
PS = 4                       # page size
GEN = 6
# a port leaf name → the reference's (sub-tree, leaf) in one layer's cache
_REF_LEAF = {"k": ("mixer", "k"), "v": ("mixer", "v"), "h": ("mixer", "h"),
             "conv": ("mixer", "conv"), "s": ("mixer", "s"),
             "shift": ("mixer", "shift"), "cm_shift": ("ffn", "shift")}


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


_MODELS = {}


def _model(arch, variant):
    """(jcfg, reference params, tcfg, converted params) of one SMOKE
    config, dense or packed at keep 0.25."""
    key = (arch, variant)
    if key not in _MODELS:
        keep = 0.0 if variant == "dense" else 0.25
        over = dict(bcr_block=(16, 16), cache_dtype="float32",
                    bcr_keep_frac=keep)
        jcfg = dataclasses.replace(jcfgs.get_smoke_config(arch),
                                   kernel_impl="interpret", **over)
        tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch), **over)
        jp = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
        if keep:
            jp = jpack_params(jcfg, jp)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
        _MODELS[key] = (jcfg, jp, tcfg, tp)
    return _MODELS[key]


def _ref_layers(jcfg, jcache):
    """The reference's cache as a per-layer list in execution order (its
    scanned stack unstacked), each layer ``{"mixer": ..., "ffn": ...}``."""
    sp = jstack_plan(jcfg)
    out = list(jcache["prefix"])
    for rep in range(sp.repeats):
        for lc in jcache["stack"]:
            out.append(jax.tree_util.tree_map(lambda a: a[rep], lc))
    return out


def _close_cache(tcache, jcfg, jcache, what, seq=None):
    """Every port leaf against the reference's leaf for the same layer
    (position leaves over their first ``seq`` positions when given)."""
    jl = _ref_layers(jcfg, jcache)
    assert len(jl) == len(tcache)
    for i, (tc, jc) in enumerate(zip(tcache, jl)):
        for key, leaf in tc.items():
            sub, name = _REF_LEAF[key]
            want = np.asarray(jc[sub][name])
            got = leaf.detach().numpy()
            if key in ("k", "v") and seq is not None:
                got, want = got[:, :seq], want[:, :seq]
            _close(got, want, f"{what} layer {i} {key}")


def test_layer_plan_matches_reference():
    for arch in ARCHS:
        for n in (1, 2, 5, 8, 9, 16):
            jcfg = dataclasses.replace(jcfgs.get_config(arch), num_layers=n)
            tcfg = dataclasses.replace(tcfgs.get_config(arch), num_layers=n)
            assert causal_lm.layer_plan(tcfg) == jlayer_plan(jcfg)


@pytest.mark.parametrize("variant", ["dense", "packed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, variant):
    """``forward`` logits; ``prefill`` logits and every layer's leaves
    (attention K/V, recurrent state); then ``STEPS`` teacher-forced decode
    steps on a capacity-dense cache seated from that prefill, each step's
    logits and final state against the reference's."""
    jcfg, jp, tcfg, tp = _model(arch, variant)
    jfns = jmodel_fns(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    feed = rng.integers(0, tcfg.vocab_size,
                        size=(STEPS, B, 1)).astype(np.int32)

    jl = jax.jit(lambda p, t: jforward(jcfg, p, t))(jp, jnp.asarray(toks))
    with torch.no_grad():
        tl = causal_lm.forward(tcfg, tp, torch.as_tensor(toks))
    _close(tl, jl, "forward")

    jl, jpc = jax.jit(jfns.prefill)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tpc = causal_lm.prefill(tcfg, tp, torch.as_tensor(toks))
    _close(tl, jl, "prefill logits")
    _close_cache(tpc, jcfg, jpc, "prefill")

    jcache = jseat_prefill(jfns.init_cache, jpc, B, CAP)
    tcache = seat_prefill(
        lambda b, c, **kw: causal_lm.init_cache(tcfg, b, c, **kw), tpc, B,
        CAP, device="cpu")
    jdecode = jax.jit(jfns.decode_step)
    for i in range(STEPS):
        jl, jcache = jdecode(jp, {"tokens": jnp.asarray(feed[i]),
                                  "cache_len": jnp.full((B,), S + i,
                                                        jnp.int32)}, jcache)
        with torch.no_grad():
            tl, tcache = causal_lm.decode_step(
                tcfg, tp, torch.as_tensor(feed[i]), tcache,
                torch.full((B,), S + i, dtype=torch.int32))
        _close(tl, jl, f"decode step {i}")
    _close_cache(tcache, jcfg, jcache, "after decode", seq=S + STEPS)


@pytest.mark.parametrize("variant", ["dense", "packed"])
def test_image_embeds_match_reference(variant):
    """pixtral: the first ``num_image_tokens`` embeddings replaced by
    ``image_embeds`` in ``forward`` and ``prefill`` (also through
    ``model_fns``), and the replacement changes the logits."""
    from repro_torch.models.api import model_fns
    jcfg, jp, tcfg, tp = _model("pixtral-12b", variant)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    img = rng.normal(size=(B, tcfg.num_image_tokens,
                           tcfg.d_model)).astype(np.float32)
    jl = jforward(jcfg, jp, jnp.asarray(toks), image_embeds=jnp.asarray(img))
    with torch.no_grad():
        tl = causal_lm.forward(tcfg, tp, torch.as_tensor(toks),
                               image_embeds=torch.as_tensor(img))
        plain = causal_lm.forward(tcfg, tp, torch.as_tensor(toks))
    _close(tl, jl, "forward with image_embeds")
    assert float((tl - plain).abs().max()) > 1e-3
    jl, _ = jmodel_fns(jcfg).prefill(jp, {"tokens": jnp.asarray(toks),
                                          "image_embeds": jnp.asarray(img)})
    with torch.no_grad():
        tl, _ = model_fns(tcfg).prefill(tp, {
            "tokens": torch.as_tensor(toks),
            "image_embeds": torch.as_tensor(img)})
    _close(tl, jl, "prefill with image_embeds")


# ---------------------------------------------------------------------------
# The port on its own
# ---------------------------------------------------------------------------


def _cfg(arch, **over):
    """A SMOKE config for the port-only tests: fp32 cache, MoE capacity 8
    (no token dropped, so batch composition cannot move a token)."""
    over = dict(dict(cache_dtype="float32", capacity_factor=8.0,
                     bcr_block=(16, 16)), **over)
    return dataclasses.replace(tcfgs.get_smoke_config(arch), **over)


_BUILT = {}


def _built(arch, keep):
    if (arch, keep) not in _BUILT:
        cfg = _cfg(arch, bcr_keep_frac=keep)
        _BUILT[arch, keep] = (cfg, build_params(cfg, log=lambda *_: None,
                                                device="cpu"))
    return _BUILT[arch, keep]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode over the paged cache (``generate(forced=)``)
    gives ``forward``'s logits at every position past the prompt."""
    cfg, params = _built(arch, 0.25)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32))
    p = 5
    with torch.no_grad():
        want = causal_lm.forward(cfg, params, toks)[:, p - 1:]
        got = generate(cfg, params, toks[:, :p], gen_tokens=S - p + 1,
                       page_size=PS, forced=toks[:, p:])["logits"]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_token_priming(arch):
    """``prefill`` of S tokens against S decode steps from an empty
    capacity-dense cache: the last logits, every recurrent state and every
    cached K/V row agree."""
    cfg, params = _built(arch, 0.25)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32))
    with torch.no_grad():
        want, pc = causal_lm.prefill(cfg, params, toks)
        cache = causal_lm.init_cache(cfg, B, CAP, device="cpu")
        for t in range(S):
            got, cache = causal_lm.decode_step(
                cfg, params, toks[:, t:t + 1], cache,
                torch.full((B,), t, dtype=torch.int32))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for i, (c, p) in enumerate(zip(cache, pc)):
        for key, leaf in p.items():
            c_leaf = c[key][:, :S] if key in ("k", "v") else c[key]
            torch.testing.assert_close(c_leaf, leaf, atol=1e-4, rtol=1e-4,
                                       msg=f"layer {i} {key}")


def _prompts(vocab, lens=(5, 9, 7, 5), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p in lens]


def _naive(cfg, params, prompts, gen=GEN):
    return [generate(cfg, params, torch.as_tensor(p)[None], gen_tokens=gen,
                     page_size=PS)["tokens"][0].tolist() for p in prompts]


@pytest.mark.parametrize("keep", [0.0, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_naive(arch, keep):
    """2 slots, ragged continuous batching, ``page_size=4``: rwkv serves
    from the capacity-dense pool, jamba from a paged pool whose mamba
    layers are slot leaves, pixtral from a paged pool with the prefix cache
    on (a repeated prompt hits it); tokens equal the naive ``generate``
    bit for bit."""
    cfg, params = _built(arch, keep)
    prompts = _prompts(cfg.vocab_size)
    prompts.append(np.concatenate([prompts[1], prompts[0][:3]]))
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=CAP, page_size=PS, prefix_cache=True),
        device="cpu")
    assert isinstance(eng.pool, SlotPool if arch == "rwkv6-3b"
                      else PagedSlotPool)
    assert eng.prefix_cache == (arch == "pixtral-12b")
    assert eng.pad_prefill == (arch == "pixtral-12b")
    assert eng.generate(prompts, max_new_tokens=GEN) == _naive(cfg, params,
                                                               prompts)
    if arch == "pixtral-12b":
        assert eng.stats["prefix_hit_tokens"] > 0
    eng.check_conservation()


def test_jamba_preemption_and_recover():
    """jamba on a tight paged pool: preemption folds a victim's tokens into
    its prompt and re-prefills its mamba state; ``recover()`` mid-run does
    the same for every running request; both give the uninterrupted
    tokens, leak no page and leave the slot leaves seated."""
    cfg, params = _built("jamba-v0.1-52b", 0.25)
    prompts = _prompts(cfg.vocab_size, lens=(9, 7, 11, 6, 8), seed=3)
    want = _naive(cfg, params, prompts)
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=3, capacity=CAP, page_size=PS, kv_pages=9,
        preempt_after_stalls=1), device="cpu")
    rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts]
    done = {r.rid: r for r in eng.run()}
    assert eng.stats["preemptions"] >= 1
    assert [done[r].generated for r in rids] == want
    assert all(done[r].status == FINISHED for r in rids)
    eng.check_conservation()
    eng.pool.check_consistency()

    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=3, capacity=CAP, page_size=PS), device="cpu")
    rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts]
    eng.step()
    eng.step()
    assert eng.recover() > 0
    done = {r.rid: r for r in eng.run()}
    assert [done[r].generated for r in rids] == want
    eng.check_conservation()
    eng.pool.check_consistency()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_recurrent_families_refuse_spec_and_prefix_cache(arch):
    """``spec_k > 0`` raises (recurrent state cannot be rolled back); the
    prefix cache is a silent no-op (its state cannot be adopted), as the
    reference's ``test_recurrent_family_prefix_cache_noop``."""
    cfg, params = _built(arch, 0.0)
    with pytest.raises(ValueError, match="pure-attention"):
        InferenceEngine(cfg, params, EngineConfig(
            n_slots=2, capacity=CAP, page_size=PS, spec_k=2),
            device="cpu", drafter=OracleDraft({}))
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=CAP, page_size=8, prefix_cache=True),
        device="cpu")
    assert not eng.prefix_cache
    prompt = _prompts(cfg.vocab_size, lens=(10,))[0]
    assert eng.generate([prompt], max_new_tokens=3) == \
        eng.generate([prompt], max_new_tokens=3)
    assert eng.stats["prefix_hit_tokens"] == 0
    with pytest.raises(ValueError, match="prefill_append"):
        causal_lm.prefill_append(
            cfg, params, torch.zeros(1, 2, dtype=torch.int32), [],
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, 1, dtype=torch.int32))


def test_pack_params_fuses_only_shared_activations():
    """rwkv's time-mix ``wr``/``wk``/``wv``/``wg`` each read their own
    token-shift mix, and its channel-mix ``wk``/``wv``/``wr`` have no
    ``wq``: none is fused (``wkv`` needs ``wq``, ``wgi`` needs ``wi``).
    pixtral's and jamba's attention fuse K/V (Q is wider: 4 x 1 KV heads)
    and their MLPs gate/up; jamba's experts fuse gate/up, its mamba
    projections stay single (``dt_proj`` with its bias)."""
    for arch, want in (
            ("rwkv6-3b", [({"wr", "wk", "wv", "wg", "wo", "mu", "w0",
                            "w_lora_a", "w_lora_b", "u", "ln_scale"},
                           {"mu", "wk", "wv", "wr"})]),
            ("pixtral-12b", [({"wq", "wkv", "wo"}, {"wgi", "wo"})]),
            ("jamba-v0.1-52b", None)):
        cfg = _cfg(arch, bcr_keep_frac=0.25)
        dense = causal_lm.init_params(cfg, 0, device="cpu")
        packed = pack_params(cfg, dense)
        for kinds, lp in zip(causal_lm.layer_plan(cfg), packed["layers"]):
            mixer, ffn = set(lp["mixer"]), set(lp["ffn"])
            if want is not None:
                assert (mixer, ffn) == want[0], (arch, mixer, ffn)
            if kinds[0] == "mamba":
                # at SMOKE width x_proj (24 x 128) and dt_proj (128 x 8)
                # are narrower than two 16-blocks: the filter leaves them
                assert {k for k, v in lp["mixer"].items()
                        if isinstance(v, dict) and "w_packed" in v} == {
                            "in_proj", "out_proj"}
                assert "b" in lp["mixer"]["dt_proj"]
            if kinds[0] == "attn" and arch == "jamba-v0.1-52b":
                assert mixer == {"wq", "wkv", "wo"}
            if kinds[1] == "moe":
                assert set(lp["ffn"]["experts"]) == {"wgi", "wo"}
        if arch == "jamba-v0.1-52b":
            # at full width every mamba projection packs: x_proj 288 x 8192
            # on (144, 128) blocks, dt_proj 8192 x 256 on 128 x 128
            fil = default_prune_filter(dataclasses.replace(
                tcfgs.get_config(arch), bcr_keep_frac=0.25))
            for name, shape, block in (("x_proj", (288, 8192), (144, 128)),
                                       ("dt_proj", (8192, 256), (128, 128))):
                spec = fil(f"['layers'][0]['mixer']['{name}']['w']",
                           torch.empty(shape, device="meta"))
                assert spec is not None and spec.block_shape == block
        if arch == "rwkv6-3b":
            tm = packed["layers"][0]["mixer"]
            assert all("w_packed" in tm[k] for k in ("wr", "wk", "wv", "wg",
                                                     "wo"))


# ---------------------------------------------------------------------------
# Slot pools: recurrent state is seated whole
# ---------------------------------------------------------------------------


def _prefill_cache(cfg, params, n, s, seed):
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(n, s)).astype(np.int32))
    with torch.no_grad():
        return causal_lm.prefill(cfg, params, toks)[1]


def test_recurrent_leaf_wider_than_capacity_is_seated_whole():
    """rwkv's ``shift``/``cm_shift`` ``(B, d_model=64)`` and WKV ``s`` in a
    pool of capacity 16: every leaf is a slot leaf, seated whole by
    ``insert_rows`` (pad rows aliasing a slot do not overwrite it),
    ``insert`` and ``seat_prefill``; jamba's paged pool classifies its
    attention leaves as pages and its mamba ``h``/``conv`` (``d_in`` 128
    wide) as slot leaves, seated whole too."""
    cfg, params = _built("rwkv6-3b", 0.0)
    cap = 16
    assert cfg.d_model > cap
    init = (lambda b, c, **kw: causal_lm.init_cache(cfg, b, c, **kw))
    pool = SlotPool(init, 3, cap, device="cpu")
    assert pool.position_keys == [frozenset()] * cfg.num_layers
    pc = _prefill_cache(cfg, params, 3, 5, seed=4)
    pool.insert_rows(pc, np.asarray([2, 0, 2]), np.asarray([5, 5]))
    for layer, new in zip(pool.cache, pc):
        assert set(layer) == {"s", "shift", "cm_shift"}
        for key in layer:
            torch.testing.assert_close(layer[key][2], new[key][0].to(
                layer[key].dtype))
            torch.testing.assert_close(layer[key][0], new[key][1].to(
                layer[key].dtype))
            assert not layer[key][1].any()
    pool.insert([{k: v[2:3] for k, v in layer.items()} for layer in pc], 1, 5)
    for layer, new in zip(pool.cache, pc):
        for key in layer:
            torch.testing.assert_close(layer[key][1], new[key][2])
    seated = seat_prefill(init, pc, 3, cap, device="cpu")
    for layer, new in zip(seated, pc):
        for key in layer:
            torch.testing.assert_close(layer[key], new[key])

    cfg, params = _built("jamba-v0.1-52b", 0.0)
    pool = PagedSlotPool(lambda **kw: causal_lm.init_cache(cfg, **kw), 2,
                         cap, page_size=PS, device="cpu")
    plan = causal_lm.layer_plan(cfg)
    for (mixer, _), pk, sk in zip(plan, pool.position_keys, pool.slot_keys):
        assert (pk, sk) == ((frozenset({"k", "v"}), frozenset())
                            if mixer == "attn"
                            else (frozenset(), frozenset({"h", "conv"})))
    pc = _prefill_cache(cfg, params, 2, 6, seed=5)
    assert pool.reserve(1, 10)
    pool.insert_rows(pc, np.asarray([1, 1]), np.asarray([6]))
    for (mixer, _), layer, new in zip(plan, pool.cache, pc):
        if mixer == "mamba":
            assert layer["h"].shape[1] > cap
            for key in ("h", "conv"):
                torch.testing.assert_close(layer[key][1], new[key][0].to(
                    layer[key].dtype))
                assert not layer[key][0].any()
    pool.check_consistency()


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("arch", ("llama3.2-1b", "deepseek-moe-16b") + ARCHS)
def test_position_rule_matches_reference_probe(arch, kv_dtype):
    """``causal_lm.position_keys``, the port's one rule for which cache
    leaves carry positions, classes every leaf of every family's paged cache
    as the reference's shape probe of ``init_cache`` does (page leaves vs
    slot leaves); the engine pages exactly the models with an attention
    layer, and a pool with slot leaves refuses ``spec_k``. rwkv has no leaf
    to page in either package."""
    from repro.serving.kv_slots import PagedSlotPool as JPagedSlotPool

    jcfg = dataclasses.replace(jcfgs.get_smoke_config(arch),
                               kv_dtype=kv_dtype)
    cfg = _cfg(arch, kv_dtype=kv_dtype)
    eng = InferenceEngine(cfg, build_params(cfg, log=lambda *_: None,
                                            device="cpu"),
                          EngineConfig(n_slots=2, capacity=CAP,
                                       page_size=PS), device="cpu")
    assert eng.paged == causal_lm.has_attention(cfg) \
        == (arch != "rwkv6-3b")
    pool = eng.pool
    assert pool.position_keys == causal_lm.position_keys(pool.cache)
    if not eng.paged:
        with pytest.raises(AssertionError, match="no attention K/V leaf"):
            JPagedSlotPool(jmodel_fns(jcfg).init_cache, 2, CAP,
                           page_size=PS)
        with pytest.raises(ValueError, match="no attention K/V leaf"):
            PagedSlotPool(lambda **kw: causal_lm.init_cache(cfg, **kw), 2,
                          CAP, page_size=PS, device="cpu")
        assert not any(pool.position_keys)
        return
    jpool = JPagedSlotPool(jmodel_fns(jcfg).init_cache, 2, CAP,
                           page_size=PS)
    sp = jstack_plan(jcfg)
    ref = list(jpool._page_axes["prefix"]) \
        + list(jpool._page_axes["stack"]) * sp.repeats
    assert len(ref) == len(pool.cache)
    leaf = dict(_REF_LEAF, k_scale=("mixer", "k_scale"),
                v_scale=("mixer", "v_scale"))
    for i, (layer, pk, sk, jl) in enumerate(zip(
            pool.cache, pool.position_keys, pool.slot_keys, ref)):
        assert pk | sk == set(layer) and not pk & sk, i
        for key in layer:
            sub, name = leaf[key]
            assert (jl[sub][name] >= 0) == (key in pk), (i, key)
    if any(pool.slot_keys):
        with pytest.raises(ValueError, match="pure-attention"):
            InferenceEngine(cfg, eng.params, EngineConfig(
                n_slots=2, capacity=CAP, page_size=PS, spec_k=2),
                device="cpu", drafter=OracleDraft({}))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_family(arch, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke --device
    cpu``: every request finishes; rwkv reports no KV bytes (it has no
    attention)."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--bcr-keep", "0.25", "--requests", "4", "--gen", "4",
        "--capacity", "64"])
    tserve.main()
    out = capsys.readouterr().out
    assert "status: finished 4 /" in out
    assert ("(0 bytes per cached position" in out) == (arch == "rwkv6-3b")
