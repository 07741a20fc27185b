"""Port vs reference, the MoE family: ``moe_apply``, the stacked expert
packs, and the deepseek-moe-16b and llama4-maverick SMOKE models' prefill,
paged decode and prefill-append logits, dense and BCR-packed (block 16)
with fp and int8 tiles; then the port's MoE engine on its own, bit for bit
against its naive ``generate`` on the CPU.

Inputs come from a numpy seed; parameters are the reference's, converted by
``convert.from_jax_params``. The reference runs its BCR and paged kernels
as Pallas in interpret mode (under ``vmap`` for the stacked experts).

Tolerance: ``atol = rtol = 1e-4`` on outputs and logits (fp32 configs;
XLA and PyTorch sum in different orders), as ``tests/test_torch_model.py``.
Routing is compared first and exactly: ``torch.topk`` and ``lax.top_k``
could break a tie differently, and a flipped expert choice would be a
routing near-tie, reported as such by the failing assertion (with the
probability gap), never absorbed by the logits tolerance.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.core.sparse_linear import linear_apply as jlinear  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.bcr import BCRSpec  # noqa: E402
from repro_torch.core.bcrc import tbcrc_pack  # noqa: E402
from repro_torch.kernels import bcr_spmm as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.plan import (expert_slice, pack_group,  # noqa: E402
                                      quantize_grouped, quantize_packed,
                                      stacked_experts)
from repro_torch.launch.serve import (build_draft, build_params,  # noqa: E402
                                      generate, pack_params)
from repro_torch.models import causal_lm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving import (EngineConfig, FINISHED,  # noqa: E402
                                 InferenceEngine, OracleDraft)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")
PS = 4                       # page size
B, S, S2 = 2, 7, 5           # batch, prompt, appended suffix
TIES = 1e-6          # a routing near-tie: top-k probabilities this close


def _cfgs(arch, **over):
    over = dict(bcr_block=(16, 16), cache_dtype="float32", **over)
    jcfg = dataclasses.replace(jcfgs.get_smoke_config(arch),
                               attn_impl="paged_interpret",
                               kernel_impl="interpret", **over)
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch), **over)
    return jcfg, tcfg


def _convert(jparams, tcfg):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                           device="cpu")


_MODELS = {}


def _model(arch, variant, **over):
    """(jcfg, reference params, tcfg, converted params) of one SMOKE config:
    ``variant`` dense, packed (fp tiles) or int8 (int8 tiles)."""
    key = (arch, variant, tuple(sorted(over.items())))
    if key not in _MODELS:
        keep = 0.0 if variant == "dense" else 0.25
        jcfg, tcfg = _cfgs(arch, bcr_keep_frac=keep, **over)
        params = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
        if variant != "dense":
            params = jpack_params(jcfg, params, weight_dtype=(
                "int8" if variant == "int8" else ""))
        _MODELS[key] = (jcfg, params, tcfg, _convert(params, tcfg))
    return _MODELS[key]


def _moe_layer(jparams, tparams):
    """The first MoE layer's FFN in both packages (deepseek: the first
    scanned layer, after its dense prefix layer)."""
    j = next(lp for lp in jparams["stack"] if "router" in lp["ffn"])["ffn"]
    t = next(lp for lp in tparams["layers"] if "router" in lp["ffn"])["ffn"]
    return jax.tree_util.tree_map(lambda a: a[0], j), t


def _reference_expert_idx(jffn, x, jcfg):
    """The reference router's top-k, as its ``moe_apply`` computes it."""
    n_tok = x.shape[0] * x.shape[1]
    g = min(jcfg.moe_group_size, n_tok)
    g = n_tok if n_tok % g else g
    xg = jnp.asarray(x).reshape(n_tok // g, g, -1)
    probs = jax.nn.softmax(jlinear(jffn["router"], xg).astype(jnp.float32),
                           axis=-1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])


def _assert_same_routing(jidx, tidx, probs):
    bad = np.argwhere(jidx != tidx)
    if len(bad):
        gaps = [abs(float(probs[g, s, jidx[g, s, k]]
                          - probs[g, s, tidx[g, s, k]])) for g, s, k in bad]
        raise AssertionError(f"expert choice differs at {bad.tolist()}: a "
                             f"routing near-tie if the probability gaps "
                             f"{gaps} are below {TIES}")


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["dense", "packed"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_apply_matches_reference(variant, masked, cf):
    """64 tokens (one dispatch group): routing first, then the output, with
    and without a token mask; at capacity_factor 1.25 tokens are dropped,
    at 8.0 none is."""
    arch = "deepseek-moe-16b"
    jcfg, jparams, tcfg, tparams = _model(arch, variant)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    jffn, tffn = _moe_layer(jparams, tparams)
    rng = np.random.default_rng(3)
    # a component shared by every token skews the routing, as hidden
    # states do, so that at 1.25 some experts overflow with the mask too
    x = (rng.normal(size=(4, 16, tcfg.d_model))
         + rng.normal(size=tcfg.d_model)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((4, 16), bool)
        mask[1, 9:] = False
        mask[3] = False
    probs, jidx = _reference_expert_idx(jffn, x, jcfg)
    tx = torch.as_tensor(x)
    tm = None if mask is None else torch.as_tensor(mask)
    _, _, tidx, _, combine = tmoe.route(tffn, tx, tcfg, tm)
    _assert_same_routing(jidx, tidx.numpy(), probs)
    real = int(mask.sum()) if masked else 64
    kept = int((combine > 0).sum())
    if cf == 1.25:
        assert kept < tcfg.top_k * real, "no token was dropped"
    else:
        assert kept == tcfg.top_k * real
    want = jmoe.moe_apply(jffn, jnp.asarray(x), jcfg, impl=jcfg.kernel_impl,
                          token_mask=None if mask is None
                          else jnp.asarray(mask))
    got = tmoe.moe_apply(tffn, tx, tcfg, token_mask=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", ["dense", "packed"])
def test_masked_rows_do_not_shift_capacity(variant):
    """The reference's ``test_masked_rows_do_not_shift_capacity`` on the
    port: masked garbage rows leave the real rows' outputs as they are
    alone (capacity_factor 8.0)."""
    _, jparams, tcfg, tparams = _model("deepseek-moe-16b", variant)
    tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    _, tffn = _moe_layer(jparams, tparams)
    rng = np.random.default_rng(3)
    real = torch.as_tensor(rng.normal(size=(2, 4, tcfg.d_model)),
                           dtype=torch.float32)
    junk = torch.as_tensor(rng.normal(size=(2, 4, tcfg.d_model)) * 50,
                           dtype=torch.float32)
    mask = torch.tensor([[True] * 4, [True] * 4, [False] * 4, [False] * 4])
    y_masked = tmoe.moe_apply(tffn, torch.cat([real, junk]), tcfg,
                              token_mask=mask)
    y_alone = tmoe.moe_apply(tffn, real, tcfg,
                             token_mask=torch.ones((2, 4), dtype=torch.bool))
    torch.testing.assert_close(y_masked[:2], y_alone, atol=1e-5, rtol=1e-5)


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 8)).astype(np.float32)
    idx = rng.integers(0, 8, size=(3, 5, 2))
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 8)
    got = tmoe.aux_load_balance_loss(torch.as_tensor(logits),
                                     torch.as_tensor(idx), 8)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_layer_plan_matches_reference():
    from repro.models.causal_lm import layer_plan as jlayer_plan
    for arch in ARCHS:
        for n in (1, 2, 3, 4, 7):
            jcfg = dataclasses.replace(jcfgs.get_config(arch), num_layers=n)
            tcfg = dataclasses.replace(tcfgs.get_config(arch), num_layers=n)
            assert causal_lm.layer_plan(tcfg) == jlayer_plan(jcfg)


# ---------------------------------------------------------------------------
# Model logits: prefill, paged decode, prefill-append
# ---------------------------------------------------------------------------


def _tables(n_cols):
    # slot b owns pages 1 + b, 1 + b + B, ... (interleaved, not contiguous)
    return (1 + np.arange(n_cols)[None, :] * B
            + np.arange(B)[:, None]).astype(np.int32)


def _seat_jax(cache, pcache, dest):
    """Seat the reference's prefill K/V (prefix layers, and scanned layers
    with their leading repeat axis) into its page pools at ``dest``."""
    def put(pool, new):
        if pool.ndim == 5:                       # scanned: (L, pages, ...)
            l = pool.shape[0]
            flat = pool.reshape(l, -1, *pool.shape[3:])
            rows = new.reshape(l, -1, *new.shape[3:])
            return flat.at[:, dest].set(rows.astype(pool.dtype)).reshape(
                pool.shape)
        flat = pool.reshape(-1, *pool.shape[2:])
        rows = new.reshape(-1, *new.shape[2:])
        return flat.at[dest].set(rows.astype(pool.dtype)).reshape(pool.shape)
    return jax.tree_util.tree_map(put, cache, pcache)


@pytest.mark.parametrize("variant", ["dense", "packed", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_append_logits_match_reference(arch, variant):
    jcfg, jparams, tcfg, tparams = _model(arch, variant)
    jfns = jmodel_fns(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    length = np.asarray([S, S - 3], np.int32)
    mask = np.arange(S)[None] < length[:, None]

    # prefill (right-padded row 1: logits at length - 1, pads masked out of
    # expert capacity)
    jl, jpc = jax.jit(jfns.prefill)(jparams, {
        "tokens": jnp.asarray(toks), "length": jnp.asarray(length),
        "token_mask": jnp.asarray(mask)})
    tl, tpc = causal_lm.prefill(tcfg, tparams, torch.as_tensor(toks),
                                length=torch.as_tensor(length),
                                token_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    # seat both prefill caches into the same page tables
    n_cols = -(-(S + 1 + S2) // PS)
    bt = _tables(n_cols)
    n_pages = 1 + B * n_cols
    pos = np.arange(S)
    dest = (bt[:, pos // PS] * PS + pos % PS).reshape(-1)
    jcache = _seat_jax(jfns.init_cache(B, 64, kv_pages=n_pages, page_size=PS),
                       jpc, jnp.asarray(dest))
    tcache = causal_lm.init_cache(tcfg, kv_pages=n_pages, page_size=PS,
                                  device="cpu")
    dt = torch.as_tensor(dest)
    for pool, new in zip(tcache, tpc):
        for key in ("k", "v"):
            pool[key].view(-1, *pool[key].shape[2:]).index_copy_(
                0, dt, new[key].reshape(-1, *new[key].shape[2:]))

    # one paged decode step from each slot's own length, both rows routed
    step = rng.integers(0, tcfg.vocab_size, size=(B, 1)).astype(np.int32)
    live = np.ones((B, 1), bool)
    jl, jcache = jax.jit(jfns.decode_step)(
        jparams, {"tokens": jnp.asarray(step),
                  "cache_len": jnp.asarray(length),
                  "block_tables": jnp.asarray(bt),
                  "token_mask": jnp.asarray(live)}, jcache)
    tl, tcache = causal_lm.decode_step(
        tcfg, tparams, torch.as_tensor(step), tcache, torch.as_tensor(length),
        block_tables=torch.as_tensor(bt), token_mask=torch.as_tensor(live))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    # prefill-append a suffix over the cached prefix, every position scored
    suffix = rng.integers(0, tcfg.vocab_size, size=(B, S2)).astype(np.int32)
    plen = length + 1
    slen = np.asarray([S2, 2], np.int32)
    jl, _ = jfns.prefill_append(
        jparams, {"tokens": jnp.asarray(suffix),
                  "prefix_len": jnp.asarray(plen),
                  "length": jnp.asarray(slen),
                  "block_tables": jnp.asarray(bt), "all_logits": True},
        jcache)
    tl, _ = causal_lm.prefill_append(
        tcfg, tparams, torch.as_tensor(suffix), tcache,
        torch.as_tensor(plen), torch.as_tensor(bt),
        length=torch.as_tensor(slen), all_logits=True)
    for b, sl in enumerate(slen):          # rows past slen are garbage
        np.testing.assert_allclose(tl[b, :sl].numpy(),
                                   np.asarray(jl)[b, :sl], **TOL)


# ---------------------------------------------------------------------------
# Stacked packing and the expert-batched plain versions
# ---------------------------------------------------------------------------


def _equal(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _same_pack(tpk, jpk, what):
    for name in ("vals", "row_idx", "col_idx"):
        _equal(getattr(tpk, name), getattr(jpk, name), f"{what}.{name}")
    for name in ("gather_cols", "scatter_rows"):
        _equal(getattr(tpk.plan, name), getattr(jpk.plan, name),
               f"{what}.plan.{name}")
    if jpk.plan.block_scales is None:
        assert tpk.plan.block_scales is None
    else:
        _equal(tpk.plan.block_scales, jpk.plan.block_scales,
               f"{what}.block_scales")
    assert tuple(tpk.shape) == tuple(jpk.shape)
    assert tuple(tpk.block_shape) == tuple(jpk.block_shape)


@pytest.mark.parametrize("weight_dtype", ["", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_pack_matches_reference(arch, weight_dtype):
    """The port's ``pack_params`` on the converted dense weights against the
    reference's stacked packs (``_pack_any``, vmapped ``pack_group``), entry
    by entry: every expert's tiles, index planes, plan vectors and int8
    scales, the fused gate/up ``wgi`` with the expert axis first."""
    jcfg, tcfg = _cfgs(arch, bcr_keep_frac=0.25)
    jparams = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    tpacked = pack_params(tcfg, _convert(jparams, tcfg),
                          weight_dtype=weight_dtype)
    jpacked = _convert_free(jpack_params(jcfg, jparams, plan=False,
                                         weight_dtype=weight_dtype))
    jffn = next(lp for lp in jpacked["stack"] if "router" in lp["ffn"])["ffn"]
    tffn = next(lp for lp in tpacked["layers"] if "router" in lp["ffn"])["ffn"]
    jexp = jax.tree_util.tree_map(lambda a: a[0], jffn["experts"])
    jgroup = jplan.pack_group([jexp["wg"]["w_packed"],
                               jexp["wi"]["w_packed"]])
    tgroup = tffn["experts"]["wgi"]["w_group"]
    e = tcfg.num_experts
    assert stacked_experts(tgroup) == e and tgroup.group_size == 2
    assert tgroup.vals.shape[:2] == (e, 2)
    _same_pack(tgroup, jgroup, "experts.wgi")
    _same_pack(tffn["experts"]["wo"]["w_packed"], jexp["wo"]["w_packed"],
               "experts.wo")
    assert "w" in tffn["router"]               # 8 experts: never pruned
    assert "wgi" in tffn["shared"]


def _convert_free(tree):
    """A reference tree with numpy leaves (packs keep their containers)."""
    return jax.tree_util.tree_map(np.asarray, tree)


E, N, KD = 3, 48, 64


def _stacked(rng, int8=False):
    w = torch.as_tensor(rng.normal(size=(E, N, KD)), dtype=torch.float32)
    spec = BCRSpec(block_shape=(16, 16), keep_frac=0.25, align=4)
    p = tbcrc_pack(w, spec)
    return w, spec, (quantize_packed(p) if int8 else p)


@pytest.mark.parametrize("int8", [False, True])
def test_stacked_pack_equals_per_expert_packs(int8):
    """One batched pass over E equals E unbatched packs, entry by entry."""
    rng = np.random.default_rng(0)
    w, spec, p = _stacked(rng, int8)
    assert stacked_experts(p) == E and tuple(p.shape) == (N, KD)
    for e in range(E):
        one = tbcrc_pack(w[e], spec)
        one = quantize_packed(one) if int8 else one
        _same_pack(expert_slice(p, e), one, f"expert {e}")


@pytest.mark.parametrize("int8", [False, True])
def test_expert_batched_plain_spmm_equals_a_loop(int8):
    rng = np.random.default_rng(1)
    _, _, p = _stacked(rng, int8)
    x = torch.as_tensor(rng.normal(size=(E, 5, KD)), dtype=torch.float32)
    got = K.bcr_spmm(x, p)                  # the CPU wrapper: plain version
    assert got.shape == (E, 5, N)
    for e in range(E):
        one = expert_slice(p, e)
        torch.testing.assert_close(got[e], ref.bcr_spmm_packed_ref(x[e], one),
                                   atol=0, rtol=0)
        torch.testing.assert_close(got[e], ref.bcr_spmm_ref(x[e], one),
                                   **TOL)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("epilogue", [None, "swiglu"])
@pytest.mark.parametrize("int8", [False, True])
def test_expert_batched_plain_grouped_equals_a_loop(int8, epilogue, bias):
    rng = np.random.default_rng(2)
    members = [_stacked(rng)[2] for _ in range(2)]
    g = pack_group(members)
    g = quantize_grouped(g) if int8 else g
    assert g.vals.shape[:2] == (E, 2)
    assert g.plan.gather_cols.shape[0] == E
    b = (torch.as_tensor(rng.normal(size=(E, 2, N)), dtype=torch.float32)
         if bias else None)
    x = torch.as_tensor(rng.normal(size=(E, 6, KD)), dtype=torch.float32)
    got = K.bcr_spmm_grouped(x, g, bias=b, epilogue=epilogue)
    assert got.shape == ((E, 6, N) if epilogue else (E, 2, 6, N))
    for e in range(E):
        one = expert_slice(g, e)
        want = ref.bcr_spmm_grouped_ref(
            x[e], one, bias=None if b is None else b[e], epilogue=epilogue)
        if epilogue is None:
            want = want.transpose(0, 1)
        torch.testing.assert_close(got[e], want, atol=0, rtol=0)
        # the member packs of expert e, grouped alone, give the same
        alone = pack_group([expert_slice(m, e) for m in members])
        alone = quantize_grouped(alone) if int8 else alone
        want2 = K.bcr_spmm_grouped(x[e], alone,
                                   bias=None if b is None else b[e],
                                   epilogue=epilogue)
        torch.testing.assert_close(got[e], want2, atol=0, rtol=0)


def test_stacked_launch_plan_counts_every_expert():
    """The split decision reads every expert's output tiles: 64 experts of
    deepseek's gate/up at decode fill the card unsplit; 4 of them split."""
    sms = 132
    for e, split in ((64, False), (4, True)):
        plan = K.launch_plan(4, 1408, 2048, 2, (128, 128), (64, 64), sms,
                             experts=e)
        assert plan.experts == e
        assert plan.tiles == e * plan.nb_r * plan.chunks * plan.m_tiles
        assert plan.grid == plan.tiles * plan.splits
        assert (plan.splits > 1) == split
        assert plan.nb_r == 11 and plan.chunks * plan.n_chunk >= 128
    one = K.launch_plan(4, 1408, 2048, 2, (128, 128), (64, 64), sms)
    assert one.experts == 1 and one.splits > 1


# ---------------------------------------------------------------------------
# The MoE engine inside the port, bit for bit on the CPU
# ---------------------------------------------------------------------------

GEN = 6


def _moe_cfg(arch="deepseek-moe-16b", **over):
    return dataclasses.replace(tcfgs.get_smoke_config(arch),
                               capacity_factor=8.0, cache_dtype="float32",
                               **over)


@pytest.fixture(scope="module")
def moe_models():
    out = {}
    for keep in (0.0, 0.25):
        cfg = _moe_cfg(bcr_keep_frac=keep, bcr_block=(16, 16))
        out[keep] = (cfg, build_params(cfg, log=lambda *_: None,
                                       device="cpu"))
    return out


def _prompts(vocab, lens=(5, 9, 7, 5), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p in lens]


def _naive(cfg, params, prompts, gen=GEN):
    return [generate(cfg, params, torch.as_tensor(p)[None],
                     gen_tokens=gen, page_size=PS)["tokens"][0].tolist()
            for p in prompts]


@pytest.mark.parametrize("page_size", [0, PS])
@pytest.mark.parametrize("keep", [0.0, 0.25])
def test_moe_engine_matches_naive(moe_models, keep, page_size):
    """The reference's ``TestMoEEngine::test_engine_matches_naive`` on the
    port: 2 slots, ragged continuous batching, capacity_factor 8.0; the
    capacity-dense pool and the paged one."""
    cfg, params = moe_models[keep]
    prompts = _prompts(cfg.vocab_size)
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=32, page_size=page_size), device="cpu")
    assert not eng.pad_prefill
    assert eng.generate(prompts, max_new_tokens=GEN) == _naive(cfg, params,
                                                               prompts)
    eng.check_conservation()


def test_moe_cold_prefill_groups_by_prompt_length(moe_models):
    """Exact-length cold prefill: one dispatch per prompt length, each at
    that length; the dense family pads them into one."""
    cfg, params = moe_models[0.0]
    prompts = _prompts(cfg.vocab_size, lens=(5, 9, 5, 7))
    seen = []
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=4, capacity=32, page_size=PS, backfill_chunk=1),
        device="cpu")
    prefill = eng.fns.prefill

    def spy(p, batch):
        seen.append(tuple(batch["tokens"].shape))
        return prefill(p, batch)

    eng.fns = dataclasses.replace(eng.fns, prefill=spy)
    got = eng.generate(prompts, max_new_tokens=GEN)
    assert sorted(seen) == [(1, 7), (1, 9), (2, 5)]
    assert eng.stats["prefills"] == 3 and eng.stats["prefill_rows"] == 4
    assert got == _naive(cfg, params, prompts)
    dense = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"))
    deng = InferenceEngine(dense, build_params(dense, device="cpu"),
                           EngineConfig(n_slots=4, capacity=32,
                                        page_size=PS), device="cpu")
    assert deng.pad_prefill
    deng.generate(prompts, max_new_tokens=2)
    assert deng.stats["prefills"] == 1


@pytest.mark.parametrize("family,pad", [("dense", False), ("moe", True)])
def test_pad_prefill_override(moe_models, family, pad):
    """``EngineConfig.pad_prefill`` overrides the family default both ways:
    a dense engine prefilling at exact length, one dispatch per prompt
    length, and a MoE engine padding every cold prompt into one dispatch
    (its pad rows kept out of expert capacity by the token mask). Both
    still equal naive ``generate``."""
    if family == "moe":
        cfg, params = moe_models[0.0]
    else:
        cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                                  cache_dtype="float32")
        params = build_params(cfg, log=lambda *_: None, device="cpu")
    prompts = _prompts(cfg.vocab_size, lens=(5, 9, 5, 7))
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=4, capacity=32, page_size=PS, pad_prefill=pad),
        device="cpu")
    assert eng.pad_prefill is pad
    seen = []
    prefill = eng.fns.prefill

    def spy(p, batch):
        seen.append(tuple(batch["tokens"].shape))
        return prefill(p, batch)

    eng.fns = dataclasses.replace(eng.fns, prefill=spy)
    got = eng.generate(prompts, max_new_tokens=GEN)
    if pad:
        assert len(seen) == 1 and seen[0][0] == 4 and seen[0][1] >= 9
    else:
        assert sorted(seen) == [(1, 7), (1, 9), (2, 5)]
    assert got == _naive(cfg, params, prompts)
    eng.check_conservation()


def test_moe_prefix_cache_is_ignored(moe_models):
    cfg, params = moe_models[0.0]
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=32, page_size=PS, prefix_cache=True),
        device="cpu")
    assert not eng.prefix_cache
    prompt = list(range(1, 11))
    first = eng.generate([prompt], max_new_tokens=3)
    assert eng.generate([prompt], max_new_tokens=3) == first
    assert eng.stats["prefix_hit_tokens"] == 0
    eng.check_conservation()


@pytest.mark.parametrize("drafter", ["oracle", "model"])
def test_moe_greedy_speculative_equals_plain(moe_models, drafter):
    """Greedy speculative decoding on the MoE smoke config (verify through
    ``prefill_append``; the model drafter is a 2-layer MoE) equals plain
    greedy."""
    cfg, params = moe_models[0.25]
    prompts = _prompts(cfg.vocab_size)
    plain = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=32, page_size=PS), device="cpu")
    want = plain.generate(prompts, max_new_tokens=GEN)
    kw = {}
    if drafter == "oracle":
        kw["drafter"] = OracleDraft()
    else:
        dcfg, dparams = build_draft(cfg, device="cpu", log=lambda *_: None)
        assert dcfg.family == "moe"
        kw["draft_params"] = dparams
    ec = EngineConfig(n_slots=2, capacity=32, page_size=PS, spec_k=3,
                      draft_cfg=None if drafter == "oracle" else dcfg)
    eng = InferenceEngine(cfg, params, ec, device="cpu", **kw)
    if drafter == "oracle":
        rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts]
        for rid, toks in zip(rids, want):
            eng.drafter.continuations[rid] = toks
        done = {r.rid: r for r in eng.run()}
        got = [done[r].generated for r in rids]
        assert eng.stats["draft_accepted"] > 0
    else:
        got = eng.generate(prompts, max_new_tokens=GEN)
        assert eng.stats["draft_proposed"] > 0
    assert got == want
    assert eng.stats["spec_steps"] > 0
    eng.check_conservation()


def test_moe_lifecycle_conserves_pages(moe_models):
    """An oversubscribed pool with preemption and a cancel: every request
    ends terminal, the uncancelled ones FINISHED with the uninterrupted
    tokens, and no page leaks."""
    cfg, params = moe_models[0.25]
    prompts = _prompts(cfg.vocab_size, lens=(9, 7, 11, 6, 8), seed=3)
    want = InferenceEngine(cfg, params, EngineConfig(
        n_slots=3, capacity=32, page_size=PS), device="cpu").generate(
            prompts, max_new_tokens=GEN)
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=3, capacity=32, page_size=PS, kv_pages=9,
        preempt_after_stalls=1), device="cpu")
    rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts]
    eng.step()
    eng.step()
    cancelled = eng.cancel(rids[1])
    assert cancelled is not None and cancelled.status == "CANCELLED"
    done = {r.rid: r for r in eng.run()}
    assert rids[1] not in done
    for i, rid in enumerate(rids):
        if i != 1:
            assert done[rid].status == FINISHED
            assert done[rid].generated == want[i]
    assert eng.stats["preemptions"] >= 1
    eng.check_conservation()
    eng.pool.check_consistency()
