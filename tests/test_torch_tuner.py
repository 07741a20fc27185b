"""Port vs reference, GRIM's compile step (§4.5 and §5.1): the GA search
(``core/tuner.genetic_search``, equal result for equal space, fitness and
seed), the Listing-1 pick of ``_auto_block_spec`` under one injected
runner, and the fusion votes of the plan tuner on every family's SMOKE tree
(the reference's ``plan_params`` over the same packs, key by key). Then the
port's own tuner: the launch genome against ``launch_plan``'s rule, the
legality of every genome of the space, the decode-hint boundary, the H100
model's monotony in keep, the genome cache, ``plan_params``' idempotence
and stacked experts, and the fitness names.

Tolerances: none. The searches are deterministic and both packages get the
same fitness values, so results are equal."""

import dataclasses
import itertools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.core import bcr as jbcr  # noqa: E402
from repro.core import tuner as jtuner  # noqa: E402
from repro.core.bcrc import TBCRC as JTBCRC  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import bcr as tbcr  # noqa: E402
from repro_torch.core import block_search as tbs  # noqa: E402
from repro_torch.core import tuner as ttuner  # noqa: E402
from repro_torch.core.bcrc import TBCRC, tbcrc_pack  # noqa: E402
from repro_torch.kernels import bcr_spmm as K  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels.plan import GroupedTBCRC  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402

torch.set_num_threads(2)
SMS = ttuner.H100_SMS

# ---------------------------------------------------------------------------
# genetic_search
# ---------------------------------------------------------------------------

SPACES = [
    {"a": [1, 2, 3, 4], "b": ["x", "y"]},
    {"m_tile": [8, 16, 32, 64, 128], "config": [0, 1],
     "split": [False, True], "group_size": [1, 3]},
    {"p": list(range(7)), "q": [0.5, 1.5, 2.5], "r": [True, False],
     "s": list(range(11))},
]


def _hash_fitness(g):
    """A deterministic scramble of the genome (many near-ties)."""
    h = 0
    for k in sorted(g):
        h = (h * 131 + sum(map(ord, f"{k}={g[k]}"))) % 9973
    return h / 9973.0


def _bowl_fitness(g):
    """A smooth bowl over the numeric genes (booleans and strings map to
    small numbers)."""
    tot = 0.0
    for k in sorted(g):
        v = g[k]
        v = (ord(v) if isinstance(v, str) else float(v))
        tot += (v - 3.3) ** 2
    return tot


def _holed_fitness(g):
    """The bowl with holes: a third of the space scores inf."""
    if int(_hash_fitness(g) * 3) == 0:
        return float("inf")
    return _bowl_fitness(g)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("fitness", [_hash_fitness, _bowl_fitness,
                                     _holed_fitness])
@pytest.mark.parametrize("space", range(len(SPACES)))
def test_genetic_search_matches_reference(space, fitness, seed):
    kw = dict(population=12, generations=6, seed=seed)
    got = ttuner.genetic_search(SPACES[space], fitness, **kw)
    want = jtuner.genetic_search(SPACES[space], fitness, **kw)
    assert got.best == want.best
    assert got.best_fitness == want.best_fitness
    assert got.history == want.history
    assert got.evaluations == want.evaluations


def test_genetic_search_inf_everywhere_returns_the_least_bad():
    space = SPACES[1]
    got = ttuner.genetic_search(space, lambda g: float("inf"), population=8,
                                generations=3)
    want = jtuner.genetic_search(space, lambda g: float("inf"),
                                 population=8, generations=3)
    assert got.best is not None and got.best == want.best
    assert math.isinf(got.best_fitness)


# ---------------------------------------------------------------------------
# Listing 1 at pack time: _auto_block_spec
# ---------------------------------------------------------------------------


def _fake_latency(layer):
    """One card-free runner for both packages: a per-block issue cost, a
    kept-byte term and a penalty on huge blocks."""
    br, bc = layer.block_shape
    blocks = (layer.n // br) * (layer.k // bc)
    return (3e-7 * blocks + 2e-12 * layer.keep_frac * layer.n * layer.k
            * (1 + layer.m / 32) + 2e-9 * math.sqrt(br * bc) * layer.m)


@pytest.mark.parametrize("shape,block", [((2048, 2048), (128, 128)),
                                         ((512, 2048), (128, 128)),
                                         ((8192, 2048), (256, 256)),
                                         ((64, 128), (16, 16))])
@pytest.mark.parametrize("decode_m", [1, 8])
def test_auto_block_spec_picks_the_reference_block(shape, block, decode_m):
    keep = 0.25
    got = tserve._auto_block_spec(
        tbcr.BCRSpec(block_shape=block, keep_frac=keep), shape, keep,
        decode_m, _fake_latency)
    want = jserve._auto_block_spec(
        jbcr.BCRSpec(block_shape=block, keep_frac=keep), shape, keep,
        decode_m, _fake_latency)
    assert tuple(got.block_shape) == tuple(want.block_shape)
    assert got.align == want.align and got.keep_frac == want.keep_frac


def test_auto_block_default_runner_is_the_h100_model():
    """Without a runner the pick comes from ``analytic_latency``: a block
    whose tiles no CTA holds (512 x 512 at keep 0.25) is never chosen, and
    the pick is one the kernel launches."""
    spec = tserve._auto_block_spec(tbcr.BCRSpec(block_shape=(128, 128),
                                                keep_frac=0.25),
                                   (2048, 2048), 0.25, 8)
    assert spec.block_shape != (512, 512)
    layer = tbs.synthesize(8, 2048, 2048, 0.25, spec.block_shape)
    assert math.isfinite(tbs.analytic_latency(layer))
    assert math.isinf(tbs.analytic_latency(
        tbs.synthesize(8, 2048, 2048, 0.25, (512, 512))))


# ---------------------------------------------------------------------------
# the fusion votes on every family's SMOKE tree
# ---------------------------------------------------------------------------


def _smoke(arch):
    return dataclasses.replace(tcfgs.get_smoke_config(arch),
                               bcr_keep_frac=0.25, bcr_block=(16, 16))


def _to_reference(tree):
    """The port's unfused packs as the reference's TBCRCs (numpy → jnp,
    the same dict layout), so the reference's own tuner and fusion run on
    the same geometry and dtype."""
    if isinstance(tree, TBCRC):
        return JTBCRC(vals=jnp.asarray(tree.vals.numpy()),
                      row_idx=jnp.asarray(tree.row_idx.numpy()),
                      col_idx=jnp.asarray(tree.col_idx.numpy()),
                      shape=tuple(tree.shape),
                      block_shape=tuple(tree.block_shape), plan=None)
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    if isinstance(tree, dict):
        return {k: _to_reference(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_reference(v) for v in tree]
    return tree


def _entries(tree, path=""):
    """``path → "group" | "packed"`` of every packed entry (fused groups
    with their group size)."""
    out = {}
    if isinstance(tree, dict):
        if "w_group" in tree:
            return {path: f"group{tree['w_group'].group_size}"}
        if "w_packed" in tree:
            return {path: "packed"}
        for k, v in tree.items():
            out.update(_entries(v, f"{path}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_entries(v, f"{path}/{i}"))
    return out


@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_pack_params_fuses_what_the_reference_fuses(arch):
    """The port's ``pack_params`` (analytic fitness, the default) against
    the reference's ``plan_params`` over the same unfused packs: the same
    entries fused, with the same group sizes, key by key. (The votes are
    the two tuners' own: the port's H100 model, the reference's TPU
    model.)"""
    cfg = _smoke(arch)
    dense = model_fns(cfg).init_params(0, device="cpu")
    unfused = tserve.pack_params(cfg, dense, plan=False)
    got = tserve.pack_params(cfg, dense)
    want = jplan.plan_params(_to_reference(unfused), m=8)
    assert _entries(got) == _entries(want)
    # rwkv's projections each read their own token-shift mix: none fuses
    assert (arch == "rwkv6-3b") != any(v.startswith("group")
                                       for v in _entries(got).values())


def test_pack_params_matches_the_reference_pack_params():
    """One family end to end: the reference's own ``pack_params`` of the
    same dense weights, converted, has the port's fused entries."""
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               bcr_keep_frac=0.25, bcr_block=(16, 16))
    tcfg = _smoke("llama3.2-1b")
    jdense = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    want = from_jax_params(
        jax.tree_util.tree_map(np.asarray, jserve.pack_params(jcfg, jdense)),
        tcfg, device="cpu")
    tdense = from_jax_params(jax.tree_util.tree_map(np.asarray, jdense),
                             tcfg, device="cpu")
    got = tserve.pack_params(tcfg, tdense)
    assert _entries(got) == _entries(want)


def _no_genome(tree):
    if isinstance(tree, (TBCRC, GroupedTBCRC)):
        return tree.plan.genome is None
    if isinstance(tree, dict):
        return all(_no_genome(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_no_genome(v) for v in tree)
    return True


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b",
                                  "whisper-large-v3"])
def test_plan_false_neither_tunes_nor_fuses(arch):
    cfg = _smoke(arch)
    dense = model_fns(cfg).init_params(0, device="cpu")
    packed = tserve.pack_params(cfg, dense, plan=False)
    assert not any(v.startswith("group") for v in _entries(packed).values())
    assert _no_genome(packed)


# ---------------------------------------------------------------------------
# the launch genome
# ---------------------------------------------------------------------------

# (N, K, G, block, kept, E) at llama3.2-1b's and whisper's full width, the
# smoke width, and deepseek's stacked experts
SHAPES = [(2048, 2048, 1, (128, 128), (64, 64), 1),
          (512, 2048, 2, (128, 128), (64, 64), 1),
          (8192, 2048, 2, (128, 128), (64, 64), 1),
          (128256, 2048, 1, (128, 128), (64, 64), 1),
          (51866, 1280, 1, (2, 128), (1, 64), 1),
          (1280, 1280, 3, (128, 128), (64, 64), 1),
          (32, 64, 2, (16, 16), (8, 8), 1),
          (1408, 2048, 2, (128, 128), (64, 64), 64)]


def _rule_genome(plan):
    """The genome of the rule's own plan (a short-body plan's ``config``
    indexes the short-block configurations)."""
    if plan.body == "short":
        cfgs = K.short_configs(plan.m_tile)
        return (plan.m_tile,
                cfgs.index((plan.slabs, plan.warps_m, plan.n_chunk)),
                plan.splits > 1)
    cfgs = K.tile_configs(plan.m_tile)
    return (plan.m_tile, cfgs.index((plan.slabs, plan.warps_m, plan.warps)),
            plan.splits > 1)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("m", [1, 8, 37, 2048])
@pytest.mark.parametrize("shape", SHAPES)
def test_space_holds_the_rule_and_its_genome_rebuilds_it(shape, m, int8):
    """``genome=None`` is the rule; the rule's own choice is a point of the
    search space, and that genome rebuilds the very same plan."""
    n, k, g, block, kept, e = shape
    rule = K.launch_plan(m, n, k, g, block, kept, SMS, int8, True, e)
    assert rule == K.launch_plan(m, n, k, g, block, kept, SMS, int8, True,
                                 e, None)
    genome = _rule_genome(rule)
    space = tplan.plan_search_space(m, g, block)
    assert genome[0] in space["m_tile"] and genome[1] in space["config"]
    assert g in space["group_size"]
    assert K.launch_plan(m, n, k, g, block, kept, SMS, int8, True, e,
                         genome) == rule


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_every_genome_fits_a_cta_or_scores_inf(shape, int8):
    n, k, g, block, kept, e = shape
    m = 8
    fit = ttuner.plan_cost_model(m, k, n, block, *kept,
                                 weight_bytes_per_el=1 if int8 else 2,
                                 weight_scale_bytes=4 if int8 else 0,
                                 experts=e)
    space = tplan.plan_search_space(m, g, block)
    finite = 0
    for values in itertools.product(*(space[key] for key in sorted(space))):
        genome = dict(zip(sorted(space), values))
        score = fit(genome)
        try:
            plan = K.launch_plan(m, n, k, genome["group_size"], block, kept,
                                 SMS, int8, True, e,
                                 ttuner.genome_knobs(genome))
        except ValueError:
            assert math.isinf(score), genome
            continue
        finite += 1
        assert math.isfinite(score) and score > 0
        assert plan.smem_bytes <= K.SMEM_LIMIT
        if plan.body == "short":
            assert plan.smem_bytes == K.short_smem_layout(
                plan.m_tile, plan.n_chunk, block[0], plan.stage_blocks,
                plan.stages, block[1], kept[0], kept[1], int8, plan.warps_k)
        else:
            assert plan.smem_bytes == K.smem_layout(
                plan.m_tile, plan.n_chunk, plan.stages, genome["group_size"],
                block[1], kept[0], kept[1], int8, plan.vec,
                -(-plan.nb_c // plan.splits))
        assert genome["group_size"] * plan.n_chunk <= plan.rows
    assert finite >= 2


# phase 17a's shapes on 128 x 128 blocks (chip_smoke.py:TUNE_SHAPES): the
# genome the analytic tuner picks at the engine's decode hint M = 8, bf16
# and int8 tiles, as it picked them before the short-block body
SQUARE_PICKS = [
    (2048, 2048, 1, {"config": 1, "group_size": 1, "m_tile": 8,
                     "split": True}),
    (512, 2048, 2, {"config": 0, "group_size": 2, "m_tile": 8,
                    "split": True}),
    (8192, 2048, 2, {"config": 0, "group_size": 2, "m_tile": 8,
                     "split": True}),
    (2048, 8192, 1, {"config": 1, "group_size": 1, "m_tile": 8,
                     "split": True}),
    (128256, 2048, 1, {"config": 1, "group_size": 1, "m_tile": 8,
                       "split": True}),
    (1280, 1280, 3, {"config": 0, "group_size": 3, "m_tile": 8,
                     "split": True})]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n,k,g,want", SQUARE_PICKS)
def test_square_block_picks_are_unchanged(n, k, g, want, int8):
    """The short-block body moves no 128 x 128 shape's tuned genome: its
    search space and the model's prices of its genomes are as before."""
    got = tplan.tuned_genome(8, k, n, (128, 128), 64, 64, max_group=g,
                             weight_bytes_per_el=1 if int8 else 2,
                             weight_scale_bytes=4 if int8 else 0)
    assert got == want
    assert (tplan.plan_search_space(8, g, (128, 128))
            == tplan.plan_search_space(8, g))


@pytest.mark.parametrize("int8", [False, True])
def test_whisper_lm_head_picks_the_short_body(int8):
    """whisper-large-v3's lm_head on (2, 128) blocks (one kept row a tile):
    the analytic pick at M = 8 runs the short-block body, whose
    configurations the genome's ``config`` indexes."""
    genome = tplan.tuned_genome(8, 1280, 51866, (2, 128), 1, 64,
                                weight_bytes_per_el=1 if int8 else 2,
                                weight_scale_bytes=4 if int8 else 0)
    plan = K.launch_plan(8, 51866, 1280, 1, (2, 128), (1, 64), SMS, int8,
                         True, 1, ttuner.genome_knobs(genome))
    assert plan.body == "short"
    assert (plan.slabs, plan.warps_m, plan.n_chunk) == K.short_configs(
        genome["m_tile"])[genome["config"]]
    space = tplan.plan_search_space(8, 1, (2, 128))
    assert space["config"] == list(range(3))


def test_illegal_genomes_raise_outside_the_tuner():
    with pytest.raises(ValueError, match="configurations"):
        K.launch_plan(8, 2048, 2048, 1, (128, 128), (64, 64), SMS,
                      genome=(64, 1, False))
    with pytest.raises(ValueError, match="cannot run"):
        # the wgmma tile reads C_keep <= 64
        K.launch_plan(8, 256, 256, 1, (128, 128), (64, 96), SMS,
                      genome=(128, 0, False))
    with pytest.raises(ValueError, match="shared memory"):
        K.launch_plan(8, 1024, 1024, 3, (256, 256), (128, 128), SMS,
                      genome=(8, 1, False))


def test_genome_rules_up_to_the_decode_hint_and_the_rule_above_it():
    """A pack tuned for decode batch 8 launches its genome for M <= 8; at
    prefill M the kernel's rule decides (a decode tile says nothing of a
    prefill)."""
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(size=(2048, 2048)), dtype=torch.float32)
    packed = tplan.tune_packed(
        tbcrc_pack(w, tbcr.BCRSpec(block_shape=(128, 128), keep_frac=0.25)),
        m=8)
    knobs = ttuner.genome_knobs(packed.plan.genome)
    assert packed.plan.m_hint == 8
    for m in (1, 4, 8):
        assert tplan.launch_genome(packed.plan, m) == knobs
    for m in (9, 32, 2048):
        assert tplan.launch_genome(packed.plan, m) is None
        assert K.launch_plan(m, 2048, 2048, 1, (128, 128), (64, 64), SMS,
                             False, True, 1,
                             tplan.launch_genome(packed.plan, m)) == \
            K.launch_plan(m, 2048, 2048, 1, (128, 128), (64, 64), SMS)
    # an untuned pack: the rule at every M
    assert tplan.launch_genome(tplan.attach_plan(packed).plan, 4) is None


@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 8192, 2048),
                                   (1, 2048, 128256), (2048, 2048, 8192)])
@pytest.mark.parametrize("block", [(32, 128), (64, 64), (128, 128)])
def test_analytic_model_is_monotone_in_keep(m, k, n, block):
    """At any one launch genome, more kept weights never cost less (the
    keeps at which the genome launches); so at decode M, where the rule's
    plan stays put, does ``analytic_latency``. (Across a change of the
    rule's plan the model may fall: at M = 2048 a C_keep past 64 moves the
    rule off the wgmma tile to a grid that quantizes into waves better.)"""
    keeps = (0.05, 0.1, 0.25, 0.5, 0.75)
    kept = [tbs.layer_kept(tbs.synthesize(m, k, n, keep, block))
            for keep in keeps]
    space = tplan.plan_search_space(m, 1)
    runs = 0
    for values in itertools.product(*(space[key] for key in sorted(space))):
        genome = dict(zip(sorted(space), values))
        times = [t for t in (ttuner.plan_cost_model(m, k, n, block, r, c)(
            genome) for r, c in kept) if math.isfinite(t)]
        assert times == sorted(times), (genome, times)
        runs += len(times) == len(keeps)
    assert runs >= 1
    if m <= 8:
        lat = [tbs.analytic_latency(tbs.synthesize(m, k, n, keep, block))
               for keep in keeps]
        assert lat == sorted(lat), lat


def test_tuned_genome_is_cached_and_legal():
    key_args = (8, 2048, 512, (128, 128), 64, 64)
    first = tplan.tuned_genome(*key_args, max_group=2)
    n_cached = len(tplan._GENOME_CACHE)
    second = tplan.tuned_genome(*key_args, max_group=2)
    assert first == second and len(tplan._GENOME_CACHE) == n_cached
    first["m_tile"] = -1                 # a copy: the cache is untouched
    assert tplan.tuned_genome(*key_args, max_group=2) == second
    plan = K.launch_plan(8, 512, 2048, second["group_size"], (128, 128),
                         (64, 64), SMS, genome=ttuner.genome_knobs(second))
    assert plan.smem_bytes <= K.SMEM_LIMIT


def _genomes(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, (TBCRC, GroupedTBCRC)):
        out.append((tree.plan.genome, tree.plan.m_hint))
    elif isinstance(tree, dict):
        for v in tree.values():
            _genomes(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _genomes(v, out)
    return out


def test_plan_params_is_idempotent_and_keeps_tuned_plans():
    cfg = _smoke("llama3.2-1b")
    dense = model_fns(cfg).init_params(0, device="cpu")
    unfused = tserve.pack_params(cfg, dense, plan=False)
    # the packer tuned lm_head for batch 4; the engine's batch is 8
    unfused["lm_head"]["w_packed"] = tplan.tune_packed(
        unfused["lm_head"]["w_packed"], m=4)
    once = tplan.plan_params(unfused, m=8)
    twice = tplan.plan_params(once, m=8)
    assert _entries(once) == _entries(twice)
    assert _genomes(once) == _genomes(twice)
    assert once["lm_head"]["w_packed"].plan.m_hint == 4
    assert all(g is not None and h in (4, 8) for g, h in _genomes(once))
    assert twice["lm_head"]["w_packed"] is once["lm_head"]["w_packed"]


def test_stacked_experts_tune():
    """deepseek's stacked experts tune as one launch over all E experts:
    the expert count is part of the tuned shape, and the group fuses."""
    cfg = _smoke("deepseek-moe-16b")
    dense = model_fns(cfg).init_params(0, device="cpu")
    packed = tserve.pack_params(cfg, dense)
    experts = next(lp["ffn"]["experts"] for lp in packed["layers"]
                   if "router" in lp["ffn"])
    wgi, wo = experts["wgi"]["w_group"], experts["wo"]["w_packed"]
    e = cfg.num_experts
    assert tplan.stacked_experts(wgi) == e and wgi.group_size == 2
    for pk, g in ((wgi, 2), (wo, 1)):
        knobs = tplan.launch_genome(pk.plan, 8)
        assert knobs is not None and pk.plan.genome["group_size"] == g
        n, k = pk.shape
        K.launch_plan(8, n, k, g, pk.block_shape, pk.kept_counts, SMS,
                      False, True, e, knobs)
    assert any(key[-2] == e for key in tplan._GENOME_CACHE)


def test_unknown_fitness_raises():
    with pytest.raises(ValueError, match="fitness"):
        tplan.tuned_genome(8, 64, 64, (16, 16), 8, 8, fitness="roofline")
    cfg = _smoke("llama3.2-1b")
    dense = model_fns(cfg).init_params(0, device="cpu")
    with pytest.raises(ValueError, match="fitness"):
        tserve.pack_params(cfg, dense, plan_fitness="tpu")


def test_wallclock_fitness_on_the_cpu_times_the_plain_path():
    """The wall-clock backend on CPU tensors: a legal genome gets a finite
    host time of the plain version, an illegal one inf; the tuner runs on
    it (the card times the kernel itself)."""
    fit = tbs.wallclock_plan_fitness(8, 64, 32, (16, 16), 8, 8, iters=2,
                                     repeats=2, device="cpu")
    legal = {"m_tile": 8, "config": 0, "split": True, "group_size": 2}
    assert math.isfinite(fit(legal)) and fit(legal) > 0
    assert math.isinf(fit({**legal, "m_tile": 64, "config": 1}))
