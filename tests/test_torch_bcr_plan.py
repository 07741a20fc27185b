"""The tensor-core BCR launch plan (``kernels/bcr_spmm.py:launch_plan``), a
pure function, pinned on the CPU at the llama3.2-1b serving shapes and the
smoke shapes: the grid fills an H100's 132 SMs at decode, every split gets
contraction blocks, every CTA fits in shared memory, ragged kept counts and
M = 1 get a legal plan, and a block no CTA can hold raises."""

import pytest

from repro_torch.core.bcr import BCRSpec
from repro_torch.kernels import bcr_spmm as K

SMS = 132                       # an H100 SXM's streaming multiprocessors
BLOCK = (128, 128)
KEPT = BCRSpec(block_shape=BLOCK, keep_frac=0.25, align=8).kept_counts()

# (name, N, K, G) at llama3.2-1b full width
FULL = [("wq", 2048, 2048, 1), ("wkv", 512, 2048, 2), ("wo", 2048, 2048, 1),
        ("wgi", 8192, 2048, 2), ("mlp_wo", 2048, 8192, 1),
        ("lm_head", 128256, 2048, 1)]
# the smoke config (d_model 64, 4/2 heads of 16, d_ff 128, vocab 512) at the
# serve CLI's smoke block 16
SMOKE_BLOCK = (16, 16)
SMOKE_KEPT = BCRSpec(block_shape=SMOKE_BLOCK, keep_frac=0.25,
                     align=4).kept_counts()
SMOKE = [("wq", 64, 64, 1), ("wkv", 32, 64, 2), ("wgi", 128, 64, 2),
         ("mlp_wo", 64, 128, 1), ("lm_head", 512, 64, 1)]
MS = [1, 8, 37, 300, 2048]
# ragged kept counts: the GPU tests' CASES (non-square blocks, kept counts
# of 1..2) and odd counts
RAGGED = [((16, 32), BCRSpec(block_shape=(16, 32), keep_frac=0.25,
                             align=4).kept_counts(), 64, 96),
          ((8, 8), BCRSpec(block_shape=(8, 8), keep_frac=0.05,
                           align=1).kept_counts(), 48, 40),
          ((128, 128), (3, 5), 256, 384), ((128, 128), (64, 24), 256, 384),
          # the paper's own workloads: the GRU's (8, 8) blocks at keep 0.1
          # and the im2col CNN's (8, 16) at keep 0.25
          ((8, 8), (2, 4), 1024, 1024), ((8, 16), (4, 8), 256, 2304)]


def _legal_short(plan, g, block, kept, int8):
    """A short-body plan: a compiled configuration, P = rows // br block
    rows a CTA, whole stages shared by the splits, and the Python mirror's
    shared-memory bytes."""
    br, bc = block
    assert K.short_body(block, g, plan.experts)
    assert (plan.m_tile, plan.slabs, plan.warps_m,
            plan.n_chunk) in K.SHORT_CONFIGS
    assert plan.rows == plan.n_chunk and plan.block_rows == plan.n_chunk // br
    assert (plan.warps_k * plan.n_chunk // (16 * plan.slabs) * plan.warps_m
            == plan.warps == K.SHORT_WARPS)
    n_st = -(-plan.nb_c // plan.stage_blocks)
    assert 1 <= plan.stage_blocks <= plan.nb_c and 1 <= plan.splits <= n_st
    assert plan.stages == min(K.SHORT_SLOTS, -(-n_st // plan.splits))
    assert plan.smem_bytes == K.short_smem_layout(
        plan.m_tile, plan.n_chunk, br, plan.stage_blocks, plan.stages, bc,
        kept[0], kept[1], int8, plan.warps_k)
    assert plan.workspace_floats == (0 if plan.splits == 1 else plan.tiles
                                     * plan.splits * plan.m_tile
                                     * plan.n_chunk)


def _legal_wg(plan, g, block, kept, int8):
    """A wide-body plan (the 128 M tile): 256 MMA rows over ``wg_span``
    flattened rows a CTA, row groups covering the G·N rows, the units such a
    window touches, and the Python mirror's shared-memory bytes."""
    br, bc = block
    assert (plan.m_tile, plan.slabs, plan.warps_m, plan.warps) in K.CONFIGS
    assert plan.m_tile == K.WG_M_TILE and plan.rows == K.WG_ROWS
    assert bc == K.WG_BC
    assert plan.n_chunk == K.wg_span(g, br) > 0
    q = g * plan.nb_r * br
    assert plan.chunks * plan.n_chunk >= q > (plan.chunks - 1) * plan.n_chunk
    assert plan.units == K.wg_units(plan.n_chunk, br)
    assert 3 <= plan.stages <= K.MAX_STAGES
    assert plan.smem_bytes == K.wg_smem_layout(
        plan.n_chunk, plan.stages, bc, br, kept[0], kept[1], int8,
        -(-plan.nb_c // plan.splits))
    assert plan.tiles == plan.experts * plan.chunks * plan.m_tiles


def _legal(plan, m, n, k, g, block, kept, int8):
    br, bc = block
    assert plan.m_tiles * plan.m_tile >= m > (plan.m_tiles - 1) * plan.m_tile
    assert plan.nb_r * br == n and plan.nb_c * bc == k
    assert plan.smem_bytes <= K.SMEM_LIMIT
    assert len(plan.args()) == 9
    if plan.body == "short":
        _legal_short(plan, g, block, kept, int8)
        return
    if plan.body == "wg":
        _legal_wg(plan, g, block, kept, int8)
        return
    assert plan.body == "tc" and plan.m_tile <= 64
    assert (plan.m_tile, plan.slabs, plan.warps_m, plan.warps) in K.CONFIGS
    assert plan.m_tiles * plan.m_tile >= m > (plan.m_tiles - 1) * plan.m_tile
    q = 16 * plan.slabs
    assert plan.n_chunk % q == 0 and plan.n_chunk >= q
    assert g * plan.n_chunk <= plan.rows          # every member row computed
    assert plan.chunks * plan.n_chunk >= br > (plan.chunks - 1) * plan.n_chunk
    assert plan.nb_r * br == n and plan.nb_c * bc == k
    assert 3 <= plan.stages <= K.MAX_STAGES
    assert plan.smem_bytes <= K.SMEM_LIMIT
    assert plan.smem_bytes == K.smem_layout(
        plan.m_tile, plan.n_chunk, plan.stages, g, bc, kept[0], kept[1],
        int8, plan.vec, -(-plan.nb_c // plan.splits))
    assert len(plan.args()) == 9


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("name,n,k,g", [s for s in FULL if s[1] == 2048])
def test_decode_grid_fills_the_card(name, n, k, g, m, int8):
    plan = K.launch_plan(m, n, k, g, BLOCK, KEPT, SMS, int8)
    assert plan.grid >= SMS
    assert plan.splits > 1          # 16 block rows alone leave SMs idle


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name,n,k,g", FULL + SMOKE)
def test_splits_cover_the_contraction(name, n, k, g, m, int8):
    block, kept = (BLOCK, KEPT) if (name, n, k, g) in FULL else (
        SMOKE_BLOCK, SMOKE_KEPT)
    plan = K.launch_plan(m, n, k, g, block, kept, SMS, int8)
    s, nb_c = plan.splits, plan.nb_c
    assert 1 <= s <= nb_c
    sizes = [(i + 1) * nb_c // s - i * nb_c // s for i in range(s)]
    assert sum(sizes) == nb_c and min(sizes) >= 1     # no empty split
    if plan.body == "wg":           # the wide body's wave-aware split
        assert s == K._wg_splits(plan.tiles, nb_c, SMS)
        assert s == 1 or 2 * plan.tiles <= SMS
    elif s > 1:                     # split only a grid under half the SMs
        assert 2 * plan.tiles <= SMS
    else:
        assert 2 * plan.tiles > SMS or nb_c == 1
    # the wide body's partial: 128 rows of its 256 MMA rows' floats
    rows = plan.rows if plan.body == "wg" else plan.n_chunk * g
    assert plan.workspace_floats == (0 if s == 1 else plan.tiles * s
                                     * plan.m_tile * rows)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name,n,k,g", FULL + SMOKE)
def test_plans_fit_a_cta(name, n, k, g, m, int8):
    block, kept = (BLOCK, KEPT) if (name, n, k, g) in FULL else (
        SMOKE_BLOCK, SMOKE_KEPT)
    plan = K.launch_plan(m, n, k, g, block, kept, SMS, int8)
    _legal(plan, m, n, k, g, block, kept, int8)
    assert plan.vec                 # serving and smoke rows: 16-byte copies


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("block,kept,n,k", RAGGED)
def test_ragged_kept_counts_get_a_legal_plan(block, kept, n, k, m, g, int8):
    plan = K.launch_plan(m, n, k, g, block, kept, SMS, int8)
    _legal(plan, m, n, k, g, block, kept, int8)
    if kept[1] % 8 and plan.body == "tc":
        # rows of C_keep bf16 values: plain loads (the short body copies
        # every tile run by cp.async, at any alignment)
        assert not plan.vec or int8


def test_serving_choices():
    """The configurations the main path launches: decode keeps the whole
    M = 8 in one n8 step; a 2048-row projection splits its 16 (or 64)
    contraction blocks; the gate/up pair covers both 128-row members in one
    CTA; prefill takes the wide body's 128-column wgmma tile, two 128-row
    units (block rows of a member) a CTA whatever G, three members
    included; lm_head fills the card alone."""
    lm = K.launch_plan(8, 128256, 2048, 1, BLOCK, KEPT, SMS)
    assert (lm.m_tile, lm.slabs, lm.splits, lm.n_chunk) == (8, 1, 1, 128)
    wq = K.launch_plan(8, 2048, 2048, 1, BLOCK, KEPT, SMS)
    assert (wq.splits, wq.grid) == (9, 144)
    wo = K.launch_plan(8, 2048, 8192, 1, BLOCK, KEPT, SMS)
    assert (wo.splits, wo.grid, wo.stages) == (9, 144, 8)
    wgi = K.launch_plan(8, 8192, 2048, 2, BLOCK, KEPT, SMS)
    assert (wgi.slabs, wgi.n_chunk, wgi.chunks, wgi.splits) == (2, 128, 1, 3)
    pre = K.launch_plan(2048, 8192, 2048, 2, BLOCK, KEPT, SMS)
    assert (pre.m_tile, pre.slabs, pre.warps_m, pre.warps) == (128, 2, 1, 8)
    assert (pre.body, pre.n_chunk, pre.chunks, pre.splits) == ("wg", 256, 64,
                                                               1)
    head = K.launch_plan(2048, 128256, 2048, 1, BLOCK, KEPT, SMS)
    assert (head.m_tile, head.body, head.n_chunk, head.units) == (128, "wg",
                                                                  256, 2)
    assert head.m_fast            # 131 MB of tiles stream once; x in L2
    qkv = K.launch_plan(2048, 2048, 2048, 3, BLOCK, KEPT, SMS)
    assert (qkv.m_tile, qkv.body, qkv.chunks) == (128, "wg", 24)


def test_plan_is_pure():
    a = K.launch_plan(8, 2048, 8192, 1, BLOCK, KEPT, SMS, True)
    K.launch_plan.cache_clear()
    assert K.launch_plan(8, 2048, 8192, 1, BLOCK, KEPT, SMS, True) == a


@pytest.mark.parametrize("block,kept", [((128, 4096), (128, 4096)),
                                        ((256, 2048), (256, 1024))])
def test_block_no_cta_holds_raises(block, kept):
    with pytest.raises(ValueError, match="shared memory"):
        K.launch_plan(8, block[0] * 2, block[1] * 2, 1, block, kept, SMS)


@pytest.mark.parametrize("kept", [(0, 4), (4, 0), (129, 4), (4, 129)])
def test_kept_counts_outside_the_block_raise(kept):
    with pytest.raises(ValueError, match="kept counts"):
        K.launch_plan(8, 256, 256, 1, BLOCK, kept, SMS)


def test_shape_not_whole_blocks_raises():
    with pytest.raises(ValueError, match="whole number"):
        K.launch_plan(8, 200, 256, 1, BLOCK, KEPT, SMS)


# -- the rule as it stood before the short-block body, kept here verbatim so
# the square serving blocks' plans are pinned field for field --------------

_OLD_CONFIGS = ((8, 1, 1, 8), (8, 2, 1, 8), (16, 1, 1, 8), (16, 2, 1, 8),
                (32, 1, 1, 8), (32, 2, 1, 8), (64, 2, 2, 8), (128, 4, 4, 8))


def _old_up(v, q):
    return -(-v // q) * q


def _old_smem(m_tile, n_chunk, stages, g, bc, r, c, int8_tiles, vec, wgmma,
              blocks):
    cp = _old_up(c, 16)
    row = (cp + 8) * 2
    ts = c * 2 if vec and not int8_tiles else row
    member = (_old_up(r * c, 16) if int8_tiles
              else _old_up(r * ts, 128) if vec else r * ts)
    off_cidx = (_old_up(g * member, 128) + _old_up(m_tile * bc * 2, 128)
                + _old_up(g * r * 4, 16))
    slot = _old_up(off_cidx + _old_up(g * c * 4, 16), 1024)
    main = stages * slot + 2 * g * m_tile * (128 if wgmma else row)
    if int8_tiles:
        main += 2 * g * r * row
    red = g * m_tile * (n_chunk + 4) * 4
    scales = _old_up(blocks * g * 4, 16) if int8_tiles else 0
    return (max(main, red) + _old_up(2 * g * n_chunk * 4, 16)
            + _old_up(row, 16) + 16 + _old_up(stages * 8, 16) + scales + 1024)


def _old_rule(m, n, k, g, block, kept, sms, int8_tiles):
    """``launch_plan(genome=None)`` before the short-block body (aligned
    operands, one unstacked pack, one shard)."""
    br, bc = block
    r, c = kept
    nb_r, nb_c = n // br, k // bc
    vec = (k % 8 == 0 and bc % 8 == 0 and bc <= 256 and r % 4 == 0
           and c % 4 == 0 and ((r * c) % 16 == 0 if int8_tiles
                               else c % 8 == 0 and r <= 256 and c <= 256))
    first = next(mt for mt in (8, 16, 32, 64, 128) if m <= mt or mt == 128)
    for mt in reversed([t for t in (8, 16, 32, 64, 128) if t <= first]):
        best = None
        for cmt, slabs, wm, nw in _OLD_CONFIGS:
            if cmt != mt or (wm == 4 and c > 64):
                continue
            rows = 16 * slabs * (nw // wm)
            q = 16 * slabs
            n_chunk = min(_old_up(br, q), (rows // g) // q * q)
            if n_chunk < q:
                continue
            chunks = -(-br // n_chunk)
            key = (chunks * rows - g * br, -slabs)
            if best is None or key < best[0]:
                best = (key, slabs, wm, nw, n_chunk, chunks)
        if best is None:
            continue
        _, slabs, wm, nw, n_chunk, chunks = best
        m_tiles = -(-m // mt)
        tiles = nb_r * chunks * m_tiles
        splits = 1 if 2 * tiles > sms else min(nb_c, -(-sms // tiles))
        blocks = -(-nb_c // splits)
        for stages in range(min(8, max(3, blocks + 1)), 2, -1):
            smem = _old_smem(mt, n_chunk, stages, g, bc, r, c, int8_tiles,
                             vec, wm == 4, blocks)
            if smem <= 232448:
                return K.LaunchPlan(mt, slabs, wm, nw, n_chunk, chunks,
                                    m_tiles, splits, stages, vec, smem, nb_r,
                                    nb_c, g)
    raise ValueError("no plan")


# the wide body's plans at the llama3.2-1b prefill shapes: (name, M) → for
# (bf16, int8) tiles (row groups, M tiles, splits, stages, M tile fastest,
# shared-memory bytes); every one 256 flattened rows a CTA, 2 units; the
# split is the wave-aware rule's (``_wg_splits``)
WG_PINS = {
    ("wq", 300): [(8, 3, 4, 3, 1, 223568), (8, 3, 4, 3, 0, 199024)],
    ("wq", 2048): [(8, 16, 1, 3, 0, 223568), (8, 16, 1, 3, 0, 199120)],
    ("wkv", 300): [(4, 3, 8, 3, 0, 223568), (4, 3, 8, 3, 0, 199008)],
    ("wkv", 2048): [(4, 16, 2, 3, 0, 223568), (4, 16, 2, 3, 0, 199056)],
    ("wo", 300): [(8, 3, 4, 3, 1, 223568), (8, 3, 4, 3, 0, 199024)],
    ("wo", 2048): [(8, 16, 1, 3, 0, 223568), (8, 16, 1, 3, 0, 199120)],
    ("wgi", 300): [(64, 3, 1, 3, 1, 223568), (64, 3, 1, 3, 1, 199120)],
    ("wgi", 2048): [(64, 16, 1, 3, 1, 223568), (64, 16, 1, 3, 0, 199120)],
    ("mlp_wo", 300): [(8, 3, 5, 3, 1, 223568), (8, 3, 5, 3, 0, 199104)],
    ("mlp_wo", 2048): [(8, 16, 1, 3, 0, 223568), (8, 16, 1, 3, 0, 199504)],
    ("lm_head", 300): [(501, 3, 1, 3, 1, 223568), (501, 3, 1, 3, 1, 199120)],
    ("lm_head", 2048): [(501, 16, 1, 3, 1, 223568),
                        (501, 16, 1, 3, 1, 199120)],
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name,n,k,g", FULL)
def test_square_block_plans_are_unchanged(name, n, k, g, m, int8):
    """Every 128 x 128 decode and verify plan (M up to 64) of the llama3.2-1b
    main path is, field for field, the plan of the rule before the
    short-block body and the wide body, and runs the tensor-core body; the
    prefill plans (M = 300, 2048) are the wide body's, pinned in
    ``WG_PINS``."""
    plan = K.launch_plan(m, n, k, g, BLOCK, KEPT, SMS, int8)
    if m <= 64:
        assert plan == _old_rule(m, n, k, g, BLOCK, KEPT, SMS, int8)
        assert plan.body == "tc" and plan.args() == _old_rule(
            m, n, k, g, BLOCK, KEPT, SMS, int8).args()
        return
    assert (plan.body, plan.m_tile, plan.n_chunk, plan.units) == (
        "wg", 128, 256, 2)
    assert (plan.chunks, plan.m_tiles, plan.splits, plan.stages,
            int(plan.m_fast), plan.smem_bytes) == WG_PINS[name, m][int8]
    _legal(plan, m, n, k, g, BLOCK, KEPT, int8)


# the paper's blocks and whisper's lm_head blocks at the shapes of PERF.md's
# rows 1g and 1h: (M, N, K, block, kept) → (M tile, rows, P block rows a
# CTA, splits, ring slots), then for (bf16, int8) tiles J, the blocks a
# stage, and the shared-memory bytes
SHORT_PINS = [
    (8, 51866, 1280, (2, 128), (1, 64), (8, 16, 8, 1, 3), (2, 2),
     (49552, 47248)),
    (32, 51866, 1280, (2, 128), (1, 64), (32, 16, 8, 1, 3), (2, 2),
     (87568, 85264)),
    (1, 1024, 1024, (8, 8), (2, 4), (8, 16, 2, 3, 2), (32, 32),
     (30736, 30224)),
    (32, 1024, 1024, (8, 8), (2, 4), (32, 16, 2, 3, 2), (32, 32),
     (56080, 55568)),
    (3136, 256, 2304, (8, 16), (4, 8), (128, 64, 8, 1, 3), (11, 12),
     (219152, 230544)),
    (25088, 256, 2304, (8, 16), (4, 8), (128, 128, 16, 1, 3), (8, 8),
     (219408, 209424)),
    (256, 32, 144, (8, 16), (4, 8), (128, 16, 2, 1, 1), (9, 9),
     (50832, 50320)),
]


@pytest.mark.parametrize("m,n,k,block,kept,want,js,smem", SHORT_PINS)
def test_short_block_plans_are_pinned(m, n, k, block, kept, want, js, smem):
    """The short body's rule at the served short blocks: decode takes 16
    rows a CTA (P = 16 // br block rows; whisper's 25933 block rows make
    3242 CTAs), the GRU at M = 1 splits its 128 contraction blocks over 3
    CTAs, prefill takes the most rows whose grid fills over half the card
    unsplit (VGG conv3: 64 rows at M = 3136, 128 at 25088), conv2's K = 144
    never splits, and J is the deepest stage shared memory holds."""
    for int8, j, want_bytes in zip((False, True), js, smem):
        plan = K.launch_plan(m, n, k, 1, block, kept, SMS, int8)
        assert plan.body == "short"
        assert (plan.m_tile, plan.n_chunk, plan.block_rows, plan.splits,
                plan.stages) == want
        assert (plan.stage_blocks, plan.smem_bytes) == (j, want_bytes)
        _legal(plan, m, n, k, 1, block, kept, int8)


SHORT_SHAPES = [((2, 128), (1, 64), 51866, 1280), ((8, 8), (2, 4), 1024, 1024),
                ((8, 16), (4, 8), 256, 2304), ((8, 16), (4, 8), 32, 144)]


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("block,kept,n,k", RAGGED + SHORT_SHAPES)
def test_short_body_routing(block, kept, n, k, m, g):
    """Exactly the G = 1, unstacked launches of blocks under 16 rows take
    the short body; grouped and expert-batched launches keep the tensor-core
    bodies (mma.sync, or the wide body at the 128 M tile;
    ``bcr_spmm_grouped`` and the MoE forms are out of the short body's
    scope)."""
    plan = K.launch_plan(m, n, k, g, block, kept, SMS)
    assert (plan.body == "short") == (block[0] < 16 and g == 1)
    _legal(plan, m, n, k, g, block, kept, False)
    if g == 1 and n * k <= 1 << 22:
        stacked = K.launch_plan(m, n, k, 1, block, kept, SMS, experts=2)
        assert stacked.body in ("tc", "wg")


def test_short_genomes_index_the_short_configurations():
    cfgs = K.short_configs(8)
    assert len(cfgs) == 3 and [c[2] for c in cfgs] == [16, 64, 128]
    for i, (slabs, wm, rows) in enumerate(cfgs):
        plan = K.launch_plan(8, 51866, 1280, 1, (2, 128), (1, 64), SMS,
                             genome=(8, i, False))
        assert (plan.body, plan.slabs, plan.warps_m, plan.n_chunk) == (
            "short", slabs, wm, rows)
    with pytest.raises(ValueError, match="short-body configurations"):
        K.launch_plan(8, 51866, 1280, 1, (2, 128), (1, 64), SMS,
                      genome=(8, 3, False))


# -- the wide body (the 128 M tile) at every served prefill shape ----------

# (label, M, N, K, G, block, kept, experts) of phases 3, 12, 14 and 15:
# llama3.2-1b, whisper-large-v3 at M = 12000 (8 utterances × 1500 frames),
# pixtral-12b and rwkv6-3b at M = 512, jamba (x_proj on 144 x 128 blocks),
# the expert forms at M = 240 (deepseek) and 160 (jamba) a expert
K25 = (64, 64)
PREFILL = [
    ("llama wgi", 2048, 8192, 2048, 2, BLOCK, K25, 1),
    ("llama lm_head", 2048, 128256, 2048, 1, BLOCK, K25, 1),
    ("whisper wqkv", 12000, 1280, 1280, 3, BLOCK, K25, 1),
    ("whisper cross wkv", 12000, 1280, 1280, 2, BLOCK, K25, 1),
    ("whisper wo", 12000, 1280, 1280, 1, BLOCK, K25, 1),
    ("whisper mlp wi", 12000, 5120, 1280, 1, BLOCK, K25, 1),
    ("whisper mlp wo", 12000, 1280, 5120, 1, BLOCK, K25, 1),
    ("pixtral wq", 512, 4096, 5120, 1, BLOCK, K25, 1),
    ("pixtral wkv", 512, 1024, 5120, 2, BLOCK, K25, 1),
    ("pixtral wgi", 512, 14336, 5120, 2, BLOCK, K25, 1),
    ("pixtral mlp_wo", 512, 5120, 14336, 1, BLOCK, K25, 1),
    ("rwkv6 wr", 512, 2560, 2560, 1, BLOCK, K25, 1),
    ("rwkv6 cm_wk", 512, 8960, 2560, 1, BLOCK, K25, 1),
    ("rwkv6 cm_wv", 512, 2560, 8960, 1, BLOCK, K25, 1),
    ("jamba in_proj", 512, 16384, 4096, 1, BLOCK, K25, 1),
    ("jamba x_proj", 1024, 288, 8192, 1, (144, 128), (72, 64), 1),
    ("jamba dt_proj", 512, 8192, 256, 1, BLOCK, K25, 1),
    ("jamba out_proj", 512, 4096, 8192, 1, BLOCK, K25, 1),
    ("deepseek experts wgi", 240, 1408, 2048, 2, BLOCK, K25, 64),
    ("deepseek experts wo", 240, 2048, 1408, 1, BLOCK, K25, 64),
    ("jamba experts wgi", 160, 14336, 4096, 2, BLOCK, K25, 16),
    ("jamba experts wo", 160, 4096, 14336, 1, BLOCK, K25, 16),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("label,m,n,k,g,block,kept,e", PREFILL)
def test_served_prefill_shapes_fit_a_cta(label, m, n, k, g, block, kept, e,
                                         int8):
    """Every served prefill shape gets a plan a CTA holds, its shared memory
    the Python mirror's layout; every 128 x 128 one runs the wide body (the
    128 M tile on wgmma), whatever G (x_proj's 144-row blocks, whose three
    units a window do not fit with a ring of 3, keep the 64 tile)."""
    plan = K.launch_plan(m, n, k, g, block, kept, SMS, int8, experts=e)
    _legal(plan, m, n, k, g, block, kept, int8)
    assert plan.experts == e and plan.vec
    if block == BLOCK:
        assert plan.body == "wg" and plan.m_tile == 128
    else:
        assert plan.body == "tc" and plan.m_tile == 64


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g,chunks", [(3, 15), (2, 10)])
def test_whisper_groups_reach_the_wgmma_tile(g, chunks, int8):
    """whisper's self-attention ``wqkv`` (G = 3) and cross ``wkv`` (G = 2)
    at M = 12000 run the 128 tile: 256 flattened rows a CTA (two 128-row
    units: for G = 3 members of a block row and the next block row's), one
    x block staged for both; 94 M tiles, the last of 96 rows; the row
    groups the grid's fastest axis (2.4 MB of tiles against 30.7 MB of x)."""
    plan = K.launch_plan(12000, 1280, 1280, g, BLOCK, K25, SMS, int8)
    assert (plan.body, plan.m_tile, plan.n_chunk, plan.units) == (
        "wg", 128, 256, 2)
    assert (plan.chunks, plan.m_tiles, plan.splits, plan.stages) == (
        chunks, 94, 1, 3)
    assert not plan.m_fast
    assert plan.grid == chunks * 94


def _wg_cover(plan, m, n, g, br, swiglu):
    """The output elements (expert, member, x row, column) the wide body's
    CTAs write, in the kernel's decode (``wg_body``: tile → row group and M
    tile by ``m_fast``; rows [q0, q0 + span) of the flattened G·N, row q
    being row q % br of block row (q // br) // G of member (q // br) % G;
    SwiGLU: gate row q and up row q + br of each pair of units); counted."""
    from collections import Counter
    span, qtot = plan.n_chunk, g * n
    seen = Counter()
    for ex in range(plan.experts):
        for tile in range(plan.chunks * plan.m_tiles):
            if plan.m_fast:
                mtile, rg = tile % plan.m_tiles, tile // plan.m_tiles
            else:
                mtile, rg = tile // plan.chunks, tile % plan.chunks
            m0 = mtile * plan.m_tile
            mt = min(plan.m_tile, m - m0)
            q0 = rg * span
            qn = min(span, qtot - q0)
            u0 = q0 // br
            outs = qn // 2 if swiglu else qn
            for o in range(outs):
                if swiglu:
                    pr, r = divmod(o, br)
                    mem, col = 0, (u0 // 2 + pr) * br + r
                else:
                    u, r = divmod(q0 + o, br)
                    i, mem = divmod(u, g)
                    col = i * br + r
                for mm in range(m0, m0 + mt):
                    seen[ex, mem, mm, col] += 1
    return seen


@pytest.mark.parametrize("m,n,g,e,swiglu", [
    (12000, 1280, 3, 1, False),      # whisper wqkv: the last M tile 96 rows
    (240, 1408, 2, 2, True),         # deepseek's experts: 112 rows an expert
    (300, 512, 2, 1, False),         # llama wkv under a split
    (300, 2048, 1, 1, False),
    (130, 384, 3, 1, False)])        # 1152 rows: a last row group of 128
def test_ragged_m_covers_every_output_once(m, n, g, e, swiglu):
    """Ragged M (a last M tile of 96, 112 or 44 rows) and a last row group
    under 256 rows: the wide body's CTAs write every output element exactly
    once, every unit a CTA touches within its plan's ``units``."""
    plan = K.launch_plan(m, n, 1280, g, BLOCK, K25, SMS, experts=e)
    assert plan.body == "wg"
    seen = _wg_cover(plan, m, n, g, BLOCK[0], swiglu)
    gy = 1 if swiglu else g
    assert len(seen) == e * gy * m * n and set(seen.values()) == {1}
    for rg in range(plan.chunks):
        q0 = rg * plan.n_chunk
        qn = min(plan.n_chunk, g * n - q0)
        assert (q0 + qn - 1) // BLOCK[0] - q0 // BLOCK[0] + 1 <= plan.units


# -- the fp32 body (fp32 x, CUDA cores) -------------------------------------

# (label, M, N, K, G, block, kept, experts): every fp32 row of PERF.md's
# rows 1g, 1f, 1e, 2e and the shapes phase 3's fp32 checks and the fp32
# phases give the body (whisper's (2, 128) lm_head, G = 2 and 3, stacked
# experts)
FP32_SHAPES = [
    ("GRU uz", 1, 1024, 1024, 1, (8, 8), (2, 4), 1),
    ("GRU uz", 32, 1024, 1024, 1, (8, 8), (2, 4), 1),
    ("conv2", 256, 32, 144, 1, (8, 16), (4, 8), 1),
    ("VGG conv3", 3136, 256, 2304, 1, (8, 16), (4, 8), 1),
    ("VGG conv3", 25088, 256, 2304, 1, (8, 16), (4, 8), 1),
    ("jamba x_proj", 8, 288, 8192, 1, (144, 128), (72, 64), 1),
    ("pixtral wq", 8, 4096, 5120, 1, BLOCK, K25, 1),
    ("pixtral wkv", 8, 1024, 5120, 2, BLOCK, K25, 1),
    ("pixtral wgi", 8, 14336, 5120, 2, BLOCK, K25, 1),
    ("pixtral lm_head", 8, 131072, 5120, 1, BLOCK, K25, 1),
    ("pixtral wgi", 512, 14336, 5120, 2, BLOCK, K25, 1),
    ("rwkv6 cm_wv", 8, 2560, 8960, 1, BLOCK, K25, 1),
    ("experts wo", 4, 2048, 1408, 1, BLOCK, K25, 64),
    ("experts wo", 228, 2048, 1408, 1, BLOCK, K25, 64),
    ("experts wgi", 228, 1408, 2048, 2, BLOCK, K25, 64),
    ("whisper lm_head", 8, 51866, 1280, 1, (2, 128), (1, 64), 1),
    ("whisper wqkv", 300, 1280, 1280, 3, BLOCK, K25, 1),
    ("smoke wgi", 5, 128, 64, 2, SMOKE_BLOCK, SMOKE_KEPT, 1),
    ("odd", 5, 111, 144, 1, (3, 16), (2, 8), 1),
]


def _legal_fp32(plan, m, n, k, g, block, kept, int8, e):
    """An fp32-body plan: a compiled configuration, warps within its most,
    the M tile its lanes and warps, whole gate/up pairs, whole stages per
    split, and the Python mirror's shared-memory bytes within a CTA's."""
    br, bc = block
    t, u, lm = plan.warp_rows, plan.lane_rows, plan.lanes_m
    assert plan.body == "fp32" and t == K.fp32_rows(br)
    assert (t, u) in K.FP32_CONFIGS
    chunks = -(-br // t)
    assert (plan.warps == plan.units * plan.row_chunks * plan.warps_m
            <= K.FP32_WARPS)
    assert plan.m_tile == plan.warps_m * lm * u and 32 % lm == 0
    assert m <= plan.m_tile * plan.m_tiles < m + plan.m_tile
    assert 1 <= plan.row_chunks <= chunks
    assert plan.chunks == -(-chunks // plan.row_chunks)
    assert plan.n_chunk == min(br, plan.row_chunks * t)
    if g == 2:
        assert plan.units % 2 == 0
    n_st = -(-plan.nb_c // plan.stage_blocks)
    assert 1 <= plan.stage_blocks <= plan.nb_c and 1 <= plan.splits <= n_st
    assert 1 <= plan.stages <= min(3, -(-n_st // plan.splits))
    for sp in range(plan.splits):       # every split walks a whole stage
        assert (sp + 1) * n_st // plan.splits - sp * n_st // plan.splits >= 1
    assert plan.smem_bytes == K.fp32_smem_layout(
        plan.m_tile, plan.units, plan.row_chunks, t, u, plan.stage_blocks,
        plan.stages, br, bc, kept[0], kept[1], int8) <= K.SMEM_LIMIT
    assert plan.tiles == (e * -(-plan.nb_r * g // plan.units) * plan.chunks
                          * plan.m_tiles)
    assert plan.vec == (kept[1] % 4 == 0 and not int8)
    assert len(plan.args()) == 12


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("label,m,n,k,g,block,kept,e", FP32_SHAPES)
def test_fp32_plans_fit_a_cta(label, m, n, k, g, block, kept, e, int8):
    """Every served fp32 shape gets a legal fp32-body plan within 227 KB of
    shared memory, fp32 and int8 tiles; the grid fills the card (split)
    wherever its output tiles fill under half of it."""
    plan = K.fp32_plan(m, n, k, g, block, kept, SMS, int8, True, e)
    _legal_fp32(plan, m, n, k, g, block, kept, int8, e)
    if 2 * plan.tiles <= SMS and plan.splits == 1:
        assert -(-plan.nb_c // plan.stage_blocks) == 1


@pytest.mark.parametrize("m,n,k,block,kept", [
    (1, 1024, 1024, (8, 8), (2, 4)), (32, 1024, 1024, (8, 8), (2, 4)),
    (8, 288, 8192, (144, 128), (72, 64)), (8, 4096, 5120, BLOCK, K25)])
def test_fp32_split_fills_the_card(m, n, k, block, kept):
    """The GRU at M = 1 and 32, jamba's x_proj and pixtral's wq at M = 8:
    too few output tiles for the card, so the stages are split over CTAs
    until the grid reaches the SM count."""
    plan = K.fp32_plan(m, n, k, 1, block, kept, SMS)
    assert plan.splits > 1 and plan.grid >= SMS
    assert 2 * plan.tiles <= SMS


def _fp32_cover(plan, m, n, g, br, swiglu):
    """The output elements (expert, member, x row, column) the fp32 body's
    CTAs write, in the kernel's decode (``f32::body``: tile → row group rg
    and M tile; rg → unit group and chunk group; warp item → unit and row
    chunk; the epilogue's rows of each unit; SwiGLU: gate unit 2k and up
    unit 2k + 1), counted."""
    from collections import Counter
    seen = Counter()
    units = plan.nb_r * g
    t, cr = plan.warp_rows, plan.row_chunks
    ugroups = -(-units // plan.units)
    groups = ugroups * plan.chunks
    for ex in range(plan.experts):
        for tile in range(groups * plan.m_tiles):
            rg, mtile = tile % groups, tile // groups
            ug, c0 = rg // plan.chunks, (rg % plan.chunks) * cr
            u0, m0 = ug * plan.units, mtile * plan.m_tile
            mt = min(plan.m_tile, m - m0)
            ru = plan.n_chunk
            for kk in range(plan.units // 2 if swiglu else plan.units):
                for lr in range(ru):
                    row = c0 * t + lr
                    u = u0 + (2 * kk if swiglu else kk)
                    if u >= units or row >= br:
                        continue
                    i, mem = (u // 2, 0) if swiglu else divmod(u, g)
                    for mm in range(m0, m0 + mt):
                        seen[ex, mem, mm, i * br + row] += 1
    return seen


@pytest.mark.parametrize("m,n,g,block,kept,e,swiglu", [
    (300, 1280, 3, BLOCK, K25, 1, False),    # a last M tile of 44 rows
    (5, 1408, 2, BLOCK, K25, 2, True),       # SwiGLU pairs, stacked experts
    (8, 288, 1, (144, 128), (72, 64), 1, False),   # chunk groups of 80 + 64
    (33, 1000, 1, (8, 8), (2, 4), 1, False),  # a last group of 13 units
    (5, 111, 1, (3, 16), (2, 8), 1, False),   # T = 2 over 3-row blocks
    (1, 2002, 1, (2, 128), (1, 64), 1, False)])
def test_fp32_ragged_outputs_written_once(m, n, g, block, kept, e, swiglu):
    """Ragged M, a last unit group, chunk groups and SwiGLU pairs: the fp32
    body's CTAs write every output element exactly once."""
    k = 8 * block[1]
    plan = K.fp32_plan(m, n, k, g, block, kept, SMS, experts=e)
    seen = _fp32_cover(plan, m, n, g, block[0], swiglu)
    gy = 1 if swiglu else g
    assert len(seen) == e * gy * m * n and set(seen.values()) == {1}


def test_fp32_plan_raises_on_bad_shapes():
    with pytest.raises(ValueError, match="whole number"):
        K.fp32_plan(8, 100, 128, 1, (8, 8), (2, 4), SMS)
    with pytest.raises(ValueError, match="do not fit"):
        K.fp32_plan(8, 128, 128, 1, (8, 8), (9, 4), SMS)
    assert K.fp32_plan(8, 128, 128, 1, (8, 8), (2, 4), SMS) is \
        K.fp32_plan(8, 128, 128, 1, (8, 8), (2, 4), SMS)


# the fp32 body's plans at PERF.md's fp32 rows (rows 1g, 1f, 1e, 2e): (label,
# M) → fp32 tiles' (M tile, T, U, lanes across M, warps across M, units,
# row chunks, J, splits, ring slots), then the shared-memory bytes of (fp32,
# int8) tiles: the Python mirror's, which the CUDA launcher's own layout
# must equal (it refuses a plan that disagrees, returning -1) on the card
FP32_PINS = {
    ("GRU uz", 1): ((1, 8, 1, 1, 1, 8, 1, 14, 9, 2), (21264, 24592)),
    ("GRU uz", 32): ((32, 8, 1, 32, 1, 8, 1, 14, 9, 2), (50192, 53520)),
    ("conv2", 256): ((64, 8, 1, 32, 2, 4, 1, 9, 1, 1), (47760, 53776)),
    ("VGG conv3", 3136): ((128, 8, 4, 32, 1, 16, 1, 9, 3, 2),
                          (218896, 230672)),
    ("VGG conv3", 25088): ((128, 8, 4, 32, 1, 16, 1, 9, 1, 2),
                           (218896, 230672)),
    ("jamba x_proj", 8): ((8, 16, 4, 2, 1, 1, 5, 1, 33, 2), (51536, 61008)),
    ("pixtral wq", 8): ((8, 16, 4, 2, 1, 2, 8, 2, 9, 2), (164112, 228112)),
    ("pixtral wkv", 8): ((8, 16, 4, 2, 1, 2, 8, 2, 17, 2),
                         (164112, 197136)),
    ("pixtral wgi", 8): ((8, 16, 4, 2, 1, 2, 8, 2, 1, 2), (164112, 228112)),
    ("pixtral lm_head", 8): ((8, 16, 4, 2, 1, 2, 8, 2, 1, 2),
                             (164112, 228112)),
    ("pixtral wgi", 512): ((128, 16, 4, 32, 1, 2, 8, 1, 1, 2),
                           (206096, 222736)),
    ("experts wo", 228): ((128, 16, 4, 32, 1, 2, 8, 1, 1, 2),
                          (206096, 222736)),
    ("experts wgi", 228): ((128, 16, 4, 32, 1, 2, 8, 1, 1, 2),
                           (206096, 222736)),
}
FP32_ROWS = [row for row in FP32_SHAPES if (row[0], row[1]) in FP32_PINS]


@pytest.mark.parametrize("label,m,n,k,g,block,kept,e", FP32_ROWS)
def test_fp32_row_plans_are_pinned(label, m, n, k, g, block, kept, e):
    """The fp32 rule at the timed fp32 rows: the GRU splits 9 ways over 16
    CTAs of 8 block rows, VGG conv3 takes 16 block rows a CTA at the 128 M
    tile (2 slots of 9 blocks), conv2 never splits, x_proj cuts its block
    rows into chunk groups, pixtral's decode takes 4 x rows a lane, and the
    shared-memory bytes are the layout mirror's."""
    want, smem = FP32_PINS[label, m]
    assert len(FP32_ROWS) == len(FP32_PINS)
    for int8, want_bytes in zip((False, True), smem):
        plan = K.fp32_plan(m, n, k, g, block, kept, SMS, int8, True, e)
        _legal_fp32(plan, m, n, k, g, block, kept, int8, e)
        assert plan.smem_bytes == want_bytes
        if not int8:
            assert (plan.m_tile, plan.warp_rows, plan.lane_rows,
                    plan.lanes_m, plan.warps_m, plan.units, plan.row_chunks,
                    plan.stage_blocks, plan.splits, plan.stages) == want
