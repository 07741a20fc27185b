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


def _legal(plan, m, n, k, g, block, kept, int8):
    br, bc = block
    assert plan.m_tiles * plan.m_tile >= m > (plan.m_tiles - 1) * plan.m_tile
    assert plan.nb_r * br == n and plan.nb_c * bc == k
    assert plan.smem_bytes <= K.SMEM_LIMIT
    assert len(plan.args()) == 9
    if plan.body == "short":
        _legal_short(plan, g, block, kept, int8)
        return
    assert plan.body == "tc"
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
        int8, plan.vec, plan.warps_m == K.WGMMA_WARPS_M,
        -(-plan.nb_c // plan.splits))
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
    if s > 1:                       # split only a grid under half the SMs
        assert 2 * plan.tiles <= SMS
    else:
        assert 2 * plan.tiles > SMS or nb_c == 1
    assert plan.workspace_floats == (0 if s == 1 else plan.tiles * s * g
                                     * plan.m_tile * plan.n_chunk)


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
    CTA; prefill takes the 128-column wgmma tile (three members, whose
    64-row warpgroup slabs do not fit it, the 64 tile); lm_head fills the
    card alone."""
    lm = K.launch_plan(8, 128256, 2048, 1, BLOCK, KEPT, SMS)
    assert (lm.m_tile, lm.slabs, lm.splits, lm.n_chunk) == (8, 1, 1, 128)
    wq = K.launch_plan(8, 2048, 2048, 1, BLOCK, KEPT, SMS)
    assert (wq.splits, wq.grid) == (9, 144)
    wo = K.launch_plan(8, 2048, 8192, 1, BLOCK, KEPT, SMS)
    assert (wo.splits, wo.grid, wo.stages) == (9, 144, 8)
    wgi = K.launch_plan(8, 8192, 2048, 2, BLOCK, KEPT, SMS)
    assert (wgi.slabs, wgi.n_chunk, wgi.chunks, wgi.splits) == (2, 128, 1, 3)
    pre = K.launch_plan(2048, 8192, 2048, 2, BLOCK, KEPT, SMS)
    assert (pre.m_tile, pre.slabs, pre.warps_m, pre.warps) == (128, 4, 4, 8)
    assert (pre.n_chunk, pre.chunks, pre.splits) == (64, 2, 1)
    head = K.launch_plan(2048, 128256, 2048, 1, BLOCK, KEPT, SMS)
    assert (head.m_tile, head.warps_m, head.n_chunk) == (128, 4, 128)
    qkv = K.launch_plan(2048, 2048, 2048, 3, BLOCK, KEPT, SMS)
    assert qkv.m_tile == 64 and 3 * qkv.n_chunk <= qkv.rows


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


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name,n,k,g", FULL)
def test_square_block_plans_are_unchanged(name, n, k, g, m, int8):
    """Every 128 x 128 plan of the llama3.2-1b main path is, field for
    field, the plan of the rule before the short-block body, and runs the
    tensor-core body."""
    plan = K.launch_plan(m, n, k, g, BLOCK, KEPT, SMS, int8)
    assert plan == _old_rule(m, n, k, g, BLOCK, KEPT, SMS, int8)
    assert plan.body == "tc" and plan.args() == _old_rule(
        m, n, k, g, BLOCK, KEPT, SMS, int8).args()


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
    body (``bcr_spmm_grouped`` and the MoE forms are out of its scope)."""
    plan = K.launch_plan(m, n, k, g, block, kept, SMS)
    assert (plan.body == "short") == (block[0] < 16 and g == 1)
    _legal(plan, m, n, k, g, block, kept, False)
    if g == 1 and n * k <= 1 << 22:
        stacked = K.launch_plan(m, n, k, 1, block, kept, SMS, experts=2)
        assert stacked.body == "tc"


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
