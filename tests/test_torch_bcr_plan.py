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


def _legal(plan, m, n, k, g, block, kept, int8):
    br, bc = block
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
    if kept[1] % 8:                 # rows of C_keep bf16 values: plain loads
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
