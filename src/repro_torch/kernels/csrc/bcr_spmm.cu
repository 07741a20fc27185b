// BCR block-sparse matmul over TBCRC-packed weights, written for Hopper
// (sm_90a), bound to Python through ctypes (kernels/bcr_spmm.py).
//
// Replaces the reference package's TPU kernels in kernels/bcr_spmm.py:
//   * bcr_spmm          (bodies _kernel_idx, _block_update)
//   * bcr_spmm_grouped  (bodies _grouped_kernel_idx, _grouped_emit)
//
// What it computes: y[M, N] = x[M, K] @ W.T for a balanced-BCR weight W
// (N, K) cut into (br, bc) blocks, each of which keeps R_keep whole rows and
// C_keep whole columns stored as a dense (R_keep, C_keep) tile plus the
// block-local row/col indices. The grouped form runs G same-shaped weights
// over one x, adds a (G, N) fp32 bias, and either emits (G, M, N) or, for a
// gate/up pair, silu(acc0) * acc1 as (M, N). Both forms take E stacked
// experts in one launch (an MoE layer's experts, the reference's vmap over
// its pallas_call): x (E, M, K), the packed operands, scales and bias with
// a leading E, y (E, ...); the expert is the grid's last axis. Tiles come
// in x's dtype (the fp form) or as int8 codes with one fp32 scale per kept
// tile (the int8 form, the reference's quantized serving:
// plan.block_scales), whose scale multiplies the block's fp32 partial, as
// the reference's _block_update does.
//
// Four bodies: the fp32 body under fp32 x (CUDA cores); under bf16 x, the
// short-block body for blocks shorter than one m16 slab (G = 1), the wide
// body at the 128-row M tile (prefill), else the tensor-core body (M tiles
// of 8..64: decode, verify, short prefill).
//
// bf16 x at M tiles of 8..64 (the serving path's decode and verify; fp
// and int8 tiles) — namespace tc, tensor cores. What bounds it on this
// card: at decode (M = 1..8) the bytes of the packed tiles (keep_frac of
// the dense weight, read once; half as many under int8) and, at 1 to 16
// contraction blocks a CTA, the latency of each block's short chain of
// copies and shared-memory steps. What the design does:
//   * y^T = W_tile · x_g^T per block, the weight as the wide operand: the
//     output rows are the MMA's M side and the M tile its N side.
//     mma.sync.aligned.m16n8k16 bf16 → fp32 with both operands by
//     ldmatrix, x's kept columns gathered into B's layout while the
//     previous block multiplies. int8 codes
//     are widened in shared memory with their tile's scale folded in,
//     bf16(code × scale): one rounding of at most 2^-9 relative per weight,
//     against the 2e-2 × output-scale tolerance. (The reference scales each
//     block's fp32 partial; a temporary accumulator per block in that order
//     doubled the accumulator registers, spilled at the 128-column tile and
//     cost more per block than the widening pass.)
//   * The row scatter costs no barrier: the whole (rows × M tile) fp32
//     accumulator stays in registers, and each output row's A operand is
//     read, by ldmatrix's per-lane row addresses, from the staged tile row
//     its block keeps there, or from a zero row. An inverse row map
//     (output row → kept row), tagged with the block's number so stale
//     entries read as "not kept", is rebuilt per block from row_idx. Rows
//     no index reaches are exact zeros. This does br/R_keep = 2× the kept
//     MMA work at the serving block.
//   * Copies are asynchronous, into a ring of 3 to 8 stages with one
//     mbarrier each: a producer warp's lane issues per block one TMA copy
//     of the x block (rows past M arrive as zeros, or over stacked
//     experts as the next expert's rows: either feeds only output columns
//     never written), one TMA copy per bf16
//     tile (rows 128-byte swizzled when C_keep = 64, so ldmatrix reads
//     them without bank conflicts) or one bulk copy per int8 tile (never
//     widened in device memory), and bulk copies of the indices. One block
//     barrier per contraction block separates the preparation of block j+1
//     (inverse map, x's kept columns gathered into B's layout, int8
//     widening; double-buffered) from the products of block j. Operands
//     the copies cannot take (rows that are not 16-byte multiples: kept
//     counts of 1..16 at smoke sizes) take plain loads through the same
//     ring.
//   * Stacked experts (MoE): one launch, the expert the grid's second axis
//     (E × the plan's grid). A CTA adds its expert to its tile, x-row,
//     output, bias, workspace and counter indices, always from the launch's
//     base pointers: offsetting the base pointers per expert instead put
//     them in vector registers and slowed the unstacked decode launches by
//     up to 70% (lm_head M=8 0.106 → 0.178 ms on an H100, PERF.md §6). The
//     expert index is a template flag (STACKED) of its own instantiations,
//     so an unstacked launch runs code with no expert arithmetic at all:
//     even the index form cost wq at M=32 15% against the code before it.
//     The plan (M tile, split) counts every expert's output tiles; at decode
//     an MoE layer's 64 experts × 11 or 16 block rows fill the card
//     unsplit.
//   * At small M a grid of (block rows × M tiles) leaves most SMs idle, so
//     where the output tiles number at most half the SMs the contraction
//     blocks of each tile are split over S CTAs of the same launch. Each
//     writes its fp32 partial to a workspace and bumps the tile's counter;
//     the last to arrive sums the S partials in split order (so y does not
//     depend on arrival order), applies bias and SwiGLU, writes y and puts
//     the counter back to 0. No second kernel, no atomics on y.
//   * The M tile, the warp layout, the output rows per CTA, S and the ring
//     depth come from kernels/bcr_spmm.py:launch_plan; the launcher checks
//     the plan's shared-memory total against its own layout and encodes
//     the tensor maps.
//   * Which shapes leave this body: a G = 1 launch of one unstacked pack
//     whose blocks are shorter than one m16 slab (br < 16) takes the
//     short-block body below. Here one CTA owns one block row, so such a
//     block row fills at most 16 of a CTA's MMA rows (2 of them for
//     whisper's (2, 128) lm_head blocks), pads C_keep 4 or 8 to the k of
//     16, and walks its contraction blocks one block barrier each: 25933
//     CTAs for whisper's lm_head, 128 serial blocks for the GRU's (8, 8).
//     And the 128-row M tile takes the wide body.
//
// bf16 x at the 128-row M tile (prefill: whisper's encoder at M = 12000,
// a cold admission's thousands of rows, the expert forms at M = 160..240;
// blocks of 128 columns, any G, bias, SwiGLU, stacked experts) — the wide
// body (tc::wg_body). What bounds it on this card: the shared-memory pipe
// and the L2 → SM stream. Gathering x's kept columns per block row would
// read the x block from L2 once for each block row (lm_head at M = 2048:
// ~10 GB for 16032 CTAs) and gather it with one shared-memory instruction a
// pair of elements; and 3 members' 64-row warpgroup slabs do not fit one
// block row's 128-row CTA. Here a 128 x 128 block costs a CTA 48 KB of
// copies and ~2.6K shared-memory wavefronts (wgmma's B reads, A's
// ldmatrix, the expansion, the copies' writes) against 2K cycles of
// tensor-core work. What the design does:
//   * The tile is expanded, not x: each staged kept tile is written across
//     its block's 128 columns (zero but at its C_keep kept columns; int8
//     widened with its scale folded in, as above), and B is x's dense block
//     exactly as TMA copies it (two 128-byte-swizzled atoms of 64 columns,
//     K-major), read by wgmma's descriptor: no gather of x at all. A warp
//     zeroes its rows with 16-byte stores and writes each kept value once,
//     a lane a pair of kept columns (their indices read once a unit). The
//     MMA then does br/R_keep × bc/C_keep = 4× the kept work at the
//     serving block (dense-equivalent), at the tensor cores' rate.
//   * One CTA computes 256 MMA rows over the flattened output rows (row q
//     of the G·N is row q % br of block row (q / br) / G of member
//     (q / br) % G), so whatever G, a CTA's rows are two 128-row units
//     (members of one block row, or adjacent block rows; SwiGLU: whole
//     gate/up pairs) sharing one staged x block: the L2 → SM bytes of x
//     per MMA fall 2× against one block row a CTA, and 3 members never
//     mean 4 row chunks. Two warpgroups own 128 rows each as two m64 slabs
//     by all 128 columns: wgmma.mma_async m64n128k16, A (each output row's
//     expanded kept row, or a zero row: the inverse row map tagged with the
//     block, as above) in registers by ldmatrix, B by descriptor.
//   * Two rings of 3 slots, one mbarrier a slot: x blocks (two TMA copies a
//     block; rows past M arrive as zeros or the next expert's rows, feeding
//     only columns never written), read by the block's products, and each
//     unit's tile and indices (bulk copies), read one block earlier by the
//     expansion; each refilled two blocks ahead of its reader. A stage's
//     copies go out from lane 0 of all 8 warps, a copy each (one warp
//     issuing them all held its warpgroup back), once one thread has armed
//     the slot's barrier (right after its previous phase completed); plain
//     loads where operands are not 16-byte aligned. One block barrier a
//     block; a block's products (two commit groups, one per 64-column
//     atom) run while the warps expand the next block into the other
//     buffer (straight-line code for the serving tiles, C_keep = 64: the
//     general loop's branches cost far more than the shared-memory
//     instructions it issues).
//   * Grid: (row group, M tile), the M tile fastest where the packed tiles
//     outweigh x (lm_head: its 131 MB stream from device memory once while
//     x stays in L2), else the row groups (whisper: each x block read from
//     device memory once); experts on the grid's second axis; the split
//     over contraction blocks (workspace, counters, split-order sum) as
//     above, its count the one with the fewest rounds of blocks (waves
//     times blocks a CTA, plus a CTA's and a split's fixed cost); the last
//     split adds its own partial from shared memory, in split order.
//   * Tried on the card and dropped, both slower (PERF.md §6): persistent
//     CTAs over a stream of tiles (the item state spilled at 255
//     registers), issuing a block's refills behind its products.
//
// bf16 x, blocks shorter than one m16 slab (G = 1, unstacked) — the
// short-block body (tc::bcr_spmm_short_tc), the reference's planes form
// (_kernel_planes / _block_update: gather one-hot → tile → scatter
// one-hot), done in shared memory. What bounds it on this card: at decode
// the bytes of the kept tiles and their index runs (col_idx's int32 is two
// thirds of whisper's lm_head bytes) and each CTA's latency from its first
// copy to its output; at prefill the expanded tiles' products and the
// scatter that builds them. What the design does:
//   * One CTA owns P = rows / br consecutive block rows (rows 16, 64 or
//     128: the MMA's M side), so P·br output rows fill the MMA's rows; a
//     last group of fewer block rows masks the missing ones (never read).
//   * The tile is expanded, not x: each stage's kept tiles are written
//     across their whole blocks into a zeroed A operand (rows × J·bc, row
//     p·br + row_idx, column jj·bc + col_idx; int8 codes widened with
//     their tile's scale folded in, bf16(code × scale), as above). The B
//     operand is then x's dense (M tile × J·bc) block, staged once a stage
//     for all P block rows: no per-block-row gather of x. It costs
//     br/R_keep × bc/C_keep the kept MMA work (4× whisper, 8× the GRU, 4×
//     VGG conv3), free at decode. A is double-buffered: one buffer is
//     zeroed while the other is filled, so no element is cleared one by
//     one.
//   * A stage carries J contraction blocks (J·bc up to 256 columns) for
//     all P block rows, with two block barriers a stage (one after its
//     copies land, one after its scatter), not one a block. Stages are
//     filled by 16-byte cp.async from every thread into a ring of three
//     slots, two stages in flight ahead of the one computed: the x block
//     (zeros past M and past the stage's columns), and for each block row
//     its runs of J·R_keep·C_keep tile values, index runs (and scales),
//     each copied as the 16-byte-aligned chunks that cover it and read back
//     at the run's offset mod 16. So any kept count and alignment copies
//     asynchronously: R_keep 1 and 2 no longer fall to plain loads. (Only
//     x rows that are not 16-byte multiples load x plainly.)
//   * mma.sync m16n8k16 at every M tile: warp (wr, wm, wk) owns slabs ×
//     n8 tiles and every wk-th k16 step of the stage (at 16 rows the 8
//     warps share the k steps; their partials are summed in order at the
//     end). At decode the kernel is bytes- and latency-bound, so wgmma
//     would buy nothing there; at the VGG prefill it stays on mma.sync
//     too: there the scatter and the barriers, not the MMA rate, bound it
//     (PERF.md §6, row 1g).
//   * Grid: P block rows × M tile a CTA, the M tile's groups side by side
//     (its x block read from device memory once). Where that leaves under
//     half the SMs and K spans two full stages (the GRU at M = 1: 64
//     CTAs), the stages are split over CTAs with the workspace, counters
//     and split-order sum above. A decode CTA is small (16 rows: whisper
//     49.5 KB of shared memory), so four share an SM and hide each other's
//     copy latency; launch_plan picks 16 rows at decode and, at the 128 M
//     tile, the most rows whose grid fills over half the SMs unsplit.
//
// fp32 x (fp32 tiles, or int8 tiles under fp32 x: GRIM's own GRU and im2col
// CNN, whose examples and reference default to fp32, and every fp32 check of
// the port) — the fp32 body (namespace f32, bcr_spmm_fp32 /
// bcr_spmm_grouped_fp32). Its 1e-4 tolerance rules out bf16 operands and
// plain TF32 (about 3 decimal digits). 3xTF32 (a big and a small TF32 part,
// three MMAs) keeps fp32's accuracy, but the MMA needs each tile expanded to
// its block, br/R_keep × bc/C_keep the kept work (8× at the GRU's (8, 8)
// keeping 2 x 4, 4× at VGG's (8, 16) keeping 4 x 8 and at the 128 blocks);
// at 495 / 3 = 165 TFLOP/s that loses to kept-only FFMA at 67 TFLOP/s
// wherever the expansion is 2.5× or more, every served block. So the body
// does kept work only, on the CUDA cores. What bounds it on this card: at
// decode the bytes of the kept tiles (read once) and each CTA's latency from
// its first copy to its output; at prefill the shared-memory wavefronts of
// the gather of x's kept columns (C_keep loads feed R_keep kept rows' FMAs,
// so at R_keep = 4 one wavefront a clock per SM matches the FMA pipe) and
// the fp32 FMAs. What the design does:
//   * A CTA owns nu units (a unit: one member's block row; u = i·G + g, so a
//     gate/up pair is two adjacent units) × cr chunks of T output rows of
//     each × one M tile: P·br output rows, so every thread has work at
//     GRIM's (8, 8) and (8, 16) blocks, and x's staged block serves every
//     unit (its L2 → SM bytes fall nu× against a CTA a block row).
//   * Register blocking: a warp item is T output rows of one unit (T = 2, 8
//     or 16) by the warp's slice of the M tile; a lane holds T × U fp32
//     accumulators. Lanes split as LM across x rows (U rows each) × LK = 32
//     / LM sharing the contraction (LC over a block's 4-column chunks, LB
//     over the stage's blocks), reduced by shuffles in a fixed order at the
//     end; so at M = 1..32 the lanes share the contraction where a lane
//     holds 4 x rows or a block spans few chunks, at prefill they all take
//     x rows. x is staged transposed (a column's M tile rows contiguous), so
//     per 4-column chunk a lane reads its rows of each kept column as one
//     16-byte load at U = 4 (column offsets from one int4; conflict-free),
//     then for each of its T rows whose block keeps it one float4 of the
//     kept row (a broadcast), issued for a group of rows before their FMAs.
//     The row map is inverse: output row → 16 + its kept row's byte offset
//     in the block's tile (0: not kept), ushorts read as one or two 16-byte
//     loads a block. A row the block does not keep is a branch over its load
//     and products, warp-uniform when the lanes share a block (LB = 1), not
//     a product with a zero row (br/R_keep = 2× the FMAs at the served
//     blocks). No shared-memory scatter, no barrier per block.
//   * Stages of J contraction blocks (J·bc up to 256 columns) for all nu
//     units, in a ring of three slots filled two stages ahead of the one
//     computed (two slots, one ahead, where that allows a deeper stage:
//     VGG's prefill, the 128 blocks at decode and prefill; all of a split's
//     stages at once where the ring holds them) by cp.async from every
//     thread: x by 4-byte copies (transposing it), fp32 tile runs by
//     16-byte copies (where vals is
//     16-byte aligned and C_keep a multiple of 4, the run of J tiles is the
//     staged layout itself; else 4-byte copies into zero-padded rows), int8
//     codes, indices and scales as the 16-byte chunks that cover each run.
//     Two barriers a stage: one after its copies land, then one after a
//     pass builds the stage's inverse row maps and column offsets
//     (double-buffered: the other buffer is cleared in the same pass) and,
//     under int8 tiles, widens the codes with their tile's scale folded in,
//     fp32(code × scale): one rounding of at most 2^-24 relative, far inside
//     1e-4 (the reference scales each block's partial instead).
//   * Where the output tiles fill at most half the SMs, the stages are
//     split over S CTAs of the same launch (workspace, counters and the last
//     arriver's split-order sum, as above; the last split reads the
//     partials eight at a time): the GRU at M = 1 (16 CTAs of 8 block rows,
//     split 9 ways: 144), jamba's x_proj at M = 8 (its 2 block rows of 144
//     cut into 4 row groups of 80 and 64 rows, split 33 ways).
//   * Stacked experts on the grid's second axis (blockIdx.y), the operands
//     offset by the expert; bias and SwiGLU in the epilogue, which reads the
//     CTA's fp32 tile from shared memory (aliasing the ring).
//   * The M tile, T, U, the lanes and warps across it, nu, cr, J, S, the
//     ring and the shared-memory bytes come from kernels/bcr_spmm.py:
//     fp32_plan; the launcher checks the plan's shared-memory total against
//     its own layout (Layout below) and refuses a plan that disagrees.

#include <string.h>

#include "hopper.cuh"

// ===========================================================================
// bf16-activation forms: tensor cores
// ===========================================================================

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kTagShift = 12;   // inverse row map entry: (block << 12) | row

// The launch plan kernels/bcr_spmm.py:launch_plan chose, in the order of its
// LaunchPlan.args().
struct Plan {
  int mt, slabs, warps_m, n_chunk, chunks, splits, stages, vec, smem;
};

__host__ __device__ inline int up16(int v) { return (v + 15) / 16 * 16; }

// Byte offsets of shared memory, as kernels/bcr_spmm.py:smem_layout
// computes them (the launcher refuses a plan whose total disagrees).
struct Layout {
  int cp, as;                 // C_keep padded to 16; padded row (elements)
  int ts, swz;                // staged bf16 tile row stride (bytes); 128B swizzle
  int bs_row;                 // gathered-x row stride (bytes)
  int tile_member;            // bytes of one member's tile in a stage
  int slot;                   // bytes of one ring stage
  int off_x, off_ridx, off_cidx;           // within a stage
  int off_bs, off_aconv, off_inv, off_zero, off_flag, off_bar, off_scales;
  int total;
};

struct Shape {
  int M, K, N, G, nb_r, nb_c, br, bc, R, C, m_tiles, E;
  int int8_tiles, swiglu, grouped;
  Plan p;
  Layout l;
};

__host__ __device__ inline int up(int v, int q) { return (v + q - 1) / q * q; }

// Stage rows: a bf16 tile copied by TMA is dense (C_keep · 2 bytes a row,
// 128-byte swizzled when that is exactly 128 bytes); tiles of the plain-load
// path are padded to Cp + 8 elements a row. Stages are 1024-byte aligned
// (the swizzle's unit); the total carries 1024 bytes of alignment slack.
inline Layout make_layout(const Shape& s) {
  Layout l;
  l.cp = up16(s.C);
  l.as = l.cp + 8;
  const int row = l.as * 2;
  const bool tma_tile = s.p.vec && !s.int8_tiles;
  l.ts = tma_tile ? s.C * 2 : row;
  l.swz = tma_tile && s.C * 2 == 128 && s.R % 8 == 0;
  // a member's bf16 tile lands where TMA can write it: 128-byte aligned
  l.tile_member = s.int8_tiles ? up16(s.R * s.C)
                  : tma_tile   ? up(s.R * l.ts, 128)
                               : s.R * l.ts;
  l.off_x = up(s.G * l.tile_member, 128);
  l.off_ridx = l.off_x + up(s.p.mt * s.bc * 2, 128);
  l.off_cidx = l.off_ridx + up16(s.G * s.R * 4);
  l.slot = up(l.off_cidx + up16(s.G * s.C * 4), 1024);
  l.off_bs = s.p.stages * l.slot;
  l.bs_row = row;
  l.off_aconv = l.off_bs + 2 * s.G * s.p.mt * l.bs_row;
  const int main_end = l.off_aconv + (s.int8_tiles ? 2 * s.G * s.R * row : 0);
  const int red = s.G * s.p.mt * (s.p.n_chunk + 4) * 4;
  l.off_inv = main_end > red ? main_end : red;
  l.off_zero = l.off_inv + up16(2 * s.G * s.p.n_chunk * 4);
  l.off_flag = l.off_zero + up16(row);
  l.off_bar = l.off_flag + 16;
  l.off_scales = l.off_bar + up16(s.p.stages * 8);
  const int blocks = (s.nb_c + s.p.splits - 1) / s.p.splits;
  l.total = l.off_scales + (s.int8_tiles ? up16(blocks * s.G * 4) : 0) + 1024;
  return l;
}

// Warpgroup MMA for the 128-column M tile: d (64 rows × 128 columns per
// warpgroup, fp32, the m16n8 fragment layout repeated over 16 n8 groups)
// += a (this warp's 16 rows × k16, bf16 registers, as ldmatrix gives them)
// · B (k16 × 128 from shared memory, K-major, 128-byte swizzled); scale_d =
// 0 overwrites d.
__device__ __forceinline__ void wgmma128(float (&d)[4][4][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[1][0][0]), "+f"(d[1][0][1]), "+f"(d[1][0][2]), "+f"(d[1][0][3]),
        "+f"(d[1][1][0]), "+f"(d[1][1][1]), "+f"(d[1][1][2]), "+f"(d[1][1][3]),
        "+f"(d[1][2][0]), "+f"(d[1][2][1]), "+f"(d[1][2][2]), "+f"(d[1][2][3]),
        "+f"(d[1][3][0]), "+f"(d[1][3][1]), "+f"(d[1][3][2]), "+f"(d[1][3][3]),
        "+f"(d[2][0][0]), "+f"(d[2][0][1]), "+f"(d[2][0][2]), "+f"(d[2][0][3]),
        "+f"(d[2][1][0]), "+f"(d[2][1][1]), "+f"(d[2][1][2]), "+f"(d[2][1][3]),
        "+f"(d[2][2][0]), "+f"(d[2][2][1]), "+f"(d[2][2][2]), "+f"(d[2][2][3]),
        "+f"(d[2][3][0]), "+f"(d[2][3][1]), "+f"(d[2][3][2]), "+f"(d[2][3][3]),
        "+f"(d[3][0][0]), "+f"(d[3][0][1]), "+f"(d[3][0][2]), "+f"(d[3][0][3]),
        "+f"(d[3][1][0]), "+f"(d[3][1][1]), "+f"(d[3][1][2]), "+f"(d[3][1][3]),
        "+f"(d[3][2][0]), "+f"(d[3][2][1]), "+f"(d[3][2][2]), "+f"(d[3][2][3]),
        "+f"(d[3][3][0]), "+f"(d[3][3][1]), "+f"(d[3][3][2]), "+f"(d[3][3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

// Keep the compiler from moving accesses to d across an in-flight wgmma.
__device__ __forceinline__ void fence_operands(float (&d)[4][4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(d[a][b][q]));
}

// Index of expert ex's member g's tile (i, j) in vals' (E, G, nb_r, nb_c)
// grid.
__device__ __forceinline__ size_t tile_id(const Shape& s, int ex, int g,
                                          int i, int j) {
  return (((size_t)ex * s.G + g) * s.nb_r + i) * s.nb_c + j;
}

// Stage contraction block j of block row i (all members) into ring slot sl
// and arm its mbarrier: a TMA copy of the x block, one TMA copy per bf16
// tile (or one bulk copy per int8 tile) and bulk copies of the indices. One
// thread (the producer warp's lane 0) issues them. The tensor maps span
// every expert: the x block's rows start at ex·M + m0 (rows past the
// expert's M are the next expert's rows, or zeros past the last; they feed
// only MMA columns the epilogue never writes).
template <bool INT8>
__device__ __forceinline__ void issue_tma(const Shape& s, unsigned char* sl,
                                          uint32_t bar,
                                          const CUtensorMap* xmap,
                                          const CUtensorMap* wmap,
                                          const void* __restrict__ vals,
                                          const int* __restrict__ row_idx,
                                          const int* __restrict__ col_idx,
                                          int ex, int i, int j, int m0) {
  const Layout& l = s.l;
  const int RC = s.R * s.C;
  bar_expect(bar, s.p.mt * s.bc * 2 + s.G * RC * (INT8 ? 1 : 2) +
                      s.G * (s.R + s.C) * 4);
  tma2d(smem_u32(sl + l.off_x), xmap, j * s.bc, ex * s.M + m0, bar);
  for (int g = 0; g < s.G; ++g) {
    const size_t t = tile_id(s, ex, g, i, j);
    if (INT8)
      bulk(smem_u32(sl + g * l.tile_member),
           static_cast<const int8_t*>(vals) + t * RC, RC, bar);
    else
      tma2d(smem_u32(sl + g * l.tile_member), wmap, 0, (int)(t * s.R), bar);
    bulk(smem_u32(sl + l.off_ridx + g * s.R * 4), row_idx + t * s.R, s.R * 4,
         bar);
    bulk(smem_u32(sl + l.off_cidx + g * s.C * 4), col_idx + t * s.C, s.C * 4,
         bar);
  }
}

// The same stage by plain loads from every thread, for operands the copies
// cannot take (rows that are not 16-byte multiples); thread 0 arrives on the
// mbarrier without bytes, and the next block barrier publishes the stores.
template <bool INT8>
__device__ __forceinline__ void issue_plain(const Shape& s, unsigned char* sl,
                                            uint32_t bar,
                                            const bf16* __restrict__ x,
                                            const void* __restrict__ vals,
                                            const int* __restrict__ row_idx,
                                            const int* __restrict__ col_idx,
                                            int ex, int i, int j, int m0,
                                            int mt) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout& l = s.l;
  const int RC = s.R * s.C;
  for (int e = tid; e < s.G * RC; e += nt) {
    const int g = e / RC, v = e - g * RC;
    if (INT8) {
      sl[g * l.tile_member + v] =
          static_cast<const unsigned char*>(
              vals)[tile_id(s, ex, g, i, j) * RC + v];
    } else {
      const int r = v / s.C, c = v - r * s.C;
      reinterpret_cast<bf16*>(sl)[(g * s.R + r) * l.as + c] =
          static_cast<const bf16*>(vals)[tile_id(s, ex, g, i, j) * RC + v];
    }
  }
  bf16* xs = reinterpret_cast<bf16*>(sl + l.off_x);
  for (int e = tid; e < mt * s.bc; e += nt) {
    const int m = e / s.bc, c = e - m * s.bc;
    xs[e] = x[(size_t)(ex * s.M + m0 + m) * s.K + (size_t)j * s.bc + c];
  }
  int* ri = reinterpret_cast<int*>(sl + l.off_ridx);
  int* ci = reinterpret_cast<int*>(sl + l.off_cidx);
  for (int e = tid; e < s.G * s.R; e += nt) {
    const int g = e / s.R;
    ri[e] = row_idx[tile_id(s, ex, g, i, j) * s.R + (e - g * s.R)];
  }
  for (int e = tid; e < s.G * s.C; e += nt) {
    const int g = e / s.C;
    ci[e] = col_idx[tile_id(s, ex, g, i, j) * s.C + (e - g * s.C)];
  }
  if (tid == 0)   // the stores are published by the next block barrier
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

// Ready block jl (staged in slot sl) for the tensor cores, into the buffers
// of parity buf: the inverse row map (output row → kept row, tagged with
// jl), x's kept columns gathered into B's layout, and (int8) the codes
// times the tile's scale, rounded to bf16. A lane keeps one pair
// of kept columns and walks its warp's rows, loads first, stores after, so
// the gathers of a row group are in flight together.
template <bool INT8, int MT, int NW>
__device__ __forceinline__ void prepare(const Shape& s, unsigned char* smem,
                                        const unsigned char* sl, int jl,
                                        int buf, int nc0) {
  constexpr int kRows = MT / NW;            // x rows per warp
  constexpr int kU = kRows < 8 ? kRows : 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout& l = s.l;
  const int NC = s.p.n_chunk;
  const int* ridx = reinterpret_cast<const int*>(sl + l.off_ridx);
  const int* cidx = reinterpret_cast<const int*>(sl + l.off_cidx);
  int* inv = reinterpret_cast<int*>(smem + l.off_inv) + buf * s.G * NC;
  const int hc = (s.C + 1) / 2;
  const bf16* xs = reinterpret_cast<const bf16*>(sl + l.off_x);
  unsigned char* bs = smem + l.off_bs + (size_t)buf * s.G * MT * l.bs_row;
  const bf16 zero = __float2bfloat16(0.f);
  for (int g = 0; g < s.G; ++g) {
    for (int r = tid; r < s.R; r += NW * 32) {
      const int n = ridx[g * s.R + r] - nc0;
      if (n >= 0 && n < NC) inv[g * NC + n] = (jl << kTagShift) | r;
    }
    const int* cg = cidx + g * s.C;
    for (int q = lane; q < hc; q += 32) {
      const int c0 = cg[2 * q];
      const bool two = 2 * q + 1 < s.C;
      const int c1 = two ? cg[2 * q + 1] : c0;
      unsigned char* dst = bs + (size_t)g * MT * l.bs_row;
#pragma unroll
      for (int u0 = 0; u0 < kRows; u0 += kU) {
        __nv_bfloat162 v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const bf16* xr = xs + (warp + (u0 + u) * NW) * s.bc;
          v[u].x = xr[c0];
          v[u].y = two ? xr[c1] : zero;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int m = warp + (u0 + u) * NW;
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)m * l.bs_row +
                                             4 * q) = v[u];
        }
      }
    }
    if (INT8) {
      const int8_t* t8 =
          reinterpret_cast<const int8_t*>(sl) + g * l.tile_member;
      const float sc =
          reinterpret_cast<const float*>(smem + l.off_scales)[jl * s.G + g];
      bf16* ac = reinterpret_cast<bf16*>(smem + l.off_aconv) +
                 ((size_t)buf * s.G + g) * s.R * l.as;
      for (int q = lane; q < hc; q += 32) {
        const bool two = 2 * q + 1 < s.C;
        for (int r0 = warp; r0 < s.R; r0 += 4 * NW) {
          __nv_bfloat162 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + u * NW;
            const int8_t* row = t8 + (r < s.R ? r : 0) * s.C + 2 * q;
            v[u].x = __float2bfloat16((float)row[0] * sc);
            v[u].y = two ? __float2bfloat16((float)row[1] * sc) : zero;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + u * NW;
            if (r < s.R)
              *reinterpret_cast<__nv_bfloat162*>(ac + (size_t)r * l.as +
                                                 2 * q) = v[u];
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// Member g's 8 outputs (m, n .. n+7) of this tile, plus bias at column nb:
// from the shared tile (one split) or the sum of the S partials in split
// order, four splits' loads in flight at once.
__device__ __forceinline__ void emit_sum8(const Shape& s, const float* red,
                                          const float* wt, int rs, int per,
                                          int S, int MT, int g, int m, int n,
                                          int nb, const float* bias, int ex,
                                          float4& a0, float4& a1) {
  const int NC = s.p.n_chunk;
  if (S > 1) {
    const float* p = wt + ((size_t)g * MT + m) * NC + n;
    a0 = __ldcg(reinterpret_cast<const float4*>(p));
    a1 = __ldcg(reinterpret_cast<const float4*>(p + 4));
    for (int q0 = 1; q0 < S; q0 += 4) {
      float4 b[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < S) {
          const float* pq = p + (size_t)(q0 + u) * per;
          b[u][0] = __ldcg(reinterpret_cast<const float4*>(pq));
          b[u][1] = __ldcg(reinterpret_cast<const float4*>(pq + 4));
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < S) {
          add4(a0, b[u][0]);
          add4(a1, b[u][1]);
        }
    }
  } else {
    const float* p = red + ((size_t)g * MT + m) * rs + n;
    a0 = *reinterpret_cast<const float4*>(p);
    a1 = *reinterpret_cast<const float4*>(p + 4);
  }
  if (bias != nullptr) {
    const float* bb = bias + ((size_t)ex * s.G + g) * s.N + nb;
    add4(a0, make_float4(bb[0], bb[1], bb[2], bb[3]));
    add4(a1, make_float4(bb[4], bb[5], bb[6], bb[7]));
  }
}

// One contraction block on the warp-level tensor cores (M tiles up to 64):
// SLABS m16 slabs (A rows a_row, chunk XOR a_xor) by NI n8 tiles of the
// gathered x (ldmatrix rows from b_addr, b_row bytes apart), k16 steps up
// to Cp, accumulated into acc.
template <int SLABS, int NI>
__device__ __forceinline__ void mma_block(float (&acc)[SLABS][NI][4],
                                          const uint32_t (&a_row)[SLABS],
                                          const int (&a_xor)[SLABS], int a_kc,
                                          uint32_t b_addr, int b_row,
                                          int ks_n) {
  constexpr int NB = NI == 1 ? 1 : NI / 2;
  for (int ks = 0; ks < ks_n; ++ks) {
    uint32_t af[SLABS][4];
#pragma unroll
    for (int a = 0; a < SLABS; ++a)
      ldsm_x4(af[a], a_row[a] + (((ks * 2 + a_kc) ^ a_xor[a]) << 4));
    uint32_t bfr[NI][2];
    if (NI == 1) {
      ldsm_x2(bfr[0][0], bfr[0][1], b_addr + ks * 32);
    } else {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        uint32_t r4[4];
        ldsm_x4(r4, b_addr + b * 16 * b_row + ks * 32);
        bfr[2 * b][0] = r4[0];
        bfr[2 * b][1] = r4[1];
        bfr[(2 * b + 1) % NI][0] = r4[2];
        bfr[(2 * b + 1) % NI][1] = r4[3];
      }
    }
#pragma unroll
    for (int a = 0; a < SLABS; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
        mma(acc[a][b], af[a], bfr[b][0], bfr[b][1]);
  }
}

// One CTA: output rows [nc0, nc0 + n_chunk) of block row i for all G
// members (MMA rows) by x rows [m0, m0 + MT) (MMA columns, MT up to 64),
// over the contraction blocks of split sp, on mma.sync: warp (wr, wc) owns
// SLABS m16 row slabs of one member by NI n8 column tiles. Warp NW is the
// producer. STACKED: the expert is blockIdx.y; else there is one (a plain
// pack).
template <bool INT8, int MT, int SLABS, int WM, int NW, bool STACKED>
__device__ __forceinline__ void tc_body(
    const CUtensorMap* xmap, const CUtensorMap* wmap,
    const bf16* __restrict__ x, const void* __restrict__ vals,
    const float* __restrict__ scales, const int* __restrict__ row_idx,
    const int* __restrict__ col_idx, const float* __restrict__ bias,
    bf16* __restrict__ y, float* __restrict__ ws, int* __restrict__ counters,
    const Shape& s) {
  constexpr int NI = MT / (WM * 8);
  static_assert(MT <= 64 && NI >= 1 && MT % (WM * 8) == 0,
                "M tile / warp layout");
  static_assert(NI == 1 || NI % 2 == 0, "n8 tiles load in pairs");
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* smem = smem_tc + ((1024 - (smem_u32(smem_tc) & 1023)) & 1023);
  const Layout& l = s.l;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x;                // NW compute warps + a producer
  const bool producer = warp == NW;
  const int wr = warp / WM, wc = warp - wr * WM;
  const int S = s.p.splits, ST = s.p.stages, NC = s.p.n_chunk;

  int idx = blockIdx.x;
  const int sp = idx % S;
  const int tile = idx / S;                 // (i, chunk, M tile)
  idx = tile;
  const int mtile = idx % s.m_tiles;
  idx /= s.m_tiles;
  const int ch = idx % s.p.chunks, i = idx / s.p.chunks;
  const int m0 = mtile * MT, mt = min(MT, s.M - m0);
  const int ex = STACKED ? (int)blockIdx.y : 0;   // the expert
  // this expert's output tile: its split counter and workspace slice
  const size_t gtile = (size_t)ex * s.nb_r * s.p.chunks * s.m_tiles + tile;
  const int nc0 = ch * NC;
  const int j0 = (int)((long long)sp * s.nb_c / S);
  const int nblk = (int)((long long)(sp + 1) * s.nb_c / S) - j0;
  const bool vec = s.p.vec != 0;
  const uint32_t bar0 = smem_u32(smem + l.off_bar);

  // one mbarrier per stage; with TMA the producer arms the first ST-1
  // stages at once, so their copies overlap the set-up below
  if (vec ? producer && lane == 0 : tid == 0) {
    for (int st = 0; st < ST; ++st) bar_init(bar0 + st * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (vec)
      for (int p = 0; p < ST - 1 && p < nblk; ++p)
        issue_tma<INT8>(s, smem + p * l.slot, bar0 + p * 8, xmap, wmap, vals,
                        row_idx, col_idx, ex, i, j0 + p, m0);
  }

  // what no copy writes: the zero row, x rows past M in every stage, the
  // pad columns C..Cp of the staged bf16 tiles, gathered x and widened int8
  // tiles; inverse maps start untagged
  bf16* zrow = reinterpret_cast<bf16*>(smem + l.off_zero);
  const bf16 zero = __float2bfloat16(0.f);
  for (int c = tid; c < l.cp; c += nt) zrow[c] = zero;
  if (!vec && mt < MT) {
    const int per = (MT - mt) * s.bc;
    for (int e = tid; e < ST * per; e += nt) {
      const int st = e / per;
      reinterpret_cast<bf16*>(smem + st * l.slot + l.off_x)[mt * s.bc + e -
                                                           st * per] = zero;
    }
  }
  const int pad = l.cp - s.C;
  if (pad > 0) {
    const int stage_rows = INT8 || l.ts != l.as * 2 ? 0 : ST * s.G * s.R;
    const int bs_rows = 2 * s.G * MT;
    const int ac_rows = INT8 ? 2 * s.G * s.R : 0;
    for (int e = tid; e < (stage_rows + bs_rows + ac_rows) * pad;
         e += nt) {
      int rw = e / pad;
      const int c = s.C + (e - rw * pad);
      bf16* p;
      if (rw < stage_rows) {
        const int slot = rw / (s.G * s.R);
        p = reinterpret_cast<bf16*>(smem + slot * l.slot) +
            (size_t)(rw - slot * s.G * s.R) * l.as;
      } else if ((rw -= stage_rows) < bs_rows) {
        p = reinterpret_cast<bf16*>(smem + l.off_bs) + (size_t)rw * l.as;
      } else {
        p = reinterpret_cast<bf16*>(smem + l.off_aconv) +
            (size_t)(rw - bs_rows) * l.as;
      }
      p[c] = zero;
    }
  }
  if (l.cp != s.C && l.ts == s.C * 2) {
    // dense tile rows of C_keep % 16 == 8: the last k step reads 16 bytes
    // past a row, against gathered-x columns that are zero; keep the bytes
    // past each member's last row finite where no copy writes them (the
    // member's alignment padding, or the gap before the x block)
    const int used = s.R * l.ts;
    for (int e = tid; e < ST * s.G * 16; e += nt) {
      const int q = e >> 4, st = q / s.G, g = q - st * s.G;
      const int off = g * l.tile_member + used + (e & 15);
      if (off < (g + 1 == s.G ? l.off_x : (g + 1) * l.tile_member))
        smem[st * l.slot + off] = 0;
    }
  }
  int* inv_all = reinterpret_cast<int*>(smem + l.off_inv);
  for (int e = tid; e < 2 * s.G * NC; e += nt) inv_all[e] = -1;
  if (INT8) {   // the tile scales of this CTA's blocks, all in flight at once
    float* sc_all = reinterpret_cast<float*>(smem + l.off_scales);
    for (int e = tid; e < nblk * s.G; e += nt) {
      const int b = e / s.G;
      sc_all[e] = __ldg(scales + tile_id(s, ex, e - b * s.G, i, j0 + b));
    }
  }
  __syncthreads();
  if (!vec)   // ring prologue by plain loads: blocks 0 .. ST-2
    for (int p = 0; p < ST - 1 && p < nblk; ++p)
      issue_plain<INT8>(s, smem + p * l.slot, bar0 + p * 8, x, vals, row_idx,
                        col_idx, ex, i, j0 + p, m0, mt);
  bar_wait(bar0, 0);
  __syncthreads();
  if (!producer) prepare<INT8, MT, NW>(s, smem, smem, 0, 0, nc0);

  // this warp's member and the lane's ldmatrix rows
  const int row0 = wr * SLABS * 16;
  const int gw = producer ? s.G : row0 / NC;   // >= G: no rows
  float acc[SLABS][NI][4];
#pragma unroll
  for (int a = 0; a < SLABS; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.f;
  const int a_lane_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_kc = lane >> 4;
  const int b_lane_row = NI == 1 ? (lane & 7) : ((lane >> 4) * 8 + (lane & 7));
  const int b_kc = (lane >> 3) & 1;
  const int ks_n = l.cp / 16;

  for (int jl = 0; jl < nblk; ++jl) {
    if (jl + 1 < nblk)
      bar_wait(bar0 + ((jl + 1) % ST) * 8, ((jl + 1) / ST) & 1);
    __syncthreads();   // block jl prepared, block jl+1 staged, jl-1 done
    const int nxt = jl + ST - 1;
    if (nxt < nblk) {
      unsigned char* sn = smem + (nxt % ST) * l.slot;
      const uint32_t bn = bar0 + (nxt % ST) * 8;
      if (!vec)
        issue_plain<INT8>(s, sn, bn, x, vals, row_idx, col_idx, ex, i,
                          j0 + nxt, m0, mt);
      else if (producer && lane == 0)
        issue_tma<INT8>(s, sn, bn, xmap, wmap, vals, row_idx, col_idx, ex, i,
                        j0 + nxt, m0);
    }
    const bool next = jl + 1 < nblk && !producer;
    const int buf = jl & 1;
    if (gw < s.G) {
      // A rows: the kept row's staged row (bf16 tile rows ts bytes apart,
      // 16-byte chunks XOR-swizzled by row under TMA's 128B swizzle;
      // widened int8 rows padded) or the zero row
      const int* inv = inv_all + (buf * s.G + gw) * NC;
      const unsigned char* abase =
          INT8 ? smem + l.off_aconv + (size_t)(buf * s.G + gw) * s.R * l.as * 2
               : smem + (jl % ST) * l.slot + (size_t)gw * l.tile_member;
      const int a_stride = INT8 ? l.as * 2 : l.ts;
      const bool swz = !INT8 && l.swz;
      uint32_t a_row[SLABS];
      int a_xor[SLABS];
#pragma unroll
      for (int a = 0; a < SLABS; ++a) {
        const int e = inv[row0 - gw * NC + a * 16 + a_lane_row];
        const bool kept = (e >> kTagShift) == jl;
        const int r = e & ((1 << kTagShift) - 1);
        a_row[a] = kept ? smem_u32(abase) + r * a_stride : smem_u32(zrow);
        a_xor[a] = kept && swz ? (r & 7) : 0;
      }
      if (next)
        prepare<INT8, MT, NW>(s, smem, smem + ((jl + 1) % ST) * l.slot,
                              jl + 1, buf ^ 1, nc0);
      mma_block<SLABS, NI>(
          acc, a_row, a_xor, a_kc,
          smem_u32(smem + l.off_bs +
                   (size_t)(buf * s.G + gw) * MT * l.bs_row) +
              (wc * NI * 8 + b_lane_row) * l.bs_row + b_kc * 16,
          l.bs_row, ks_n);
    } else if (next) {
      prepare<INT8, MT, NW>(s, smem, smem + ((jl + 1) % ST) * l.slot, jl + 1,
                            buf ^ 1, nc0);
    }
  }

  // fp32 tile → shared memory as [g][m][n] (row stride NC + 4), over the
  // ring (every copy has landed: each block was waited on)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int rs = NC + 4;
  if (gw < s.G) {
#pragma unroll
    for (int a = 0; a < SLABS; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // slab a, n8 tile b of warp (wr, wc)
          const int n = row0 - gw * NC + a * 16 + (lane >> 2) + (q >> 1) * 8;
          const int m = wc * NI * 8 + b * 8 + (lane & 3) * 2 + (q & 1);
          red[((size_t)gw * MT + m) * rs + n] = acc[a][b][q];
        }
  }
  __syncthreads();

  const int per = s.G * MT * NC;
  if (S > 1) {
    // this split's partial to the workspace; the last split to arrive sums
    // all of them in split order, so y does not depend on arrival order
    float* wp = ws + (gtile * S + sp) * per;
    for (int gm = warp; gm < s.G * MT; gm += NW + 1)
      for (int n = lane; n < NC; n += 32)
        wp[(size_t)gm * NC + n] = red[(size_t)gm * rs + n];
    __threadfence();
    __syncthreads();
    int* flag = reinterpret_cast<int*>(smem + l.off_flag);
    if (tid == 0) *flag = atomicAdd(counters + gtile, 1) == S - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
  }

  // emit: bias, SwiGLU, x's dtype. Where rows allow, a thread takes 8
  // consecutive outputs: two float4 reads of the tile (or of each split's
  // partial, four splits' loads in flight at once, summed in split order)
  // and one 16-byte store.
  const int n0 = i * s.br + nc0;
  const int nv = min(NC, s.br - nc0);
  const float* wt = ws + gtile * S * per;
  const int gy = s.swiglu ? 1 : s.G;
  if (nv % 8 == 0 && s.N % 8 == 0 && s.br % 8 == 0) {
    const int nq = nv / 8;
    for (int e = tid; e < gy * mt * nq; e += nt) {
      const int gm = e / nq, n = (e - gm * nq) * 8;
      const int go = gm / mt, m = gm - go * mt;
      float4 a0, a1, b0, b1;
      emit_sum8(s, red, wt, rs, per, S, MT, s.swiglu ? 0 : go, m, n, n0 + n,
                bias, ex, a0, a1);
      if (s.swiglu) {
        emit_sum8(s, red, wt, rs, per, S, MT, 1, m, n, n0 + n, bias, ex, b0,
                  b1);
        a0 = make_float4(silu(a0.x) * b0.x, silu(a0.y) * b0.y,
                         silu(a0.z) * b0.z, silu(a0.w) * b0.w);
        a1 = make_float4(silu(a1.x) * b1.x, silu(a1.y) * b1.y,
                         silu(a1.z) * b1.z, silu(a1.w) * b1.w);
      }
      *reinterpret_cast<uint4*>(
          y + (((size_t)ex * gy + go) * s.M + m0 + m) * s.N + n0 + n) =
          make_uint4(pack_bf16(a0.x, a0.y), pack_bf16(a0.z, a0.w),
                     pack_bf16(a1.x, a1.y), pack_bf16(a1.z, a1.w));
    }
  } else {
    for (int e = tid; e < gy * mt * nv; e += nt) {
      const int gm = e / nv, n = e - gm * nv;
      const int go = gm / mt, m = gm - go * mt;
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !s.swiglu) break;
        const int g = s.swiglu ? h : go;
        float val;
        if (S > 1) {
          const size_t o = ((size_t)g * MT + m) * NC + n;
          val = __ldcg(wt + o);
          for (int q = 1; q < S; ++q) val += __ldcg(wt + (size_t)q * per + o);
        } else {
          val = red[((size_t)g * MT + m) * rs + n];
        }
        if (bias != nullptr)
          val += bias[((size_t)ex * s.G + g) * s.N + n0 + n];
        v[h] = val;
      }
      const float o = s.swiglu ? silu(v[0]) * v[1] : v[0];
      y[(((size_t)ex * gy + go) * s.M + m0 + m) * s.N + n0 + n] =
          __float2bfloat16(o);
    }
  }
  if (S > 1 && tid == 0) counters[gtile] = 0;   // ready for the next call
}

// One body under two names, so a profile tells bcr_spmm's launches from
// bcr_spmm_grouped's.
#define BCR_TC_KERNEL(NAME)                                                  \
  template <bool INT8, int MT, int SLABS, int WM, int NW, bool STACKED>      \
  __global__ void __launch_bounds__(NW * 32 + 32, 1)                         \
  NAME(const __grid_constant__ CUtensorMap xmap,                             \
       const __grid_constant__ CUtensorMap wmap, const bf16* x,              \
       const void* vals, const float* scales, const int* row_idx,            \
       const int* col_idx, const float* bias, bf16* y, float* ws,            \
       int* counters, const Shape s) {                                       \
    tc_body<INT8, MT, SLABS, WM, NW, STACKED>(&xmap, &wmap, x, vals, scales, \
                                          row_idx, col_idx, bias, y, ws,     \
                                          counters, s);                      \
  }
BCR_TC_KERNEL(bcr_spmm_tc)
BCR_TC_KERNEL(bcr_spmm_grouped_tc)
#undef BCR_TC_KERNEL

template <bool INT8, int MT, int SLABS, int WM, int NW, bool STACKED>
int launch_cfg(const Shape& s, cudaStream_t stream, void** args) {
  auto kernel = s.grouped
                    ? bcr_spmm_grouped_tc<INT8, MT, SLABS, WM, NW, STACKED>
                    : bcr_spmm_tc<INT8, MT, SLABS, WM, NW, STACKED>;
  static int smem_set[2] = {0, 0};   // per kernel: raise the limit once
  if (s.p.smem > smem_set[s.grouped]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.p.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[s.grouped] = s.p.smem;
  }
  const int grid = s.nb_r * s.p.chunks * s.m_tiles * s.p.splits;
  cudaError_t err = cudaLaunchKernel((const void*)kernel, dim3(grid, s.E),
                                     dim3(NW * 32 + 32), args, s.p.smem,
                                     stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The compiled configurations: kernels/bcr_spmm.py:CONFIGS.
template <bool INT8>
int dispatch(const Shape& s, cudaStream_t st, void** args) {
  const int mt = s.p.mt, sl = s.p.slabs, wm = s.p.warps_m;
#define BCR_CFG(A, B, C, D)                                          \
  if (mt == A && sl == B && wm == C)                                 \
    return s.E > 1 ? launch_cfg<INT8, A, B, C, D, true>(s, st, args) \
                   : launch_cfg<INT8, A, B, C, D, false>(s, st, args);
  BCR_CFG(8, 1, 1, 8)
  BCR_CFG(8, 2, 1, 8)
  BCR_CFG(16, 1, 1, 8)
  BCR_CFG(16, 2, 1, 8)
  BCR_CFG(32, 1, 1, 8)
  BCR_CFG(32, 2, 1, 8)
  BCR_CFG(64, 2, 2, 8)
#undef BCR_CFG
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The 128-row M tile (prefill): the wide body. bf16 x, fp or int8 tiles,
// any G, bias and SwiGLU, stacked experts; blocks of 128 columns. Design
// notes at the head of the file.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 256;   // two consumer warpgroups, no producer warp
constexpr int kWgMT = 128;        // x rows a CTA: the wgmma's N
constexpr int kWgRows = 256;      // MMA rows a CTA: 2 warpgroups x 2 m64 slabs
constexpr int kWgBC = 128;        // block columns: two 64-column swizzled atoms

// The plan kernels/bcr_spmm.py:launch_plan chose, in the order of its
// LaunchPlan.args() for the wide body.
struct WgPlan {
  int mt, span, groups, splits, stages, vec, mfast, units, smem;
};

// Byte offsets of shared memory, as kernels/bcr_spmm.py:wg_smem_layout
// computes them (the launcher refuses a plan whose total disagrees). Two
// rings of `stages` slots: x blocks (1024-byte aligned: two
// 128-byte-swizzled atoms of 64 columns, TMA's layout and wgmma's B), read
// by a block's products, and tiles (128-byte aligned: each of the CTA's
// units' — a member's block row — kept tile, row and column indices), read
// one block earlier by the expansion; each ring refills two blocks ahead of
// its reader. Then two buffers of expanded tiles (each unit's R_keep kept
// rows widened to the block's bc columns, rows bc + 8 elements apart), the
// fp32 epilogue tile (128 x 260, aliasing the rings), two inverse row maps,
// a zero row, the split flag, one mbarrier a slot of each ring, the int8
// tile scales and 1024 bytes of alignment slack.
struct WgLayout {
  int as, tsz;                   // expanded row (elements); one unit's tile
  int xslot, off_tr, tslot;      // x ring slot; tile ring offset and slot
  int off_t, off_r, off_c;       // within a tile slot
  int off_e, ebuf;               // expanded tiles: two buffers of ebuf bytes
  int off_inv, off_zero, off_flag, off_bar, off_scales, total;
};

struct WgShape {
  int M, K, N, G, nb_r, nb_c, br, bc, R, C, m_tiles, E;
  int Q;                          // G·N output rows, flattened (i, g, r)
  int int8_tiles, swiglu, grouped;
  WgPlan p;
  WgLayout l;
};

inline WgLayout make_wg_layout(const WgShape& s) {
  WgLayout l;
  const int nu = s.p.units, elt = s.int8_tiles ? 1 : 2;
  l.as = s.bc + 8;
  l.tsz = up16(s.R * s.C * elt);
  l.xslot = kWgMT * s.bc * 2;
  l.off_tr = s.p.stages * l.xslot;
  l.off_t = 0;
  l.off_r = nu * l.tsz;
  l.off_c = l.off_r + up16(nu * s.R * 4);
  l.tslot = up(l.off_c + up16(nu * s.C * 4), 128);
  l.off_e = l.off_tr + s.p.stages * l.tslot;
  l.ebuf = nu * s.R * l.as * 2;
  const int main_end = l.off_e + 2 * l.ebuf;
  const int red = kWgMT * (kWgRows + 4) * 4;
  l.off_inv = main_end > red ? main_end : red;
  l.off_zero = l.off_inv + up16(2 * nu * s.br * 4);
  l.off_flag = l.off_zero + up16(l.as * 2);
  l.off_bar = l.off_flag + 16;
  l.off_scales = l.off_bar + up16(2 * s.p.stages * 8);
  const int blocks = (s.nb_c + s.p.splits - 1) / s.p.splits;
  l.total = l.off_scales + (s.int8_tiles ? up16(blocks * nu * 4) : 0) + 1024;
  return l;
}

// Units a CTA of `span` flattened rows can touch: span / br when the
// windows start on block-row boundaries, else two more for the ends.
inline int wg_units(int span, int br) {
  return span % br == 0 ? span / br : span / br + 2;
}

// Unit u (output rows [u·br, (u+1)·br) of the flattened G·N: block row
// u / G of member u % G) of expert ex: its tile (j) in vals' (E, G, nb_r,
// nb_c) grid.
__device__ __forceinline__ size_t wg_tile_id(const WgShape& s, int ex, int u,
                                             int j) {
  const int i = u / s.G, g = u - i * s.G;
  return (((size_t)ex * s.G + g) * s.nb_r + i) * s.nb_c + j;
}

// A stage's copies: its x block's 64-column atoms by TMA (rows past the
// expert's M are the next expert's rows, or zeros past the last; they feed
// only MMA columns the epilogue never writes) and each unit's tile, row and
// column indices by bulk copies. Copy k goes out from lane 0 of warp k mod
// 8, so no one warp issues a stage alone; the stage's mbarriers are armed
// beforehand by one thread (wg_arm), once their previous phase has
// completed, so every copy lands in the phase that waits for it.
__device__ __forceinline__ void wg_arm(const WgShape& s, uint32_t xbar,
                                       uint32_t tbar, int nu) {
  if (xbar) bar_expect(xbar, kWgMT * s.bc * 2);
  if (tbar)
    bar_expect(tbar, nu * (s.R * s.C * (s.int8_tiles ? 1 : 2) +
                           (s.R + s.C) * 4));
}

// Copy k of x block j into x slot xs (k < bc / 64; kx of them in all), else
// copy k - kx of tile block jt's: unit (k - kx) / 3's tile, row or column
// indices into tile slot ts.
template <bool INT8>
__device__ __forceinline__ void wg_copy(
    const WgShape& s, int k, int kx, unsigned char* xs, uint32_t xbar,
    const CUtensorMap* xmap, int j, int m0, unsigned char* ts, uint32_t tbar,
    const void* __restrict__ vals, const int* __restrict__ row_idx,
    const int* __restrict__ col_idx, int ex, int u0, int jt) {
  if (k < kx) {
    tma2d(smem_u32(xs + k * kWgMT * 128), xmap, j * s.bc + k * 64,
          ex * s.M + m0, xbar);
    return;
  }
  const WgLayout& l = s.l;
  const int tb = s.R * s.C * (INT8 ? 1 : 2);
  const int ul = (k - kx) / 3, kind = k - kx - 3 * ul;
  const size_t t = wg_tile_id(s, ex, u0 + ul, jt);
  const unsigned char* src =
      kind == 0 ? static_cast<const unsigned char*>(vals) + t * tb
      : kind == 1 ? reinterpret_cast<const unsigned char*>(row_idx + t * s.R)
                  : reinterpret_cast<const unsigned char*>(col_idx + t * s.C);
  const int bytes = kind == 0 ? tb : kind == 1 ? s.R * 4 : s.C * 4;
  const int dst = kind == 0   ? l.off_t + ul * l.tsz
                  : kind == 1 ? l.off_r + ul * s.R * 4
                              : l.off_c + ul * s.C * 4;
  bulk(smem_u32(ts + dst), src, bytes, tbar);
}

// The same by plain loads from every thread, for operands the copies cannot
// take (unaligned x or tiles, runs that are not 16-byte multiples): the x
// block written in TMA's swizzled layout (zeros past M), then a fence so
// wgmma's async proxy sees it; thread 0 arrives on the mbarrier without
// bytes, and the next block barrier publishes the stores.
__device__ __forceinline__ void wg_plain_x(const WgShape& s, unsigned char* xs,
                                           uint32_t bar,
                                           const bf16* __restrict__ x,
                                           int ex, int j, int m0, int mt) {
  const int tid = threadIdx.x;
  bf16* xb = reinterpret_cast<bf16*>(xs);
  for (int e = tid; e < kWgMT * s.bc; e += kWgThreads) {
    const int m = e / s.bc, k = e - m * s.bc, c = k & 63;
    xb[(k >> 6) * kWgMT * 64 + m * 64 + ((((c >> 3) ^ (m & 7)) << 3) | (c & 7))] =
        m < mt ? x[(size_t)(ex * s.M + m0 + m) * s.K + (size_t)j * s.bc + k]
               : __float2bfloat16(0.f);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) bar_arrive(bar);
}

template <bool INT8>
__device__ __forceinline__ void wg_plain_tiles(
    const WgShape& s, unsigned char* ts, uint32_t bar,
    const void* __restrict__ vals, const int* __restrict__ row_idx,
    const int* __restrict__ col_idx, int ex, int u0, int nu, int j) {
  const int tid = threadIdx.x;
  const WgLayout& l = s.l;
  const int tb = s.R * s.C * (INT8 ? 1 : 2);
  for (int e = tid; e < nu * tb; e += kWgThreads) {
    const int ul = e / tb, b = e - ul * tb;
    ts[l.off_t + ul * l.tsz + b] = static_cast<const unsigned char*>(
        vals)[wg_tile_id(s, ex, u0 + ul, j) * tb + b];
  }
  int* ri = reinterpret_cast<int*>(ts + l.off_r);
  int* ci = reinterpret_cast<int*>(ts + l.off_c);
  for (int e = tid; e < nu * s.R; e += kWgThreads) {
    const int ul = e / s.R;
    ri[e] = row_idx[wg_tile_id(s, ex, u0 + ul, j) * s.R + e - ul * s.R];
  }
  for (int e = tid; e < nu * s.C; e += kWgThreads) {
    const int ul = e / s.C;
    ci[e] = col_idx[wg_tile_id(s, ex, u0 + ul, j) * s.C + e - ul * s.C];
  }
  if (tid == 0) bar_arrive(bar);
}

// Two kept values of tile row kr at columns c0, c0 + 1 (the second only
// where `two`), as bf16; int8 codes times the tile's scale.
template <bool INT8>
__device__ __forceinline__ __nv_bfloat162 wg_pair(const unsigned char* tb,
                                                  int C, int kr, int c0,
                                                  bool two, bool even,
                                                  float scv) {
  if (INT8) {
    const int8_t* t = reinterpret_cast<const int8_t*>(tb) + kr * C + c0;
    int8_t t0, t1 = 0;
    if (even) {
      const char2 p = *reinterpret_cast<const char2*>(t);
      t0 = p.x;
      t1 = p.y;
    } else {
      t0 = t[0];
      if (two) t1 = t[1];
    }
    return __floats2bfloat162_rn((float)t0 * scv, (float)t1 * scv);
  }
  const bf16* t = reinterpret_cast<const bf16*>(tb) + kr * C + c0;
  if (even) return *reinterpret_cast<const __nv_bfloat162*>(t);
  __nv_bfloat162 p;
  p.x = t[0];
  p.y = two ? t[1] : t[0];
  return p;
}

// Ready block jl (staged in slot sl) for the tensor cores, into the buffers
// of parity buf: each unit's inverse row map (output row → kept row,
// tagged with jl) and its tile expanded across the block's columns: kept
// row kr of unit ul becomes a bc-wide row, zero but at the kept columns
// (int8 codes widened with the tile's scale folded in, bf16(code × scale)).
// Warp w owns rows {2w, 2w+1} + 16k of every unit: it zeroes them with
// 16-byte stores, then a lane keeps one pair of kept columns (indices read
// once a unit) and writes that pair into each of the warp's rows, eight
// rows' loads in flight before their stores (the pass is latency-bound:
// one row's load, then its stores, serialises on shared memory's latency).
template <bool INT8>
__device__ __forceinline__ void wg_expand(const WgShape& s,
                                          unsigned char* smem,
                                          const unsigned char* sl, int jl,
                                          int buf, int nu, const float* sc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const WgLayout& l = s.l;
  int* inv = reinterpret_cast<int*>(smem + l.off_inv) + buf * s.p.units * s.br;
  const int* ridx = reinterpret_cast<const int*>(sl + l.off_r);
  const int* cidx = reinterpret_cast<const int*>(sl + l.off_c);
  for (int ul = 0; ul < nu; ++ul)
    for (int r = tid; r < s.R; r += kWgThreads)
      inv[ul * s.br + ridx[ul * s.R + r]] = (jl << kTagShift) | r;
  const int rb = l.as * 2;                     // expanded row bytes
  unsigned char* eb = smem + l.off_e + (size_t)buf * l.ebuf;
  if (s.C == 64 && s.R % 16 == 0) {
    // the serving tiles (keep 0.25 of 128 x 128): straight-line code, no
    // branch a row (the general loop below costs ~4x the shared-memory
    // instructions it issues)
    for (int ul = 0; ul < nu; ++ul) {
      unsigned char* eu = eb + ul * s.R * rb + (lane & 15) * 16;
      for (int kr = warp * 2 + (lane >> 4); kr < s.R; kr += 16)
        *reinterpret_cast<uint4*>(eu + kr * rb) = make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    for (int ul = 0; ul < nu; ++ul) {
      const int2 d = *reinterpret_cast<const int2*>(cidx + ul * 64 + 2 * lane);
      const unsigned char* tb = sl + l.off_t + ul * l.tsz;
      unsigned char* eu = eb + ul * s.R * rb;
      const float scv = INT8 ? sc[ul] : 0.f;
      for (int kb = warp * 2; kb < s.R; kb += 64) {
        __nv_bfloat162 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int kr = kb + (u & 1) + 16 * (u >> 1);
          if (kr < s.R) {
            if (INT8) {
              const char2 p =
                  *reinterpret_cast<const char2*>(tb + kr * 64 + 2 * lane);
              v[u] = __floats2bfloat162_rn((float)p.x * scv, (float)p.y * scv);
            } else {
              v[u] = *reinterpret_cast<const __nv_bfloat162*>(tb + kr * 128 +
                                                             4 * lane);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int kr = kb + (u & 1) + 16 * (u >> 1);
          if (kr < s.R) {
            bf16* row = reinterpret_cast<bf16*>(eu + kr * rb);
            row[d.x] = v[u].x;
            row[d.y] = v[u].y;
          }
        }
      }
    }
    return;
  }
  const int chunks = s.bc / 8, half = lane >> 4;
  for (int ul = 0; ul < nu; ++ul) {
    unsigned char* eu = eb + ul * s.R * rb;
    for (int kr = warp * 2 + half; kr < s.R; kr += 16)
#pragma unroll
      for (int c = lane & 15; c < kWgBC / 8; c += 16)
        if (c < chunks)
          *reinterpret_cast<uint4*>(eu + kr * rb + c * 16) =
              make_uint4(0, 0, 0, 0);
  }
  __syncwarp();
  const int hc = (s.C + 1) / 2;
  const bool even = (s.C & 1) == 0;
  constexpr int kRows = 8;                     // rows a batch, a lane
  for (int ul = 0; ul < nu; ++ul) {
    const int* cg = cidx + ul * s.C;
    const unsigned char* tb = sl + l.off_t + ul * l.tsz;
    unsigned char* eu = eb + ul * s.R * rb;
    const float scv = INT8 ? sc[ul] : 0.f;
    for (int q = lane; q < hc; q += 32) {
      const int c0 = 2 * q;
      const bool two = c0 + 1 < s.C;
      const int d0 = cg[c0], d1 = two ? cg[c0 + 1] : d0;
      for (int kb = warp * 2; kb < s.R; kb += 16 * (kRows / 2)) {
        __nv_bfloat162 v[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int kr = kb + (u & 1) + 16 * (u >> 1);
          if (kr < s.R)
            v[u] = wg_pair<INT8>(tb, s.C, kr, c0, two, even, scv);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int kr = kb + (u & 1) + 16 * (u >> 1);
          if (kr < s.R) {
            bf16* row = reinterpret_cast<bf16*>(eu + kr * rb);
            row[d0] = v[u].x;
            if (two) row[d1] = v[u].y;
          }
        }
      }
    }
  }
}

// Eight consecutive outputs (x row m, CTA rows n .. n+7) of this tile: from
// the shared fp32 tile (one split) or the sum of the S partials in split
// order — split sp's (this CTA's) from the shared tile, the others' from the
// workspace, four splits' loads in flight at once.
__device__ __forceinline__ void wg_sum8(const float* red, int rs,
                                        const float* wt, int per, int S,
                                        int sp, int m, int n, float4& a0,
                                        float4& a1) {
  const float* own = red + (size_t)m * rs + n;
  if (S == 1) {
    a0 = *reinterpret_cast<const float4*>(own);
    a1 = *reinterpret_cast<const float4*>(own + 4);
    return;
  }
  const float* p = wt + (size_t)m * kWgRows + n;
  float4 b[4][2];
  for (int q0 = 0; q0 < S; q0 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u;
      if (q >= S) break;
      const float* pq = q == sp ? own : p + (size_t)q * per;
      b[u][0] = q == sp ? *reinterpret_cast<const float4*>(pq)
                        : __ldcg(reinterpret_cast<const float4*>(pq));
      b[u][1] = q == sp ? *reinterpret_cast<const float4*>(pq + 4)
                        : __ldcg(reinterpret_cast<const float4*>(pq + 4));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u;
      if (q >= S) break;
      if (q == 0) {
        a0 = b[u][0];
        a1 = b[u][1];
      } else {
        add4(a0, b[u][0]);
        add4(a1, b[u][1]);
      }
    }
  }
}

// Bias of eight consecutive outputs added to (a0, a1).
__device__ __forceinline__ void wg_bias8(const float* bb, bool vec,
                                         float4& a0, float4& a1) {
  if (vec) {
    add4(a0, __ldg(reinterpret_cast<const float4*>(bb)));
    add4(a1, __ldg(reinterpret_cast<const float4*>(bb) + 1));
  } else {
    add4(a0, make_float4(bb[0], bb[1], bb[2], bb[3]));
    add4(a1, make_float4(bb[4], bb[5], bb[6], bb[7]));
  }
}

__device__ __forceinline__ float wg_sum1(const float* red, int rs,
                                         const float* wt, int per, int S,
                                         int sp, int m, int n) {
  const float own = red[(size_t)m * rs + n];
  if (S == 1) return own;
  const size_t o = (size_t)m * kWgRows + n;
  float v = sp == 0 ? own : __ldcg(wt + o);
  for (int q = 1; q < S; ++q)
    v += q == sp ? own : __ldcg(wt + (size_t)q * per + o);
  return v;
}

// One CTA: flattened output rows [q0, q0 + span) — row q is row q % br of
// block row (q / br) / G of member (q / br) % G, so a CTA's 256 MMA rows
// cover whole block rows of several members or block rows (SwiGLU: whole
// gate/up pairs) — by x rows [m0, m0 + 128), over the contraction blocks of
// split sp. Warpgroup wg owns rows [128 wg, 128 wg + 128) as two m64 slabs
// by all 128 columns (wgmma m64n128k16: A, the expanded weight rows, in
// registers by ldmatrix from each row's kept row or the zero row; B, the x
// block, by descriptor straight from the TMA-filled ring). STACKED: the
// expert is blockIdx.y.
template <bool INT8, bool STACKED>
__device__ __forceinline__ void wg_body(
    const CUtensorMap* xmap, const bf16* __restrict__ x,
    const void* __restrict__ vals, const float* __restrict__ scales,
    const int* __restrict__ row_idx, const int* __restrict__ col_idx,
    const float* __restrict__ bias, bf16* __restrict__ y,
    float* __restrict__ ws, int* __restrict__ counters, const WgShape& s) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  unsigned char* smem = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  const WgLayout& l = s.l;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = s.p.splits, ST = s.p.stages, span = s.p.span;
  const int sp = blockIdx.x % S, tile = blockIdx.x / S;
  // the M tile fastest where the weight outweighs x (lm_head: its tiles
  // stream from device memory once, x stays in L2), else the row groups
  // (whisper at M = 12000: each x block is read from device memory once)
  const int mtile = s.p.mfast ? tile % s.m_tiles : tile / s.p.groups;
  const int rg = s.p.mfast ? tile / s.m_tiles : tile % s.p.groups;
  const int m0 = mtile * kWgMT, mt = min(kWgMT, s.M - m0);
  const int ex = STACKED ? (int)blockIdx.y : 0;
  const size_t gtile = (size_t)ex * s.p.groups * s.m_tiles + tile;
  const int q0 = rg * span, qn = min(span, s.Q - q0);
  const int u0 = q0 / s.br, nu = (q0 + qn - 1) / s.br - u0 + 1;
  const int j0 = (int)((long long)sp * s.nb_c / S);
  const int nblk = (int)((long long)(sp + 1) * s.nb_c / S) - j0;
  const bool vec = s.p.vec != 0;
  const uint32_t xbar0 = smem_u32(smem + l.off_bar);   // x ring's mbarriers
  const uint32_t tbar0 = xbar0 + ST * 8;               // the tile ring's
  unsigned char* xring = smem;
  unsigned char* tring = smem + l.off_tr;
  float* sc_all = reinterpret_cast<float*>(smem + l.off_scales);

  // prologue: x blocks 0 .. ST-2 and tiles 0 .. ST-1 in flight, slot ST-1
  // armed for x block ST-1 (iteration 0's refill)
  const int kx = s.bc / 64, kc = kx + 3 * nu;   // a stage's copies
  if (tid == 0) {
    for (int st = 0; st < 2 * ST; ++st) bar_init(xbar0 + st * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (vec)
      for (int p = 0; p < ST && p < nblk; ++p)
        wg_arm(s, p < ST - 1 ? xbar0 + p * 8 : 0u, tbar0 + p * 8, nu);
    if (vec && ST - 1 < nblk) wg_arm(s, xbar0 + (ST - 1) * 8, 0u, nu);
  }
  __syncthreads();
  if (vec && lane == 0)
    for (int p = 0; p < ST && p < nblk; ++p) {
      const int kp = p < ST - 1 ? kx : 0;   // the last tile stage has no x
      for (int k = warp; k < kp + 3 * nu; k += kWgThreads / 32)
        wg_copy<INT8>(s, k + kx - kp, kx, xring + p * l.xslot, xbar0 + p * 8,
                      xmap, j0 + p, m0, tring + p * l.tslot, tbar0 + p * 8,
                      vals, row_idx, col_idx, ex, u0, j0 + p);
    }
  bf16* zrow = reinterpret_cast<bf16*>(smem + l.off_zero);
  for (int c = tid; c < l.as; c += kWgThreads) zrow[c] = __float2bfloat16(0.f);
  int* inv_all = reinterpret_cast<int*>(smem + l.off_inv);
  for (int e = tid; e < 2 * s.p.units * s.br; e += kWgThreads) inv_all[e] = -1;
  if (INT8)   // this CTA's tile scales, all in flight at once
    for (int e = tid; e < nblk * nu; e += kWgThreads) {
      const int b = e / nu;
      sc_all[e] = __ldg(scales + wg_tile_id(s, ex, u0 + e - b * nu, j0 + b));
    }
  __syncthreads();
  if (!vec)
    for (int p = 0; p < ST && p < nblk; ++p) {
      if (p < ST - 1)
        wg_plain_x(s, xring + p * l.xslot, xbar0 + p * 8, x, ex, j0 + p, m0,
                   mt);
      wg_plain_tiles<INT8>(s, tring + p * l.tslot, tbar0 + p * 8, vals,
                           row_idx, col_idx, ex, u0, nu, j0 + p);
    }
  bar_wait(tbar0, 0);
  __syncthreads();
  // tile slot 0's phase done: arm it for tiles ST (iteration 0's refill)
  if (vec && tid == 0 && ST < nblk) wg_arm(s, 0u, tbar0, nu);
  wg_expand<INT8>(s, smem, tring, 0, 0, nu, sc_all);

  // the lane's A rows: its ldmatrix row of each of the warp's two m16
  // slabs (16 rows of each of its warpgroup's two m64 slabs): the unit and
  // row's inverse-map entry, or -1 past the CTA's rows
  const int wg = warp >> 2, wq = warp & 3;
  const int a_lane_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_kc = lane >> 4;
  int a_inv[2], a_eu[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int n = wg * 128 + a * 64 + wq * 16 + a_lane_row;
    a_inv[a] = -1;
    a_eu[a] = 0;
    if (n < qn) {
      const int u = (q0 + n) / s.br;
      a_inv[a] = (u - u0) * s.br + q0 + n - u * s.br;
      a_eu[a] = (u - u0) * s.R;
    }
  }
  float acc[2][4][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][b][c][q] = 0.f;
  const int rb = l.as * 2;

  for (int jl = 0; jl < nblk; ++jl) {
    // block jl expanded; block jl-1's products done (its x slot free) and
    // block jl's tiles expanded (its tile slot free)
    __syncthreads();
    const int nx = jl + ST - 1, nt = jl + ST;
    if (!vec) {
      if (nx < nblk)
        wg_plain_x(s, xring + (nx % ST) * l.xslot, xbar0 + (nx % ST) * 8, x,
                   ex, j0 + nx, m0, mt);
      if (nt < nblk)
        wg_plain_tiles<INT8>(s, tring + (nt % ST) * l.tslot,
                             tbar0 + (nt % ST) * 8, vals, row_idx, col_idx,
                             ex, u0, nu, j0 + nt);
    } else if (lane == 0) {   // copy k from warp k mod 8 (armed before)
      const int kxs = nx < nblk ? kx : 0, kts = nt < nblk ? kc - kx : 0;
      for (int k = warp; k < kxs + kts; k += kWgThreads / 32)
        wg_copy<INT8>(s, k + kx - kxs, kx, xring + (nx % ST) * l.xslot,
                      xbar0 + (nx % ST) * 8, xmap, j0 + nx, m0,
                      tring + (nt % ST) * l.tslot, tbar0 + (nt % ST) * 8,
                      vals, row_idx, col_idx, ex, u0, j0 + nt);
    }
    const int buf = jl & 1;
    const int* inv = inv_all + buf * s.p.units * s.br;
    const unsigned char* eb = smem + l.off_e + (size_t)buf * l.ebuf;
    uint32_t arow[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      arow[a] = smem_u32(zrow);
      if (a_inv[a] >= 0) {
        const int e = inv[a_inv[a]];
        if ((e >> kTagShift) == jl)
          arow[a] = smem_u32(eb + (a_eu[a] + (e & ((1 << kTagShift) - 1))) *
                                      rb);
      }
      arow[a] += a_kc * 16;
    }
    bar_wait(xbar0 + (jl % ST) * 8, (jl / ST) & 1);
    const unsigned char* xb = xring + (jl % ST) * l.xslot;
    // one commit group a 64-column atom of B: 4 k16 steps by both slabs
    // (the second atom's A loads overlap the first atom's products)
    uint32_t af[2][2][4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldsm_x4(af[h][a][ks], arow[a] + (h * 4 + ks) * 32);
      wgmma_fence();
      const uint64_t desc = desc_sw128(smem_u32(xb + h * kWgMT * 128));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int a = 0; a < 2; ++a)
          wgmma128(acc[a], af[h][a][ks], desc + 2 * ks, 1);
      wgmma_commit();
    }
    // the block's products run on the tensor cores while the warps expand
    // the next block
    if (jl + 1 < nblk) {
      bar_wait(tbar0 + ((jl + 1) % ST) * 8, ((jl + 1) / ST) & 1);
      wg_expand<INT8>(s, smem, tring + ((jl + 1) % ST) * l.tslot, jl + 1,
                      buf ^ 1, nu, sc_all + (jl + 1) * nu);
    }
    wgmma_wait<0>();
    fence_operands(acc[0]);
    fence_operands(acc[1]);
    // arm the next iteration's refills: x slot jl % ST (block jl's phase
    // done) for x block jl + ST, tile slot (jl+1) % ST (tiles jl+1's phase
    // done) for tiles jl + 1 + ST
    if (vec && tid == 0)
      wg_arm(s, jl + ST < nblk ? xbar0 + (jl % ST) * 8 : 0u,
             jl + 1 + ST < nblk ? tbar0 + ((jl + 1) % ST) * 8 : 0u, nu);
  }

  // fp32 tile → shared memory as [m][n] (row stride kWgRows + 4, so the
  // stores' offsets are constants), over the rings (every copy has
  // landed: each block was waited on)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  constexpr int rs = kWgRows + 4;
  {
    float* rt = red + ((lane & 3) * 2) * rs + wg * 128 + wq * 16 + (lane >> 2);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            // slab a's n8 group 4b + c of the warp's 16 rows
            rt[((4 * b + c) * 8 + (q & 1)) * rs + a * 64 + (q >> 1) * 8] =
                acc[a][b][c][q];
  }
  __syncthreads();

  // a split's partial: 128 rows of kWgRows floats (span of them written)
  constexpr int per = kWgMT * kWgRows;
  if (S > 1) {
    // this split's partial to the workspace; the last split to arrive sums
    // all of them in split order, so y does not depend on arrival order
    float4* wp = reinterpret_cast<float4*>(ws + (gtile * S + sp) * per);
    for (int e = tid; e < kWgMT * kWgRows / 4; e += kWgThreads) {
      const int m = e / (kWgRows / 4), n = (e % (kWgRows / 4)) * 4;
      if (n < span)
        wp[e] = *reinterpret_cast<const float4*>(red + m * rs + n);
    }
    __threadfence();
    __syncthreads();
    int* flag = reinterpret_cast<int*>(smem + l.off_flag);
    if (tid == 0) *flag = atomicAdd(counters + gtile, 1) == S - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
  }

  // emit: bias, SwiGLU (gate row q, up row q + br of each pair of units),
  // x's dtype. Where rows allow, a thread keeps one chunk of 8 consecutive
  // outputs (its member, column and bias fixed) and walks the x rows: two
  // float4 reads of the tile, one 16-byte store.
  const float* wt = ws + gtile * S * per;
  const int gy = s.swiglu ? 1 : s.G;
  const int outs = s.swiglu ? qn / 2 : qn;     // output rows of this CTA
  if (s.br % 8 == 0 && s.N % 8 == 0) {
    const int nq = outs / 8, rpp = kWgThreads / nq;
    if (tid < rpp * nq) {
      const int o = (tid % nq) * 8;
      int n, g, col;
      if (s.swiglu) {
        const int pr = o / s.br, r = o - pr * s.br;
        n = pr * 2 * s.br + r;
        g = 0;
        col = (u0 / 2 + pr) * s.br + r;
      } else {
        n = o;
        const int q = q0 + o, u = q / s.br, i = u / s.G;
        g = u - i * s.G;
        col = i * s.br + q - u * s.br;
      }
      // col and N are multiples of 8: 16-byte bias loads where the base is
      float4 bg0 = make_float4(0.f, 0.f, 0.f, 0.f), bg1 = bg0, bu0 = bg0,
             bu1 = bg0;
      if (bias != nullptr) {
        const bool bvec = ((uintptr_t)bias & 15) == 0;
        wg_bias8(bias + ((size_t)ex * s.G + g) * s.N + col, bvec, bg0, bg1);
        if (s.swiglu)
          wg_bias8(bias + ((size_t)ex * s.G + 1) * s.N + col, bvec, bu0, bu1);
      }
      bf16* yp = y + (((size_t)ex * gy + g) * s.M + m0) * s.N + col;
      for (int m = tid / nq; m < mt; m += rpp) {
        float4 a0, a1;
        wg_sum8(red, rs, wt, per, S, sp, m, n, a0, a1);
        add4(a0, bg0);
        add4(a1, bg1);
        if (s.swiglu) {
          float4 b0, b1;
          wg_sum8(red, rs, wt, per, S, sp, m, n + s.br, b0, b1);
          add4(b0, bu0);
          add4(b1, bu1);
          a0 = make_float4(silu(a0.x) * b0.x, silu(a0.y) * b0.y,
                           silu(a0.z) * b0.z, silu(a0.w) * b0.w);
          a1 = make_float4(silu(a1.x) * b1.x, silu(a1.y) * b1.y,
                           silu(a1.z) * b1.z, silu(a1.w) * b1.w);
        }
        *reinterpret_cast<uint4*>(yp + (size_t)m * s.N) =
            make_uint4(pack_bf16(a0.x, a0.y), pack_bf16(a0.z, a0.w),
                       pack_bf16(a1.x, a1.y), pack_bf16(a1.z, a1.w));
      }
    }
  } else {
    for (int e = tid; e < mt * outs; e += kWgThreads) {
      const int m = e / outs, o = e - m * outs;
      int n, g, col;
      if (s.swiglu) {
        const int pr = o / s.br, r = o - pr * s.br;
        n = pr * 2 * s.br + r;
        g = 0;
        col = (u0 / 2 + pr) * s.br + r;
      } else {
        n = o;
        const int q = q0 + o, u = q / s.br, i = u / s.G;
        g = u - i * s.G;
        col = i * s.br + q - u * s.br;
      }
      float v = wg_sum1(red, rs, wt, per, S, sp, m, n);
      if (bias != nullptr) v += bias[((size_t)ex * s.G + g) * s.N + col];
      if (s.swiglu) {
        float up = wg_sum1(red, rs, wt, per, S, sp, m, n + s.br);
        if (bias != nullptr) up += bias[((size_t)ex * s.G + 1) * s.N + col];
        v = silu(v) * up;
      }
      y[(((size_t)ex * gy + g) * s.M + m0 + m) * s.N + col] =
          __float2bfloat16(v);
    }
  }
  if (S > 1 && tid == 0) counters[gtile] = 0;   // ready for the next call
}

// One body under two names, so a profile tells bcr_spmm's launches from
// bcr_spmm_grouped's.
#define BCR_WG_KERNEL(NAME)                                                  \
  template <bool INT8, bool STACKED>                                         \
  __global__ void __launch_bounds__(kWgThreads, 1)                           \
  NAME(const __grid_constant__ CUtensorMap xmap, const bf16* x,              \
       const void* vals, const float* scales, const int* row_idx,            \
       const int* col_idx, const float* bias, bf16* y, float* ws,            \
       int* counters, const WgShape s) {                                     \
    wg_body<INT8, STACKED>(&xmap, x, vals, scales, row_idx, col_idx, bias,   \
                           y, ws, counters, s);                              \
  }
BCR_WG_KERNEL(bcr_spmm_wg)
BCR_WG_KERNEL(bcr_spmm_grouped_wg)
#undef BCR_WG_KERNEL

template <bool INT8, bool STACKED>
int wg_launch_cfg(const WgShape& s, cudaStream_t stream, void** args) {
  auto kernel = s.grouped ? bcr_spmm_grouped_wg<INT8, STACKED>
                          : bcr_spmm_wg<INT8, STACKED>;
  static int smem_set[2] = {0, 0};   // per kernel: raise the limit once
  if (s.p.smem > smem_set[s.grouped]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.p.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[s.grouped] = s.p.smem;
  }
  const int grid = s.p.groups * s.m_tiles * s.p.splits;
  cudaError_t err = cudaLaunchKernel((const void*)kernel, dim3(grid, s.E),
                                     dim3(kWgThreads), args, s.p.smem,
                                     stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One launch of the wide body (plan[0] == 128): operands as for
// bcr_spmm_launch.
inline int wg_launch(int int8_tiles, int swiglu, int grouped, const void* x,
                     const void* vals, const float* scales,
                     const int* row_idx, const int* col_idx,
                     const float* bias, void* y, float* ws, int* counters,
                     int M, int K, int N, int G, int nb_r, int nb_c, int br,
                     int bc, int R, int C, int E, const int* plan,
                     cudaStream_t st) {
  WgShape s;
  s.M = M; s.K = K; s.N = N; s.G = G; s.nb_r = nb_r; s.nb_c = nb_c;
  s.br = br; s.bc = bc; s.R = R; s.C = C; s.E = E; s.Q = G * N;
  s.int8_tiles = int8_tiles; s.swiglu = swiglu; s.grouped = grouped != 0;
  s.p = WgPlan{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
               plan[6], plan[7], plan[8]};
  const WgPlan& p = s.p;
  s.m_tiles = (M + kWgMT - 1) / kWgMT;
  if (bc != kWgBC || br < 1 || R < 1 || C < 1 || R >= (1 << kTagShift) ||
      p.span < 8 || p.span > kWgRows || p.span % 8 || p.stages < 3 ||
      p.splits < 1 || p.splits > nb_c ||
      p.groups != (s.Q + p.span - 1) / p.span ||
      p.units != wg_units(p.span, br) ||
      (swiglu && (G != 2 || p.span % (2 * br))))
    return (int)cudaErrorInvalidValue;
  s.l = make_wg_layout(s);
  if (s.l.total != p.smem) return -1;   // plan and layout disagree
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  if (p.vec) {   // the plan's copies need 16-byte aligned operands
    if ((uintptr_t)x % 16 || (uintptr_t)vals % 16 || (uintptr_t)row_idx % 16 ||
        (uintptr_t)col_idx % 16)
      return -2;
    if (!hopper::make_map(&xmap, x, (uint64_t)E * M, K, kWgMT, 64, true))
      return -3;
  }
  void* args[] = {(void*)&xmap, (void*)&x, (void*)&vals, (void*)&scales,
                  (void*)&row_idx, (void*)&col_idx, (void*)&bias, (void*)&y,
                  (void*)&ws, (void*)&counters, (void*)&s};
  if (int8_tiles)
    return E > 1 ? wg_launch_cfg<true, true>(s, st, args)
                 : wg_launch_cfg<true, false>(s, st, args);
  return E > 1 ? wg_launch_cfg<false, true>(s, st, args)
               : wg_launch_cfg<false, false>(s, st, args);
}

// ---------------------------------------------------------------------------
// The short-block body: bf16 x, G = 1, one unstacked pack, blocks shorter
// than one m16 slab (br < 16). Design notes at the head of the file.
// ---------------------------------------------------------------------------

constexpr int kShortWarps = 8;
constexpr int kShortThreads = kShortWarps * 32;

// The plan kernels/bcr_spmm.py:launch_plan chose, in the order of its
// LaunchPlan.args() for the short body.
struct ShortPlan {
  int mt, slabs, warps_m, rows, J, splits, slots, vec, smem;
};

// q = n / d for 0 <= n < 2^31 by one multiply-high (Granlund and
// Montgomery): the scatter decodes each kept weight's place with it.
struct FastDiv {
  uint32_t m, s;
};

inline FastDiv fast_div(uint32_t d) {
  FastDiv f;
  f.s = 0;
  while ((1ull << f.s) < d) ++f.s;
  f.m = (uint32_t)(((1ull << 32) * ((1ull << f.s) - d)) / d + 1);
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return (int)((__umulhi((uint32_t)n, f.m) + (uint32_t)n) >> f.s);
}

// Byte offsets of shared memory, as kernels/bcr_spmm.py:short_smem_layout
// computes them (the launcher refuses a plan whose total disagrees). A ring
// slot holds one stage: the x block (M tile rows of ks columns, padded by
// 8 so ldmatrix rows hit distinct banks), then, for each of the CTA's P
// block rows, its runs of tile values, row and column indices (and int8
// scales) over the stage's blocks, each with the room of the 16-byte chunks
// that cover it at any alignment. Then the two expanded A buffers (rows ×
// ks, the same padded stride). The epilogue's fp32 tile (one per k-split
// warp set) aliases the ring; the split flag follows both.
struct ShortLayout {
  int ks, stride;                  // stage depth (elements); row bytes
  int seg_v, seg_r, seg_c, seg_s;  // one block row's run of each array
  int off_v, off_r, off_c, off_s;  // within a slot (the x block at 0)
  int slot, off_a, off_flag, total;
};

struct ShortShape {
  int M, K, N, nb_r, nb_c, br, bc, R, C;
  int p, groups, m_tiles, n_st, wr, wk;   // block rows a CTA; warp layout
  FastDiv f_rc, f_c, f_j, f_cpr;
  ShortPlan q;
  ShortLayout l;
};

inline int cover16(int n) { return up16(n + 15); }

inline ShortLayout make_short_layout(const ShortShape& s, int int8_tiles) {
  ShortLayout l;
  const int J = s.q.J, elt = int8_tiles ? 1 : 2;
  l.ks = up16(J * s.bc);
  l.stride = (l.ks + 8) * 2;
  l.seg_v = cover16(J * s.R * s.C * elt);
  l.seg_r = cover16(J * s.R * 4);
  l.seg_c = cover16(J * s.C * 4);
  l.seg_s = int8_tiles ? cover16(J * 4) : 0;
  l.off_v = s.q.mt * l.stride;
  l.off_r = l.off_v + s.p * l.seg_v;
  l.off_c = l.off_r + s.p * l.seg_r;
  l.off_s = l.off_c + s.p * l.seg_c;
  l.slot = up(l.off_s + s.p * l.seg_s, 128);
  l.off_a = s.q.slots * l.slot;
  const int main_end = l.off_a + 2 * s.q.rows * l.stride;
  const int red = s.wk * s.q.mt * (s.q.rows + 4) * 4;
  l.off_flag = main_end > red ? main_end : red;
  l.total = l.off_flag + 16;
  return l;
}

// A run of n bytes at src, copied to dst + (src mod 16) as the 16-byte
// aligned chunks that cover it, a lane a chunk. A chunk never leaves the
// 16-byte granule of a byte of the run, so never its allocation.
__device__ __forceinline__ void run_copy(unsigned char* dst, const void* src,
                                         int n, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const int chunks = (int)((a + n - a0 + 15) >> 4);
  for (int c = lane; c < chunks; c += 32)
    cp16(smem_u32(dst + c * 16), reinterpret_cast<const void*>(a0 + c * 16),
         true);
}

// Stage st (contraction blocks [st·J, st·J + nb)) of block-row group g
// into slot sl, by 16-byte cp.async from every thread: the x block (zeros
// past M, past the stage's columns and so past K) and, a warp a block row,
// its runs of the four arrays. A plan without vec loads the x block
// plainly (x rows that are not 16-byte multiples).
template <bool INT8>
__device__ __forceinline__ void short_issue(
    const ShortShape& s, unsigned char* sl, const bf16* __restrict__ x,
    const void* __restrict__ vals, const float* __restrict__ scales,
    const int* __restrict__ row_idx, const int* __restrict__ col_idx, int g,
    int m0, int mt, int st) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ShortLayout& l = s.l;
  const int J = s.q.J, j0 = st * J, nb = min(J, s.nb_c - j0);
  const int cols = nb * s.bc, MT = s.q.mt;
  const bf16* xb = x + (size_t)m0 * s.K + (size_t)j0 * s.bc;
  if (s.q.vec) {
    const int cpr = l.ks / 8;
    for (int e = tid; e < MT * cpr; e += kShortThreads) {
      const int m = fdiv(e, s.f_cpr), c8 = e - m * cpr;
      const bool ok = m < mt && c8 * 8 < cols;
      cp16(smem_u32(sl + m * l.stride + c8 * 16),
           ok ? xb + (size_t)m * s.K + c8 * 8 : x, ok);
    }
  } else {
    bf16* xs = reinterpret_cast<bf16*>(sl);
    const int row = l.stride / 2;
    for (int e = tid; e < MT * l.ks; e += kShortThreads) {
      const int m = e / l.ks, c = e - m * l.ks;
      xs[m * row + c] = m < mt && c < cols ? xb[(size_t)m * s.K + c]
                                           : __float2bfloat16(0.f);
    }
  }
  const int i0 = g * s.p, RC = s.R * s.C, ev = INT8 ? 1 : 2;
  for (int p = warp; p < s.p && i0 + p < s.nb_r; p += kShortWarps) {
    const size_t blk = (size_t)(i0 + p) * s.nb_c + j0;
    run_copy(sl + l.off_v + p * l.seg_v,
             static_cast<const unsigned char*>(vals) + blk * RC * ev,
             nb * RC * ev, lane);
    run_copy(sl + l.off_r + p * l.seg_r, row_idx + blk * s.R, nb * s.R * 4,
             lane);
    run_copy(sl + l.off_c + p * l.seg_c, col_idx + blk * s.C, nb * s.C * 4,
             lane);
    if (INT8)
      run_copy(sl + l.off_s + p * l.seg_s, scales + blk, nb * 4, lane);
  }
}

// The kept tiles of stage st, staged in slot sl, written across their
// blocks into the zeroed A buffer: block row p's tile of block jj lands at
// rows p·br + row_idx, columns jj·bc + col_idx (int8 codes widened with
// their tile's scale folded in, bf16(code × scale)). Every other element
// stays zero: the tile expanded to its whole block, the reference's
// gather → tile → scatter one-hots in one operand. A thread takes every
// 256th kept weight, four at a time, so four weights' index and value
// loads are in flight together.
template <bool INT8>
__device__ __forceinline__ void short_scatter(
    const ShortShape& s, const unsigned char* sl, unsigned char* a_buf,
    const void* vals, const float* scales, const int* row_idx,
    const int* col_idx, int g, int st) {
  const ShortLayout& l = s.l;
  const int J = s.q.J, j0 = st * J, nb = min(J, s.nb_c - j0);
  const int RC = s.R * s.C, i0 = g * s.p;
  const int total = min(s.p, s.nb_r - i0) * J * RC;
  const uint32_t ev = INT8 ? 1 : 2;
  // the low address bits of each array: a run's offset mod 16 in its slot
  const uint32_t lo_v = (uint32_t)reinterpret_cast<uintptr_t>(vals);
  const uint32_t lo_r = (uint32_t)reinterpret_cast<uintptr_t>(row_idx);
  const uint32_t lo_c = (uint32_t)reinterpret_cast<uintptr_t>(col_idx);
  const uint32_t lo_s = (uint32_t)reinterpret_cast<uintptr_t>(scales);
  const int arow = l.stride / 2;
  bf16* A = reinterpret_cast<bf16*>(a_buf);
  for (int e0 = threadIdx.x; e0 < total; e0 += 4 * kShortThreads) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kShortThreads;
      const int t = fdiv(e, s.f_rc), rc = e - t * RC;
      const int p = fdiv(t, s.f_j), jj = t - p * J;
      if (e >= total || jj >= nb) continue;
      const int r = fdiv(rc, s.f_c), c = rc - r * s.C;
      const uint32_t blk = (uint32_t)(i0 + p) * (uint32_t)s.nb_c + j0;
      const unsigned char* vs = sl + l.off_v + p * l.seg_v +
                                ((lo_v + blk * (uint32_t)RC * ev) & 15);
      const int* rs = reinterpret_cast<const int*>(
          sl + l.off_r + p * l.seg_r +
          ((lo_r + blk * (uint32_t)s.R * 4) & 15));
      const int* cs = reinterpret_cast<const int*>(
          sl + l.off_c + p * l.seg_c +
          ((lo_c + blk * (uint32_t)s.C * 4) & 15));
      const int idx = jj * RC + rc;
      bf16 v;
      if (INT8) {
        const float* ss = reinterpret_cast<const float*>(
            sl + l.off_s + p * l.seg_s + ((lo_s + blk * 4u) & 15));
        v = __float2bfloat16(
            (float)reinterpret_cast<const int8_t*>(vs)[idx] * ss[jj]);
      } else {
        v = reinterpret_cast<const bf16*>(vs)[idx];
      }
      A[(p * s.br + rs[jj * s.R + r]) * arow + jj * s.bc +
        cs[jj * s.C + c]] = v;
    }
  }
}

__device__ __forceinline__ void zero_bytes(unsigned char* p, int bytes) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int e = threadIdx.x; e < bytes / 16; e += kShortThreads)
    q[e] = make_uint4(0, 0, 0, 0);
}

// One stage's products for one warp: SLABS m16 slabs of A (ldmatrix rows
// from a_addr) by NI n8 tiles of the x block (from b_addr), k16 steps ks0,
// ks0 + wk, ... below ks_n, accumulated into acc.
template <int SLABS, int NI>
__device__ __forceinline__ void short_mma(float (&acc)[SLABS][NI][4],
                                          uint32_t a_addr, uint32_t b_addr,
                                          int stride, int ks0, int ks_n,
                                          int wk) {
  for (int ks = ks0; ks < ks_n; ks += wk) {
    uint32_t af[SLABS][4];
#pragma unroll
    for (int a = 0; a < SLABS; ++a)
      ldsm_x4(af[a], a_addr + a * 16 * stride + ks * 32);
    uint32_t bfr[NI][2];
    if (NI == 1) {
      ldsm_x2(bfr[0][0], bfr[0][1], b_addr + ks * 32);
    } else {
#pragma unroll
      for (int b = 0; b < (NI == 1 ? 1 : NI / 2); ++b) {
        uint32_t r4[4];
        ldsm_x4(r4, b_addr + b * 16 * stride + ks * 32);
        bfr[2 * b][0] = r4[0];
        bfr[2 * b][1] = r4[1];
        bfr[(2 * b + 1) % NI][0] = r4[2];
        bfr[(2 * b + 1) % NI][1] = r4[3];
      }
    }
#pragma unroll
    for (int a = 0; a < SLABS; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b) mma(acc[a][b], af[a], bfr[b][0], bfr[b][1]);
  }
}

// One CTA: output rows [g·P·br, (g+1)·P·br) (P block rows, the MMA's M
// side) by x rows [m0, m0 + MT) (its N side), over the stages of split sp.
// Warp (wr, wm, wk) owns SLABS m16 slabs by NI n8 tiles and every wk-th k16
// step; the k-split warps' partials are summed in order at the end.
template <bool INT8, int SLABS, int NI>
__global__ void __launch_bounds__(kShortThreads)
    bcr_spmm_short_tc(const bf16* __restrict__ x,
                      const void* __restrict__ vals,
                      const float* __restrict__ scales,
                      const int* __restrict__ row_idx,
                      const int* __restrict__ col_idx, bf16* __restrict__ y,
                      float* __restrict__ ws, int* __restrict__ counters,
                      const ShortShape s) {
  extern __shared__ __align__(128) unsigned char smem_short[];
  unsigned char* smem = smem_short;
  const ShortLayout& l = s.l;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int MT = s.q.mt, S = s.q.splits, rows = s.q.rows;
  // the groups of one M tile run side by side: its x block is read from
  // device memory once and from L2 by the others
  const int sp = blockIdx.x % S, tile = blockIdx.x / S;
  const int g = tile % s.groups, mtile = tile / s.groups;
  const int m0 = mtile * MT, mt = min(MT, s.M - m0);
  const int st0 = (int)((long long)sp * s.n_st / S);
  const int n_loc = (int)((long long)(sp + 1) * s.n_st / S) - st0;
  const int wk = warp % s.wk, wt = warp / s.wk;
  const int wm = wt % s.q.warps_m, wr = wt / s.q.warps_m;
  const int row0 = wr * SLABS * 16;

  unsigned char* abuf = smem + l.off_a;
  const int abytes = rows * l.stride;
  zero_bytes(abuf, abytes);
  // two stages in flight ahead of the one being computed
  for (int p = 0; p < 2; ++p) {
    if (p < n_loc)
      short_issue<INT8>(s, smem + (p % s.q.slots) * l.slot, x, vals, scales,
                        row_idx, col_idx, g, m0, mt, st0 + p);
    cp_commit();
  }

  float acc[SLABS][NI][4];
#pragma unroll
  for (int a = 0; a < SLABS; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.f;
  const int a_lane_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_kc = lane >> 4;
  const int b_lane_row = NI == 1 ? (lane & 7) : ((lane >> 4) * 8 + (lane & 7));
  const int b_kc = (lane >> 3) & 1;
  const uint32_t a_off = (row0 + a_lane_row) * l.stride + a_kc * 16;
  const uint32_t b_off = (wm * NI * 8 + b_lane_row) * l.stride + b_kc * 16;

  for (int it = 0; it < n_loc; ++it) {
    cp_wait<1>();
    // stage it landed (every thread's copies); stage it-1's products done,
    // so its slot and A buffer are free
    __syncthreads();
    if (it + 2 < n_loc)
      short_issue<INT8>(s, smem + ((it + 2) % s.q.slots) * l.slot, x, vals,
                        scales, row_idx, col_idx, g, m0, mt, st0 + it + 2);
    cp_commit();
    if (it + 1 < n_loc) zero_bytes(abuf + ((it + 1) & 1) * abytes, abytes);
    unsigned char* slot = smem + (it % s.q.slots) * l.slot;
    unsigned char* ab = abuf + (it & 1) * abytes;
    short_scatter<INT8>(s, slot, ab, vals, scales, row_idx, col_idx, g,
                        st0 + it);
    __syncthreads();
    const int nb = min(s.q.J, s.nb_c - (st0 + it) * s.q.J);
    short_mma<SLABS, NI>(acc, smem_u32(ab) + a_off, smem_u32(slot) + b_off,
                         l.stride, wk, (nb * s.bc + 15) / 16, s.wk);
  }
  cp_wait<0>();
  __syncthreads();

  // fp32 tile → shared memory as [wk][m][n] (row stride rows + 4), over the
  // ring; then the k-split warps' partials summed in order into [0]
  float* red = reinterpret_cast<float*>(smem);
  const int rs = rows + 4;
#pragma unroll
  for (int a = 0; a < SLABS; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = row0 + a * 16 + (lane >> 2) + (q >> 1) * 8;
        const int m = wm * NI * 8 + b * 8 + (lane & 3) * 2 + (q & 1);
        red[((size_t)wk * MT + m) * rs + n] = acc[a][b][q];
      }
  __syncthreads();
  const int per = MT * rows;
  if (s.wk > 1) {
    for (int e = tid; e < per; e += kShortThreads) {
      const int m = e / rows, n = e - m * rows;
      float v = red[m * rs + n];
      for (int k = 1; k < s.wk; ++k) v += red[((size_t)k * MT + m) * rs + n];
      red[m * rs + n] = v;
    }
    __syncthreads();
  }
  if (S > 1) {
    // this split's partial to the workspace; the last split to arrive sums
    // all of them in split order, so y does not depend on arrival order
    float* wp = ws + ((size_t)tile * S + sp) * per;
    for (int e = tid; e < per; e += kShortThreads) {
      const int m = e / rows, n = e - m * rows;
      wp[e] = red[m * rs + n];
    }
    __threadfence();
    __syncthreads();
    int* flag = reinterpret_cast<int*>(smem + l.off_flag);
    if (tid == 0) *flag = atomicAdd(counters + tile, 1) == S - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
  }
  const int n0 = g * s.p * s.br;
  const int nv = min(s.p * s.br, s.N - n0);
  const float* parts = ws + (size_t)tile * S * per;
  for (int e = tid; e < mt * nv; e += kShortThreads) {
    const int m = e / nv, n = e - m * nv;
    float v;
    if (S > 1) {
      const size_t o = (size_t)m * rows + n;
      v = __ldcg(parts + o);
      for (int q = 1; q < S; ++q) v += __ldcg(parts + (size_t)q * per + o);
    } else {
      v = red[m * rs + n];
    }
    y[(size_t)(m0 + m) * s.N + n0 + n] = __float2bfloat16(v);
  }
  if (S > 1 && tid == 0) counters[tile] = 0;   // ready for the next call
}

template <bool INT8, int SLABS, int NI>
int short_launch_cfg(const ShortShape& s, cudaStream_t stream, void** args) {
  auto kernel = bcr_spmm_short_tc<INT8, SLABS, NI>;
  static int smem_set = 0;   // raise the limit once
  if (s.q.smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.q.smem);
    // all of L1 as shared memory, so small CTAs share an SM four at a time
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = s.q.smem;
  }
  const int grid = s.groups * s.m_tiles * s.q.splits;
  cudaError_t err = cudaLaunchKernel((const void*)kernel, dim3(grid),
                                     dim3(kShortThreads), args, s.q.smem,
                                     stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The compiled warp tiles (m16 slabs × n8 tiles a warp):
// kernels/bcr_spmm.py:SHORT_CONFIGS.
template <bool INT8>
int short_dispatch(const ShortShape& s, cudaStream_t st, void** args) {
  const int ni = s.q.mt / (8 * s.q.warps_m), sl = s.q.slabs;
#define BCR_SHORT(A, B) \
  if (sl == A && ni == B) return short_launch_cfg<INT8, A, B>(s, st, args);
  BCR_SHORT(1, 1)
  BCR_SHORT(1, 2)
  BCR_SHORT(1, 4)
  BCR_SHORT(2, 4)
  BCR_SHORT(1, 8)
  BCR_SHORT(2, 8)
#undef BCR_SHORT
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ===========================================================================
// fp32-activation forms: the CUDA cores
// ===========================================================================

namespace f32 {

using namespace hopper;
using tc::cover16;
using tc::fast_div;
using tc::fdiv;
using tc::FastDiv;
using tc::run_copy;
using tc::up;
using tc::up16;

// The plan kernels/bcr_spmm.py:fp32_plan chose, in the order of its
// LaunchPlan.args() for the fp32 body.
struct Plan {
  int mt;        // M tile: warps_m · lanes_m · U x rows
  int T, U;      // output rows of one warp item; x rows of one lane
  int lm, wm;    // lanes across the M tile; warps across the M tile
  int nu, cr;    // units (one member's block row) a CTA; row chunks of each
  int J;         // contraction blocks a stage
  int splits, slots, vec, smem;
};

// Byte offsets of shared memory, as kernels/bcr_spmm.py:fp32_smem_layout
// computes them (the launcher refuses a plan whose total disagrees). A ring
// slot holds one stage: the x block transposed (J·bc + 1 columns of the M
// tile's rows, columns xstride floats apart: at U = 4 an odd multiple of 4,
// so a lane reads its 4 rows of a column as one 16-byte load, else odd; the
// last column zeros, which padded column offsets read), then for each of the
// CTA's units its tiles (fp32
// rows of Cp = C_keep rounded up to 4 floats, zero-padded; or the raw int8
// codes), its runs of row and column indices (and int8 scales), each with
// room for the 16-byte chunks that cover it at any alignment. Then two
// inverse row maps, two column-offset tables and, under int8 tiles, two
// widened fp32 tile buffers. The epilogue's fp32 tile aliases the ring;
// the split flag follows everything.
struct Layout {
  int xstride, cp, brp;            // x column (floats), kept row, map row
  int x_bytes, tile, raw, seg_r, seg_c, seg_s;
  int off_raw, off_r, off_c, off_s, slot;
  int off_inv, inv_buf, off_colx, colx_buf, off_wide, main;
  int ru, red_stride, off_flag, total;
};

struct Shape {
  int M, K, N, G, nb_r, nb_c, br, bc, R, C, E;
  int int8_tiles, swiglu;
  int chunks, ncg, units, ugroups, groups, m_tiles, n_st, nch;
  int log_lm, log_lc, nlb;         // lane = (lb · LC + lc) · LM + lm
  FastDiv f_jr, f_r, f_jc, f_cp, f_jrc, f_c, f_per;
  Plan q;
  Layout l;
};

inline Layout make_layout(const Shape& s) {
  Layout l;
  const Plan& q = s.q;
  const int J = q.J, ks = J * s.bc;
  l.xstride = q.U == 4 ? ((q.mt + 3) / 4 | 1) * 4 : q.mt | 1;
  l.cp = (s.C + 3) / 4 * 4;
  l.brp = s.chunks * q.T;
  l.x_bytes = up16((ks + 1) * l.xstride * 4);
  l.tile = J * s.R * l.cp * 4;
  l.raw = s.int8_tiles ? cover16(J * s.R * s.C) : l.tile;
  l.seg_r = cover16(J * s.R * 4);
  l.seg_c = cover16(J * s.C * 4);
  l.seg_s = s.int8_tiles ? cover16(J * 4) : 0;
  l.off_raw = l.x_bytes;
  l.off_r = l.off_raw + q.nu * l.raw;
  l.off_c = l.off_r + q.nu * l.seg_r;
  l.off_s = l.off_c + q.nu * l.seg_c;
  l.slot = up(l.off_s + q.nu * l.seg_s, 128);
  l.off_inv = q.slots * l.slot;
  l.inv_buf = up16(q.nu * J * l.brp * 2);
  l.off_colx = l.off_inv + 2 * l.inv_buf;
  l.colx_buf = q.nu * J * l.cp * 4;
  l.off_wide = l.off_colx + 2 * l.colx_buf;
  l.main = l.off_wide + (s.int8_tiles ? 2 * q.nu * l.tile : 0);
  l.ru = q.cr * q.T < s.br ? q.cr * q.T : s.br;
  l.red_stride = q.nu * l.ru + 1;
  const int red = q.mt * l.red_stride * 4;
  l.off_flag = up16(l.main > red ? l.main : red);
  l.total = l.off_flag + 16;
  return l;
}

// Unit u (member g's block row i, u = i·G + g) → its first tile's index in
// the (G, nb_r, nb_c) grid of tiles, the block of stage column j0.
__device__ __forceinline__ size_t unit_block(const Shape& s, int u, int j0) {
  const int i = s.G == 1 ? u : u / s.G, g = u - i * s.G;
  return ((size_t)g * s.nb_r + i) * s.nb_c + j0;
}

// Stage st (contraction blocks [st·J, st·J + nb)) of units [u0, u0 + nu)
// into slot sl, asynchronously: the x block by 4-byte cp.async, transposed
// (a warp an x row, its lanes along the row's columns; rows past M and
// columns past the stage never copied), each
// unit's fp32 tile rows by 16-byte cp.async where vals is 16-byte aligned
// and C_keep a multiple of 4 (the run of J tiles is then the staged layout
// itself), else by 4-byte cp.async into the zero-padded rows; int8 codes,
// indices and scales as the 16-byte chunks that cover each run.
__device__ __forceinline__ void issue(const Shape& s, unsigned char* sl,
                                      const float* __restrict__ x,
                                      const void* __restrict__ vals,
                                      const float* __restrict__ scales,
                                      const int* __restrict__ row_idx,
                                      const int* __restrict__ col_idx, int u0,
                                      int m0, int mt, int st) {
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nw = nthr >> 5;
  const Layout& l = s.l;
  const int J = s.q.J, nu = s.q.nu, j0 = st * J, nb = min(J, s.nb_c - j0);
  const int cols = nb * s.bc, RC = s.R * s.C;
  const float* xb = x + (size_t)m0 * s.K + (size_t)j0 * s.bc;
  const uint32_t xs = smem_u32(sl);
  for (int m = warp; m < mt; m += nw)
    for (int c = lane; c < cols; c += 32)
      cp4(xs + (c * l.xstride + m) * 4, xb + (size_t)m * s.K + c, true);
  const int nun = min(nu, s.units - u0);
  if (!s.int8_tiles && s.q.vec) {
    const int per = J * RC / 4, live = nb * RC / 4;
    for (int e = tid; e < nun * per; e += nthr) {
      const int un = fdiv(e, s.f_per), c = e - un * per;
      if (c >= live) continue;
      const float* src = static_cast<const float*>(vals) +
                         unit_block(s, u0 + un, j0) * RC + c * 4;
      cp16(smem_u32(sl + l.off_raw + un * l.raw + c * 16), src, true);
    }
  } else if (!s.int8_tiles) {
    for (int un = 0; un < nun; ++un) {
      const float* src =
          static_cast<const float*>(vals) + unit_block(s, u0 + un, j0) * RC;
      const uint32_t dst = smem_u32(sl + l.off_raw + un * l.raw);
      for (int e = tid; e < nb * RC; e += nthr) {
        const int row = fdiv(e, s.f_c), c = e - row * s.C;
        cp4(dst + (row * l.cp + c) * 4, src + e, true);
      }
    }
  }
  for (int un = warp; un < nun; un += nw) {
    const size_t blk = unit_block(s, u0 + un, j0);
    if (s.int8_tiles) {
      run_copy(sl + l.off_raw + un * l.raw,
               static_cast<const int8_t*>(vals) + blk * RC, nb * RC, lane);
      run_copy(sl + l.off_s + un * l.seg_s, scales + blk, nb * 4, lane);
    }
    run_copy(sl + l.off_r + un * l.seg_r, row_idx + blk * s.R, nb * s.R * 4,
             lane);
    run_copy(sl + l.off_c + un * l.seg_c, col_idx + blk * s.C, nb * s.C * 4,
             lane);
  }
}

// Stage st, landed in slot sl, made ready for the products in buffer b:
// the other buffer's inverse row maps cleared (the products of stage st-1
// read them; they are done); for each unit and block, output row row_idx[r]
// → 16 + the byte offset of kept row r in the block's tile (0: not kept);
// each kept column → the byte offset of its x column ((jj·bc + col_idx) ·
// xstride · 4; the pad columns up to Cp → the zero column's); int8 codes
// widened with their tile's scale folded in, fp32(code × scale).
__device__ __forceinline__ void prepare(const Shape& s,
                                        const unsigned char* sl,
                                        unsigned char* smem, const void* vals,
                                        const float* scales,
                                        const int* row_idx,
                                        const int* col_idx, int u0, int st,
                                        int b) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const Layout& l = s.l;
  const int J = s.q.J, j0 = st * J, nb = min(J, s.nb_c - j0);
  const int nun = min(s.q.nu, s.units - u0);
  uint4* other =
      reinterpret_cast<uint4*>(smem + l.off_inv + (b ^ 1) * l.inv_buf);
  for (int e = tid; e < l.inv_buf / 16; e += nthr)
    other[e] = make_uint4(0, 0, 0, 0);
  // the low address bits of each array: a run's offset mod 16 in its slot
  const uint32_t lo_r = (uint32_t)reinterpret_cast<uintptr_t>(row_idx);
  const uint32_t lo_c = (uint32_t)reinterpret_cast<uintptr_t>(col_idx);
  uint16_t* inv = reinterpret_cast<uint16_t*>(smem + l.off_inv + b * l.inv_buf);
  for (int e = tid; e < nun * J * s.R; e += nthr) {
    const int un = fdiv(e, s.f_jr), rem = e - un * J * s.R;
    const int jj = fdiv(rem, s.f_r), r = rem - jj * s.R;
    if (jj >= nb) continue;
    const uint32_t blk = (uint32_t)unit_block(s, u0 + un, j0);
    const int* rs = reinterpret_cast<const int*>(
        sl + l.off_r + un * l.seg_r + ((lo_r + blk * (uint32_t)s.R * 4) & 15));
    inv[(un * J + jj) * l.brp + rs[jj * s.R + r]] =
        (uint16_t)(r * l.cp * 4 + 16);
  }
  int* colx = reinterpret_cast<int*>(smem + l.off_colx + b * l.colx_buf);
  for (int e = tid; e < nun * J * l.cp; e += nthr) {
    const int un = fdiv(e, s.f_jc), rem = e - un * J * l.cp;
    const int jj = fdiv(rem, s.f_cp), c = rem - jj * l.cp;
    if (jj >= nb) continue;
    int v = J * s.bc * l.xstride * 4;
    if (c < s.C) {
      const uint32_t blk = (uint32_t)unit_block(s, u0 + un, j0);
      const int* cs = reinterpret_cast<const int*>(
          sl + l.off_c + un * l.seg_c +
          ((lo_c + blk * (uint32_t)s.C * 4) & 15));
      v = (jj * s.bc + cs[jj * s.C + c]) * l.xstride * 4;
    }
    colx[(un * J + jj) * l.cp + c] = v;
  }
  if (s.int8_tiles) {
    const uint32_t lo_v = (uint32_t)reinterpret_cast<uintptr_t>(vals);
    const uint32_t lo_s = (uint32_t)reinterpret_cast<uintptr_t>(scales);
    const int RC = s.R * s.C;
    float* wide =
        reinterpret_cast<float*>(smem + l.off_wide + b * s.q.nu * l.tile);
    for (int e = tid; e < nun * J * RC; e += nthr) {
      const int un = fdiv(e, s.f_jrc), rem = e - un * J * RC;
      const int jr = fdiv(rem, s.f_c), c = rem - jr * s.C;
      const int jj = fdiv(jr, s.f_r);
      if (jj >= nb) continue;
      const uint32_t blk = (uint32_t)unit_block(s, u0 + un, j0);
      const int8_t* vs = reinterpret_cast<const int8_t*>(
          sl + l.off_raw + un * l.raw + ((lo_v + blk * (uint32_t)RC) & 15));
      const float* ss = reinterpret_cast<const float*>(
          sl + l.off_s + un * l.seg_s + ((lo_s + blk * 4u) & 15));
      wide[(un * J * s.R + jr) * l.cp + c] = (float)vs[rem] * ss[jj];
    }
  }
}

// One 4-column chunk ch of one block for one thread: its U rows of each of
// the chunk's kept x columns (one 16-byte load a column at U = 4), then,
// its T rows in groups of G, the kept rows' float4 loads (issued together)
// before their FMAs. A row the block does not keep is a branch over its
// load and products. xm: the thread's first x row in the stage's x block;
// wb: the block's tile + 16 · (ch - 1) bytes, so a row's inverse-map entry
// is its load's offset.
template <int T, int U>
__device__ __forceinline__ void chunk(const char* xm, const char* wb,
                                      const int* cj, int ch,
                                      const uint32_t (&rr)[(T + 1) / 2],
                                      float (&acc)[T][U]) {
  constexpr int G = T * U >= 64 ? 4 : T < 8 ? T : 8;
  const int4 co = reinterpret_cast<const int4*>(cj)[ch];
  const int cs[4] = {co.x, co.y, co.z, co.w};
  float xg[U][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (U == 4) {
      const float4 v = *reinterpret_cast<const float4*>(xm + cs[e]);
      xg[0][e] = v.x;
      xg[1][e] = v.y;
      xg[2][e] = v.z;
      xg[3][e] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        xg[u][e] = reinterpret_cast<const float*>(xm + cs[e])[u];
    }
  }
#pragma unroll
  for (int o0 = 0; o0 < T; o0 += G) {
    uint32_t r[G];
    float4 w[G];
#pragma unroll
    for (int o = 0; o < G; ++o) {
      const int q = o0 + o;
      r[o] = (q & 1) ? rr[q >> 1] >> 16 : rr[q >> 1] & 0xffffu;
      if (r[o]) w[o] = *reinterpret_cast<const float4*>(wb + r[o]);
    }
#pragma unroll
    for (int o = 0; o < G; ++o) {
      if (r[o]) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float& a = acc[o0 + o][u];
          a = fmaf(w[o].x, xg[u][0], a);
          a = fmaf(w[o].y, xg[u][1], a);
          a = fmaf(w[o].z, xg[u][2], a);
          a = fmaf(w[o].w, xg[u][3], a);
        }
      }
    }
  }
}

// One stage's products for one thread: its warp item's T output rows (rows
// [t0, t0 + T) of unit un) by its U x rows (mbase, mbase + 1, ...), over the
// stage's nb blocks. Lanes share the contraction: lane (lb, lc, lm) takes
// blocks lb, lb + LB, ... and of each the 4-column chunks lc, lc + LC, ...
// The row branches are warp-uniform when LB = 1.
template <int T, int U>
__device__ __forceinline__ void products(const Shape& s, const float* xs,
                                         const float* W, const int* colx,
                                         const uint16_t* inv, int nb, int un,
                                         int t0, int mbase, int lc, int lb,
                                         float (&acc)[T][U]) {
  const Layout& l = s.l;
  const int J = s.q.J, LC = 1 << s.log_lc;
  const char* xm = reinterpret_cast<const char*>(xs + mbase);
  for (int jj = lb; jj < nb; jj += s.nlb) {
    const int blk = un * J + jj;
    // for each of the item's rows 16 + its kept row's byte offset in the
    // block's tile (0: not kept), two a word
    uint32_t rr[(T + 1) / 2];
    const uint16_t* ip = inv + blk * l.brp + t0;
    if constexpr (T % 8 == 0) {
#pragma unroll
      for (int v = 0; v < T / 8; ++v) {
        const uint4 a = reinterpret_cast<const uint4*>(ip)[v];
        rr[4 * v] = a.x;
        rr[4 * v + 1] = a.y;
        rr[4 * v + 2] = a.z;
        rr[4 * v + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int w = 0; w < (T + 1) / 2; ++w)
        rr[w] = reinterpret_cast<const uint32_t*>(ip)[w];
    }
    const char* wj = reinterpret_cast<const char*>(
        W + (size_t)blk * s.R * l.cp) - 16;
    const int* cj = colx + blk * l.cp;
    for (int ch = lc; ch < s.nch; ch += LC)
      chunk<T, U>(xm, wj + 16 * ch, cj, ch, rr, acc);
  }
}

// One CTA: units [u0, u0 + nu) (rows [c0·T, c0·T + cr·T) of each) by x rows
// [m0, m0 + M tile), over the stages of split sp; expert blockIdx.y of a
// stacked pack. Warp (item, wm) owns unit item / cr's rows of chunk c0 +
// item % cr by the wm-th slice of the M tile.
template <int T, int U>
__device__ __forceinline__ void body(const float* __restrict__ x,
                                     const void* __restrict__ vals,
                                     const float* __restrict__ scales,
                                     const int* __restrict__ row_idx,
                                     const int* __restrict__ col_idx,
                                     const float* __restrict__ bias,
                                     float* __restrict__ y,
                                     float* __restrict__ ws,
                                     int* __restrict__ counters,
                                     const Shape& s) {
  extern __shared__ __align__(128) unsigned char smem_f32[];
  unsigned char* smem = smem_f32;
  const Layout& l = s.l;
  const Plan& q = s.q;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5;
  const int S = q.splits, sp = blockIdx.x % S, tile = blockIdx.x / S;
  // the row groups of one M tile run side by side: its x block is read
  // from device memory once and from L2 by the others
  const int rg = tile % s.groups, mtile = tile / s.groups;
  const int ug = rg / s.ncg, c0 = (rg - ug * s.ncg) * q.cr;
  const int u0 = ug * q.nu, m0 = mtile * q.mt, mt = min(q.mt, s.M - m0);
  const int st0 = (int)((long long)sp * s.n_st / S);
  const int n_loc = (int)((long long)(sp + 1) * s.n_st / S) - st0;
  // a stacked pack: every operand holds E equal slices, expert-major
  const size_t ex = blockIdx.y, tiles_e = (size_t)s.G * s.nb_r * s.nb_c;
  x += ex * s.M * s.K;
  vals = static_cast<const unsigned char*>(vals) +
         ex * tiles_e * s.R * s.C * (s.int8_tiles ? 1 : 4);
  if (s.int8_tiles) scales += ex * tiles_e;
  row_idx += ex * tiles_e * s.R;
  col_idx += ex * tiles_e * s.C;
  if (bias != nullptr) bias += ex * s.G * s.N;
  y += ex * (s.swiglu ? 1 : s.G) * s.M * s.N;
  const int tile_g = (int)ex * s.groups * s.m_tiles + tile;

  // zeros everywhere first: x rows past M, the x rows' zero column, the
  // tiles' pad columns, both inverse maps
  for (int e = tid; e < l.main / 16; e += nthr)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  // slots - 1 stages in flight ahead of the one being computed (two in a
  // ring of three), or all of a split's stages at once where the ring holds
  // them
  const bool all = n_loc <= q.slots;
  const int ahead = all ? n_loc : q.slots - 1;
  for (int p = 0; p < ahead; ++p) {
    if (p < n_loc)
      issue(s, smem + p * l.slot, x, vals, scales, row_idx, col_idx, u0, m0,
            mt, st0 + p);
    cp_commit();
  }

  const int item = warp / q.wm, wm = warp - item * q.wm;
  const int un = item / q.cr, t0 = (c0 + item - un * q.cr) * q.T;
  const int lm = lane & ((1 << s.log_lm) - 1), lk = lane >> s.log_lm;
  const int lc = lk & ((1 << s.log_lc) - 1), lb = lk >> s.log_lc;
  const int mbase = wm * (U << s.log_lm) + lm * U;
  float acc[T][U];
#pragma unroll
  for (int o = 0; o < T; ++o)
#pragma unroll
    for (int u = 0; u < U; ++u) acc[o][u] = 0.f;

  for (int it = 0; it < n_loc; ++it) {
    if (all) {
      if (it == 0) cp_wait<0>();
    } else if (ahead == 2) {
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    // stage it landed (every thread's copies); stage it-1's products done,
    // so its slot and the other buffers are free
    __syncthreads();
    if (!all) {
      if (it + ahead < n_loc)
        issue(s, smem + ((it + ahead) % q.slots) * l.slot, x, vals, scales,
              row_idx, col_idx, u0, m0, mt, st0 + it + ahead);
      cp_commit();
    }
    unsigned char* slot = smem + (it % q.slots) * l.slot;
    const int b = it & 1;
    prepare(s, slot, smem, vals, scales, row_idx, col_idx, u0, st0 + it, b);
    __syncthreads();
    const float* W = reinterpret_cast<const float*>(
        s.int8_tiles ? smem + l.off_wide + b * q.nu * l.tile
                     : slot + l.off_raw);
    const int nb = min(q.J, s.nb_c - (st0 + it) * q.J);
    if (u0 + un < s.units && t0 < s.br)
      products<T, U>(s, reinterpret_cast<const float*>(slot), W,
                     reinterpret_cast<const int*>(smem + l.off_colx +
                                                  b * l.colx_buf),
                     reinterpret_cast<const uint16_t*>(smem + l.off_inv +
                                                       b * l.inv_buf),
                     nb, un, t0, mbase, lc, lb, acc);
  }
  cp_wait<0>();
  __syncthreads();

  // the lanes sharing the contraction summed in a fixed order; the fp32
  // tile → shared memory as [m][unit rows] (over the ring)
  for (int o = 32 >> (5 - s.log_lm); o < 32; o <<= 1)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[t][u] += __shfl_xor_sync(0xffffffffu, acc[t][u], o);
  float* red = reinterpret_cast<float*>(smem);
  if (lk == 0) {
    const int lr = t0 - c0 * q.T;   // the item's first row within its unit
#pragma unroll
    for (int o = 0; o < T; ++o)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (lr + o < l.ru && t0 + o < s.br)
          red[(mbase + u) * l.red_stride + un * l.ru + lr + o] = acc[o][u];
  }
  __syncthreads();
  const int rows = q.nu * l.ru, per = q.mt * rows;
  if (S > 1) {
    // this split's partial to the workspace; the last split to arrive sums
    // all of them in split order, so y does not depend on arrival order
    float* wp = ws + ((size_t)tile_g * S + sp) * per;
    for (int e = tid; e < mt * rows; e += nthr) {
      const int m = e / rows, n = e - m * rows;
      wp[e] = red[m * l.red_stride + n];
    }
    __threadfence();
    __syncthreads();
    int* flag = reinterpret_cast<int*>(smem + l.off_flag);
    if (tid == 0) *flag = atomicAdd(counters + tile_g, 1) == S - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
  }
  const float* parts = ws + (size_t)tile_g * S * per;
  auto value = [&](int m, int n) {
    if (S == 1) return red[m * l.red_stride + n];
    // the S partials in split order, eight loads in flight at a time
    const float* pp = parts + (size_t)m * rows + n;
    float v = __ldcg(pp);
    for (int k0 = 1; k0 < S; k0 += 8) {
      float b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        b[i] = k0 + i < S ? __ldcg(pp + (size_t)(k0 + i) * per) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (k0 + i < S) v += b[i];
    }
    return v;
  };
  const int r0 = c0 * q.T;
  if (s.swiglu) {
    // units in gate/up pairs (2k, 2k + 1) = member 0 and 1 of block row i
    const int half = rows / 2;
    for (int e = tid; e < mt * half; e += nthr) {
      const int m = e / half, h = e - m * half;
      const int k = h / l.ru, lr = h - k * l.ru;
      const int u = u0 + 2 * k, row = r0 + lr;
      if (u >= s.units || row >= s.br) continue;
      const int n = (u / 2) * s.br + row;
      float gate = value(m, 2 * k * l.ru + lr);
      float upv = value(m, (2 * k + 1) * l.ru + lr);
      if (bias != nullptr) {
        gate += bias[n];
        upv += bias[(size_t)s.N + n];
      }
      y[(size_t)(m0 + m) * s.N + n] = gate / (1.f + expf(-gate)) * upv;
    }
  } else {
    for (int e = tid; e < mt * rows; e += nthr) {
      const int m = e / rows, qr = e - m * rows;
      const int k = qr / l.ru, lr = qr - k * l.ru;
      const int u = u0 + k, row = r0 + lr;
      if (u >= s.units || row >= s.br) continue;
      const int i = s.G == 1 ? u : u / s.G, g = u - i * s.G;
      const int n = i * s.br + row;
      float v = value(m, qr);
      if (bias != nullptr) v += bias[(size_t)g * s.N + n];
      y[((size_t)g * s.M + m0 + m) * s.N + n] = v;
    }
  }
  if (S > 1 && tid == 0) counters[tile_g] = 0;   // ready for the next call
}

// The compiled configurations (T output rows a warp item, U x rows a lane):
// kernels/bcr_spmm.py:FP32_CONFIGS; at most kWarps warps a CTA
// (FP32_WARPS).
constexpr int kWarps = 16;

#define BCR_F32_KERNELS(NAME)                                                \
  template <int T, int U>                                                    \
  __global__ void __launch_bounds__(kWarps * 32, 1)                          \
      NAME(const float* x, const void* vals, const float* scales,            \
           const int* row_idx, const int* col_idx, const float* bias,        \
           float* y, float* ws, int* counters, const Shape s) {              \
    body<T, U>(x, vals, scales, row_idx, col_idx, bias, y, ws, counters, s); \
  }
BCR_F32_KERNELS(bcr_spmm_fp32)
BCR_F32_KERNELS(bcr_spmm_grouped_fp32)
#undef BCR_F32_KERNELS

template <typename Kernel>
int launch_kernel(Kernel kernel, int& smem_set, const Shape& s, int warps,
                  cudaStream_t stream, void** args) {
  if (s.q.smem > smem_set) {   // raise the limit once
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.q.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = s.q.smem;
  }
  const dim3 grid(s.groups * s.m_tiles * s.q.splits, s.E);
  cudaError_t err = cudaLaunchKernel((const void*)kernel, grid,
                                     dim3(warps * 32), args, s.q.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int T, int U>
int launch_cfg(const Shape& s, int grouped, int warps, cudaStream_t st,
               void** args) {
  if (warps > kWarps) return (int)cudaErrorInvalidValue;
  static int set_plain = 0, set_grouped = 0;
  return grouped ? launch_kernel(bcr_spmm_grouped_fp32<T, U>, set_grouped, s,
                                 warps, st, args)
                 : launch_kernel(bcr_spmm_fp32<T, U>, set_plain, s, warps, st,
                                 args);
}

inline int dispatch(const Shape& s, int grouped, int warps, cudaStream_t st,
                    void** args) {
#define BCR_F32(A, B)                 \
  if (s.q.T == A && s.q.U == B)       \
    return launch_cfg<A, B>(s, grouped, warps, st, args);
  BCR_F32(2, 1)
  BCR_F32(2, 4)
  BCR_F32(8, 1)
  BCR_F32(8, 4)
  BCR_F32(16, 1)
  BCR_F32(16, 4)
#undef BCR_F32
  return (int)cudaErrorInvalidValue;
}

inline int log2i(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return (1 << k) == v ? k : -1;
}

inline int launch(int grouped, int int8_tiles, int swiglu, const void* x,
                  const void* vals, const float* scales, const int* row_idx,
                  const int* col_idx, const float* bias, void* y, float* ws,
                  int* counters, int M, int K, int N, int G, int nb_r,
                  int nb_c, int br, int bc, int R, int C, int E,
                  const int* plan, cudaStream_t st) {
  Shape s;
  s.M = M; s.K = K; s.N = N; s.G = G; s.nb_r = nb_r; s.nb_c = nb_c;
  s.br = br; s.bc = bc; s.R = R; s.C = C; s.E = E;
  s.int8_tiles = int8_tiles; s.swiglu = swiglu;
  s.q = Plan{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
             plan[6], plan[7], plan[8], plan[9], plan[10], plan[11]};
  const Plan& q = s.q;
  s.log_lm = log2i(q.lm);
  // the inverse map's 16-bit entries hold 16 + a kept row's byte offset
  if (br < 1 || R < 1 || C < 1 ||
      (R - 1) * ((C + 3) / 4 * 4) * 4 + 16 > 65535 ||
      q.T < 1 || q.U < 1 ||
      s.log_lm < 0 || q.lm > 32 || q.wm < 1 || q.nu < 1 || q.cr < 1 ||
      q.J < 1 || q.splits < 1 || q.slots < 1 || q.slots > 3 ||
      q.mt != q.wm * q.lm * q.U || (swiglu && (G != 2 || q.nu % 2)))
    return (int)cudaErrorInvalidValue;
  s.chunks = (br + q.T - 1) / q.T;
  if (q.cr > s.chunks) return (int)cudaErrorInvalidValue;
  s.ncg = (s.chunks + q.cr - 1) / q.cr;
  s.units = nb_r * G;
  s.ugroups = (s.units + q.nu - 1) / q.nu;
  s.groups = s.ugroups * s.ncg;
  s.m_tiles = (M + q.mt - 1) / q.mt;
  s.n_st = (nb_c + q.J - 1) / q.J;
  // a ring of one slot holds one stage: every split walks one
  if (q.splits > s.n_st ||
      (q.slots == 1 && (s.n_st + q.splits - 1) / q.splits > 1))
    return (int)cudaErrorInvalidValue;
  s.nch = (C + 3) / 4;
  // lanes sharing the contraction: LC of them over a block's 4-column
  // chunks, LB over the stage's blocks
  const int lk = 32 / q.lm;
  int lc = 1;
  while (lc < lk && lc < s.nch) lc *= 2;
  s.log_lc = log2i(lc);
  s.nlb = lk / lc;
  s.l = make_layout(s);
  if (s.l.total != q.smem) return -1;   // plan and layout disagree
  if (q.vec && (int8_tiles || (uintptr_t)vals % 16 || C % 4)) return -2;
  s.f_jr = fast_div(q.J * R);
  s.f_r = fast_div(R);
  s.f_jc = fast_div(q.J * s.l.cp);
  s.f_cp = fast_div(s.l.cp);
  s.f_jrc = fast_div(q.J * R * C);
  s.f_c = fast_div(C);
  s.f_per = fast_div(q.J * R * C / 4 > 0 ? q.J * R * C / 4 : 1);
  const int warps = q.nu * q.cr * q.wm;
  void* args[] = {(void*)&x, (void*)&vals, (void*)&scales, (void*)&row_idx,
                  (void*)&col_idx, (void*)&bias, (void*)&y, (void*)&ws,
                  (void*)&counters, (void*)&s};
  return dispatch(s, grouped, warps, st, args);
}

}  // namespace f32

extern "C" {

// One launch of either body. dtype: 0 = float32, 1 = bfloat16 (x and y
// share it). grouped: bcr_spmm_grouped's call (its kernels' names).
// int8_tiles = 0: vals in x's dtype, scales unused; 1: int8 vals
// with ([G,] nb_r, nb_c) fp32 scales. bias: (G, N) fp32 or null; swiglu: G
// = 2, y (M, N), else y (G, M, N). E: stacked experts (1 for a plain pack),
// each operand above then E of those, expert-major. plan:
// kernels/bcr_spmm.py:LaunchPlan.args() (ws: its fp32 workspace,
// counters: its zeroed split counters, both null when unsplit, both sized
// for every expert): a tensor-core plan under bf16, fp32_plan's under fp32.
int bcr_spmm_launch(int dtype, int grouped, int int8_tiles, int swiglu,
                    const void* x,
                    const void* vals, const float* scales, const int* row_idx,
                    const int* col_idx, const float* bias, void* y, float* ws,
                    int* counters, int M, int K, int N, int G, int nb_r,
                    int nb_c, int br, int bc, int R, int C, int E,
                    const int* plan, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (E < 1 || E > 65535) return (int)cudaErrorInvalidValue;
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return f32::launch(grouped, int8_tiles, swiglu, x, vals, scales, row_idx,
                       col_idx, bias, y, ws, counters, M, K, N, G, nb_r, nb_c,
                       br, bc, R, C, E, plan, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (plan[0] == tc::kWgMT)
    return tc::wg_launch(int8_tiles, swiglu, grouped, x, vals, scales, row_idx,
                         col_idx, bias, y, ws, counters, M, K, N, G, nb_r,
                         nb_c, br, bc, R, C, E, plan, st);
  tc::Shape s;
  s.M = M; s.K = K; s.N = N; s.G = G; s.nb_r = nb_r; s.nb_c = nb_c;
  s.br = br; s.bc = bc; s.R = R; s.C = C; s.E = E;
  s.int8_tiles = int8_tiles; s.swiglu = swiglu; s.grouped = grouped != 0;
  s.p = tc::Plan{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
                 plan[6], plan[7], plan[8]};
  s.m_tiles = (M + s.p.mt - 1) / s.p.mt;
  s.l = tc::make_layout(s);
  if (s.l.total != s.p.smem) return -1;   // plan and layout disagree
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (s.p.vec) {   // the plan's copies need 16-byte aligned operands
    if ((uintptr_t)x % 16 || (uintptr_t)vals % 16 || (uintptr_t)row_idx % 16 ||
        (uintptr_t)col_idx % 16)
      return -2;
    if (!hopper::make_map(&xmap, x, (uint64_t)E * M, K, s.p.mt, bc, false) ||
        (!int8_tiles &&
         !hopper::make_map(&wmap, vals, (uint64_t)E * G * nb_r * nb_c * R, C,
                           R, C, s.l.swz)))
      return -3;
  }
  void* args[] = {(void*)&xmap, (void*)&wmap, (void*)&x, (void*)&vals,
                  (void*)&scales, (void*)&row_idx, (void*)&col_idx,
                  (void*)&bias, (void*)&y, (void*)&ws, (void*)&counters,
                  (void*)&s};
  return int8_tiles ? tc::dispatch<true>(s, st, args)
                    : tc::dispatch<false>(s, st, args);
}

// One launch of the short-block body (bf16 x and y, G = 1, one unstacked
// pack, br < 16): int8_tiles, operands and ws / counters as for
// bcr_spmm_launch; plan: kernels/bcr_spmm.py:LaunchPlan.args() of a
// short-body plan.
int bcr_spmm_short_launch(int int8_tiles, const void* x, const void* vals,
                          const float* scales, const int* row_idx,
                          const int* col_idx, void* y, float* ws,
                          int* counters, int M, int K, int N, int nb_r,
                          int nb_c, int br, int bc, int R, int C,
                          const int* plan, void* stream) {
  using namespace tc;
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  ShortShape s;
  s.M = M; s.K = K; s.N = N; s.nb_r = nb_r; s.nb_c = nb_c;
  s.br = br; s.bc = bc; s.R = R; s.C = C;
  s.q = ShortPlan{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
                  plan[6], plan[7], plan[8]};
  const ShortPlan& q = s.q;
  if (br < 1 || R < 1 || C < 1 || q.rows < br || q.slabs < 1 ||
      q.warps_m < 1 || q.J < 1 || q.splits < 1 || q.slots < 1 ||
      q.slots > 3 || q.mt % (8 * q.warps_m) || q.rows % (16 * q.slabs))
    return (int)cudaErrorInvalidValue;
  s.wr = q.rows / (16 * q.slabs);
  if (kShortWarps % (s.wr * q.warps_m)) return (int)cudaErrorInvalidValue;
  s.wk = kShortWarps / (s.wr * q.warps_m);
  s.p = q.rows / br;
  s.groups = (nb_r + s.p - 1) / s.p;
  s.m_tiles = (M + q.mt - 1) / q.mt;
  s.n_st = (nb_c + q.J - 1) / q.J;
  if (q.splits > s.n_st) return (int)cudaErrorInvalidValue;
  s.l = make_short_layout(s, int8_tiles);
  if (s.l.total != q.smem) return -1;   // plan and layout disagree
  if (q.vec && ((uintptr_t)x % 16 || K % 8 || (q.J * bc) % 8)) return -2;
  s.f_rc = fast_div(R * C);
  s.f_c = fast_div(C);
  s.f_j = fast_div(q.J);
  s.f_cpr = fast_div(s.l.ks / 8);
  cudaStream_t st = (cudaStream_t)stream;
  void* args[] = {(void*)&x, (void*)&vals, (void*)&scales, (void*)&row_idx,
                  (void*)&col_idx, (void*)&y, (void*)&ws, (void*)&counters,
                  (void*)&s};
  return int8_tiles ? short_dispatch<true>(s, st, args)
                    : short_dispatch<false>(s, st, args);
}

}  // extern "C"
