// GLCM sufficient statistics for one (image, channel) per thread block.
//
// Replaces the TPU kernels of tpumcia/features/pallas_glcm.py in every form
// the single-device extraction runs:
//   _kernel (driven by _pallas_stats_core), maskless or masked (has_mask),
//   emitting dstats (need_diff=False) or the difference histogram
//   (need_diff=True); and _kernel_multi (driven by _pallas_stats_multi_core),
//   the same outputs for up to kMaxOffsets GLCM offsets in one pass; at any
//   image size below 2^24 pixels and any level count up to 32768.
// For every (image, channel) it emits the raw-level histogram, the pixel
// count, the channel max vmax, and per offset (dr, dc) the left/right
// marginals of the rescaled levels (rescale = row lut[clamp(vmax)] of the
// reference's uint8 truncation table), the exact sum(G^2) of the
// co-occurrence matrix G as four int32 limbs, the pair count, and either the
// (2L-1)-bin difference histogram or
//   dstats = [sum G*(d^2 >> 8), sum G*(d^2 & 255), sum G*|d|, sum G/(1+d^2)]
// with d = i - j (the "cheap" encoding below folds the first two).
//
// Masks: a uint8 plane per (image, mask channel); mask_channels is 1 for a
// mask shared by every channel. A pixel counts iff its mask byte is nonzero;
// vmax is the max over masked pixels, -1 when none is; a pair counts iff
// both of its ends are masked. A masked-out pixel's value reaches no table.
//
// The TPU kernels built G with one-hot matrix products, nibble
// factorisations and lane rolls because that chip has no scatter. None of
// that carries over: here every statistic is a shared-memory histogram
// filled with atomics.
//
// What bounds it on an H100. Every form moves a few bytes per pixel (the
// int32 level, a mask byte) and writes per-level tables; no form does
// arithmetic worth counting, so the bound is the bytes over 3.35 TB/s. What
// keeps a block from it is latency: the global loads of its plane and the
// shared-memory atomics of each pixel pair. The design hides the first with
// several resident blocks per SM and spends as few atomics as it can (the
// times quoted below are kernel_ab.py's, this source against a variant of
// it, on an NVIDIA H100 80GB HBM3 at 700 W):
//  - sum(G^2) needs no scan of G. For any per-cell f with f(0) = 0,
//    sum over cells f(G_k) = sum over adds [f(old + 1) - f(old)], where old
//    is the count an atomicAdd(cell, 1) returned. Each thread keeps the four
//    limb deltas in signed 64-bit registers (cheap: f(g) = g^2, delta
//    2*old + 1; generic: the four limbs of g = a*2^12 + b); integer sums
//    are exact in any order, so the limbs do not depend on the order in
//    which the atomics land;
//  - G's counts go into an open-addressing table keyed by k = i*L + j, sized
//    to the pairs (the smallest power of two >= 2x the largest offset's pair
//    window, asked for by the wrapper where it is smaller than G; plan()
//    alone checks what fits in shared memory), not to L^2: 8,192 slots at
//    48x48 and 64x64. At L <= 256 a slot is one u32, a 16-bit key over a 16-bit count
//    (H*W < 65536 keeps every count below 2^16); at the B1d sizes a u64, a
//    32-bit key over a 32-bit count. Each add first tries atomicCAS(empty ->
//    key with count 1), and a slot that already holds the key takes an
//    atomicAdd (reading the slot first was 3-43 % slower at every small-size
//    shape, 2 % faster at 1024 levels; one rule keeps one path). The all-zero
//    word marks an empty slot, which no claimed slot can hold, since its
//    count is at least 1. The table stays at most half full, so linear
//    probes stay short;
//  - one atomic per pair and table: grouping a warp's equal keys with
//    __match_any_sync first costs more than the atomics it saves, on random
//    levels (3.2x the time at 2048x3x64x64) and on the six-level cytometry
//    background alike (1.24x at 2048x12x48x48);
//  - where the plane fits (every main-path shape), the histogram pass leaves
//    the block's levels in shared memory as u16 with the mask folded in as
//    sentinels, and the pair walks read only shared memory: each pixel and
//    mask byte is read from device memory once, with 16-byte loads where
//    H*W % 4 == 0 and the plane is aligned;
//  - dynamic shared memory is sized at launch to what the layout needs (the
//    table and the plane: 40,960 B at 64x64, 37,376 B at 48x48, 94,716 B at
//    48x48 L 1024), and the table layouts run 256-thread blocks held to 64
//    registers a thread, so 4 blocks share an SM at the bench and cytometry
//    shapes and 2 at 1024 levels (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//    printed by chip_smoke.py).
//
// Small sizes (H*W < 65536 and L <= 256: forms B1a, B1b, B1c, B2) take
// glcm_stats_kernel. Where the pair table would be larger than a dense G
// (more than 16,384 pairs at L = 256), G is the dense 256 x 256 u16 table
// packed two per u32 word instead, counted the same way (the delta of the
// returned half-word), still without a scan; its 128 KB hold the SM to one
// block. Several offsets share the histogram pass and the block's launch,
// and reuse the table for each offset in turn.
//
// Large sizes (form B1d: H*W >= 65536 or L > 256, always with the
// difference histogram, which is what the JAX package's entry asks for
// there) take glcm_stats_large_kernel. Its per-level tables (histogram,
// rescale row, both marginals, the difference histogram) are sized from L
// in dynamic shared memory, 6L-1 ints. Where the u64 pair table fits beside
// them and is smaller than a u32 G of L^2 cells (48x48 at L 1024 and 4096),
// one walk of the pair window per offset fills everything. Otherwise (a
// 256x256 plane: 65,280 pairs against 65,536 cells at L 256) G is built in
// bands: a cell can pass 65,535 pairs (a constant 300x300 channel at offset
// (0, 1) puts 89,700 in one), so cells are u32, and a u32 G outgrows shared
// memory (256 KB at L = 256). There
//  - one walk of the pair window fills the marginals, the difference
//    histogram and the pair count. Then the occupied left and right levels
//    (marginal > 0) are ranked, and G is built over those rows and columns
//    only, in bands of R occupied rows x every occupied column, R = band
//    words / occupied columns, in the shared memory left over (the whole
//    opt-in, one 512-thread block per SM). Each band re-walks the pair
//    window (the pixels come back from L1/L2), counts only the pairs whose
//    left level falls in it, and is scanned into the limbs: there the
//    returned counts were slower than the scan (2.79 against 2.25 ms on
//    1200x3x256x256 fields: a returned atomic per pair against a cheap read
//    per cell, at one block per SM). An
//    unoccupied row or column of G is all zeros and adds nothing;
//  - passes per offset: ceil(occupied left levels / R): at worst 2 at
//    L = 256, 21 at L = 1024 and 586 at L = 4096; a channel with few
//    distinct levels takes one.
// Its bounds: L <= kMaxLargeLevels = 4096 (the tables and one band row of L
// cells must fit in shared memory) and H*W < 2^24 (counts exact in f32).
// Its limbs are always the generic ones: the cheap gate needs H*W <= 4096
// and L <= 256, which B1d never meets.
//
// Past 4096 levels (form B1e: 4096 < L <= kMaxWorkspaceLevels = 32768, the
// JAX package's own bound; the difference histogram always, generic limbs)
// the 6L-1 int per-level tables outgrow a block's shared memory (196 KB at
// 8192 levels, 786 KB at 32768), and an L x L rescale table would be 256 MB
// at 8192 levels and 4 GB at 32768. glcm_stats_level_bands_kernel builds
// the per-level tables in level bands, B1d's idea applied to them instead of
// G. The block keeps its plane in shared memory as u16 (raw levels, then
// rescaled in place once the histogram is out; both stay below 2^15, under
// the sentinels). Each band of C levels (C = kBandWords = 16,384 up to
// 64x64: the pair table's own 64 KB, which the bands reuse once G's walk is
// done) is zeroed in shared memory, filled by one walk of the plane's
// pixels (the histogram) or pairs (both marginals and the difference
// histogram, laid end to end: 2 passes an offset at 8192 levels, ml + mr
// then the difference histogram), and emitted. Every output word is written
// once, and nothing per level passes through device memory but the outputs.
// What bounds it: bytes, and the outputs' above all (per item and offset 3L
// + 2L-1 floats: 4.0 GB for 2048x12 items at 8192 levels against 0.23 GB of
// pixels; their bound is 1.271 ms, and this kernel takes 1.658 ms, 77 %,
// where the workspace form before it took 6.309). So:
//  - each counted pixel is rescaled on its own (rescale_level: in double
//    and in the table's order of operations, m/top hoisted per item, so
//    every level equals the table's), not a row of L entries per item;
//  - a band is emitted with 16-byte streaming stores (__stcs: the kernel
//    never reads its outputs back; plain stores took 2.7 % longer at
//    2048x12x48x48), scalar at a row's unaligned head and
//    tail: each table's part of a band sits at a word index congruent to
//    its destination mod 16 bytes (rows of 2L-1 floats, and of any L % 4 !=
//    0, start anywhere). A bulk asynchronous copy (cp.async.bulk) from a
//    double-buffered band would overlap one band's store with the next
//    band's walk, but it needs 16-byte aligned addresses and sizes on both
//    sides, which these rows are not, and a second band would leave 2
//    resident blocks per SM instead of 3; the 3 blocks overlap one block's
//    walks with another's stores instead;
//  - G is still the u64 pair table sized to the pairs, sum(G^2) from the
//    returned counts, its key i*L + j below 2^30. Where the table or the
//    plane cannot stay in shared memory (the table from 128x128 on, the
//    plane past ~160 KB), it lives in a device workspace, one slice per
//    block of a persistent grid (at most kPersistentPerSM blocks per SM)
//    that loops over the items: the workspace holds exactly what does not
//    fit, and nothing at 48x48 or 64x64;
//  - an item's work is a list of jobs (its histogram passes, then per
//    offset G's walk and the band passes). Where the items are fewer than
//    the resident blocks (8 at 32768 levels) and no workspace is needed,
//    several blocks share an item: each rebuilds the plane and takes every
//    parts-th job.
//
// Exactness: every integer sum is accumulated in 64 bits and stored in the
// dtype the JAX package returns (f32 fields hold integers < 2^24).
// dstats[3] is summed in double by warp 0 over the difference histogram, in
// a fixed order, and rounded once to f32.
//
// Entry points (plain C, loaded with ctypes): tpumcia_glcm_stats (up to 4096
// levels) and tpumcia_glcm_stats_workspace (form B1e) launch on the caller's
// stream, allocate nothing, and return cudaGetLastError();
// tpumcia_glcm_launch_info and tpumcia_glcm_workspace_info report the block
// size, dynamic shared memory, resident blocks per SM and (B1e) the grid,
// the blocks per item, the band's levels and the workspace bytes a launch
// of that shape would use.

#include <climits>
#include <cstdint>
#include <cstdlib>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 256;  // the small kernel's static tables
constexpr int kMaxLargeLevels = 4096;
constexpr int kMaxWorkspaceLevels = 32768;  // form B1e; the rescaled levels must stay below the sentinels
constexpr int kPersistentPerSM = 4;  // form B1e: at most this many resident blocks per SM
constexpr int kBandWords = 16384;    // form B1e: the least levels a band holds (64 KB)
constexpr int kBandSlack = 16;       // form B1e: room to align a pass's three rows (band_pass)
constexpr int kMaxPixels = 1 << 24;  // H*W bound: f32-exact counts
constexpr int kMaxOffsets = 16;
constexpr int kThreads = 256;      // table layouts: several blocks per SM
constexpr int kBandThreads = 512;  // the band layout holds the whole SM
// the shared plane's sentinels (levels are < 32768)
constexpr unsigned short kMasked = 0xFFFF;
constexpr unsigned short kOutOfRange = 0xFFFE;  // counts as level 0 in a pair

struct Offsets {
  int n;
  int dr[kMaxOffsets];
  int dc[kMaxOffsets];
};

// Output pointers. The per-offset fields are offset-major: field[o][item][k].
struct Outputs {
  float* hist;    // (items, L)
  float* count;   // (items)
  int* vmax;      // (items)
  float* marg_l;  // (O, items, L)
  float* marg_r;  // (O, items, L)
  float* dout;    // (O, items, 2L-1) difference histogram, or (O, items, 4) dstats
  int* sumsq;     // (O, items, 4)
  float* pairs;   // (O, items)
};

// How a launch lays out G and the plane (chosen by plan() below).
struct Layout {
  int cheap;       // the cheap sum(G^2) encoding (small kernel only)
  int table_bits;  // log2 of the pair table's slots; 0: dense G (small) or bands (large)
  int band_words;  // bands: the u32 cells of one band (B1e: of one level band, slack included)
  int plane;       // the block's levels live in shared memory
  int vec;         // 16-byte pixel loads (H*W % 4 == 0, aligned planes)
  int table_global;  // form B1e: the pair table lives in the workspace slice
};

// The shared scalars of a block.
struct BlockScalars {
  int vmax;
  int count;
  int pairs;
};

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Every helper below that loops over a block's threads takes the block size
// as kBlock: with a constant stride the compiler unrolls the loops and
// keeps several loads in flight (with blockDim.x as the stride the
// 1200x3x256x256 band launch took 2.81 ms against 2.27).
template <int kBlock>
__device__ __forceinline__ void zero_words(unsigned* p, int n) {
  uint4* p4 = reinterpret_cast<uint4*>(p);  // p is 16-byte aligned
  for (int k = threadIdx.x; k < (n >> 2); k += kBlock) p4[k] = make_uint4(0u, 0u, 0u, 0u);
  for (int k = (n & ~3) + threadIdx.x; k < n; k += kBlock) p[k] = 0u;
}

// This block's pixels and mask plane (nullptr when maskless).
template <bool kMask>
__device__ __forceinline__ void item_planes(
    const int* img, const unsigned char* mask, int mask_channels,
    int channels, long long item, int HW, const int** px,
    const unsigned char** mk) {
  *px = img + item * HW;
  *mk = nullptr;
  if (kMask) {
    const long long b = item / channels;
    const long long c = mask_channels == 1 ? 0 : item % channels;
    *mk = mask + (b * mask_channels + c) * HW;
  }
}

// Entry v of the rescale row of a channel whose max raw level is m, 0 < m <=
// top = L - 1, given b = m / top: the reference's trunc(((v/top) / (m/top))
// * top) clipped to [0, top], in double and in the order
// tpumcia_torch.features.stats.rescale_lut computes its table, so the entry
// equals the table's. Every step is one correctly rounded IEEE operation
// (the intrinsics say so to the reader; there is no add, so nothing could
// contract into an FMA).
__device__ __forceinline__ int rescale_level(int v, double b, double top) {
  const double a = __ddiv_rn(static_cast<double>(v), top);
  const double s = __dmul_rn(__ddiv_rn(a, b), top);
  return static_cast<int>(fmin(fmax(s, 0.0), top));
}

// visit(p, v, in) for each pixel p of the block's plane: its raw level v and
// whether it is masked in; 16-byte loads with vec (H*W % 4 == 0, aligned).
template <bool kMask, int kBlock, typename Visit>
__device__ __forceinline__ void for_each_pixel(const int* px, const unsigned char* mk, int HW,
                                               bool vec, Visit visit) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int p4 = tid; p4 < (HW >> 2); p4 += kBlock) {
      const int4 v = reinterpret_cast<const int4*>(px)[p4];
      const unsigned m = kMask ? reinterpret_cast<const unsigned*>(mk)[p4] : 0xFFFFFFFFu;
      visit(4 * p4, v.x, (m & 0xFFu) != 0);
      visit(4 * p4 + 1, v.y, (m & 0xFF00u) != 0);
      visit(4 * p4 + 2, v.z, (m & 0xFF0000u) != 0);
      visit(4 * p4 + 3, v.w, (m & 0xFF000000u) != 0);
    }
  } else {
    for (int p = tid; p < HW; p += kBlock) visit(p, px[p], !kMask || mk[p] != 0);
  }
}

// The block's channel max and pixel count into s (followed by a block
// barrier): vmax takes -1 for every masked-out pixel, as the JAX package's
// max(where(mask, x, -1)) does.
__device__ __forceinline__ void reduce_max_count(int local_max, int local_count, BlockScalars* s) {
  for (int o = 16; o > 0; o >>= 1) {
    local_max = max(local_max, __shfl_down_sync(0xffffffffu, local_max, o));
  }
  local_count = warp_sum(local_count);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&s->vmax, local_max);
    atomicAdd(&s->count, local_count);
  }
  __syncthreads();
}

// Pass 1 of the kernels up to 4096 levels: the raw histogram, pixel count
// and channel max over the (masked) pixels; then the rescale row
// lut[clamp(vmax)] into s_row and hist, count and vmax out. A level outside
// [0, L) breaks the caller's contract; it is dropped from the histogram (as
// a one-hot drops it) and rescales to 0, so that no shared-memory index
// leaves its table. With s_lv, the pass also leaves the block's rescaled
// levels there (kMasked for a masked-out pixel).
template <bool kMask, int kBlock>
__device__ void histogram_pass(const int* px, const unsigned char* mk,
                               int HW, int L, const int* lut, long long item,
                               bool vec, int* s_hist, int* s_row,
                               unsigned short* s_lv, BlockScalars* s,
                               const Outputs& out) {
  const int tid = threadIdx.x, nt = kBlock;
  for (int k = tid; k < L; k += nt) s_hist[k] = 0;
  if (tid == 0) {
    s->vmax = INT_MIN;
    s->count = 0;
  }
  __syncthreads();
  int local_max = INT_MIN;
  int local_count = 0;
  for_each_pixel<kMask, kBlock>(px, mk, HW, vec, [&](int p, int v, bool in) {
    const bool counted = in && static_cast<unsigned>(v) < static_cast<unsigned>(L);
    local_max = max(local_max, in ? v : -1);
    if (counted) {
      ++local_count;
      atomicAdd(&s_hist[v], 1);
    }
    if (s_lv != nullptr) {
      s_lv[p] = !in ? kMasked : counted ? static_cast<unsigned short>(v) : kOutOfRange;
    }
  });
  reduce_max_count(local_max, local_count, s);
  const int vmax = s->vmax;
  const int m = min(max(vmax, 0), L - 1);
  const int* row = lut + static_cast<long long>(m) * L;
  for (int k = tid; k < L; k += nt) {
    s_row[k] = row[k];
    out.hist[item * L + k] = static_cast<float>(s_hist[k]);
  }
  if (tid == 0) {
    // masked: the pixels the histogram holds (the JAX kernel's sum(hist));
    // maskless: every pixel
    out.count[item] = static_cast<float>(kMask ? s->count : HW);
    out.vmax[item] = vmax;
  }
  __syncthreads();
  if (s_lv != nullptr) {
    for (int p = tid; p < HW; p += nt) {
      const unsigned short v = s_lv[p];
      if (v != kMasked) s_lv[p] = v == kOutOfRange ? 0 : static_cast<unsigned short>(s_row[v]);
    }
    __syncthreads();
  }
}

// The pair window of offset (dr, dc) in 2-D indices (no flat shift, so
// nothing wraps across a row end): pair q's left pixel is (r0 + q / wn,
// c0 + q % wn).
struct Window {
  int r0, c0, wn, n_pairs, step;  // step: flat index of the right pixel - left
  float inv_wn;                   // 1 / wn, for q / wn without a division
  __device__ Window(int H, int W, int dr, int dc) {
    r0 = max(0, -dr);
    c0 = max(0, -dc);
    wn = W - max(0, dc) - c0;
    n_pairs = (H - max(0, dr) - r0) * wn;
    step = dr * W + dc;
    inv_wn = 1.0f / static_cast<float>(wn);
  }
};

// Where a pair walk reads its levels: the block's rescaled plane in shared
// memory, or (plane == nullptr) the pixels, the mask and the rescale row.
struct PairSource {
  const unsigned short* plane;
  const int* px;
  const unsigned char* mk;
  const int* s_row;
  int L, W;
};

// Pair q's rescaled levels (i, j); false when masked and either end is out.
template <bool kMask>
__device__ __forceinline__ bool pair_levels(const PairSource& src, const Window& w,
                                            int q, int* i, int* j) {
  // q < 2^24 is exact in f32, so the product is q / wn to within one
  int rr = static_cast<int>(static_cast<float>(q) * w.inv_wn);
  rr += (q - rr * w.wn >= w.wn) - (q - rr * w.wn < 0);
  const int pl = (w.r0 + rr) * src.W + w.c0 + (q - rr * w.wn);
  const int pr = pl + w.step;
  if (src.plane != nullptr) {
    const int a = src.plane[pl], b = src.plane[pr];
    if (kMask && (a == kMasked || b == kMasked)) return false;
    *i = a;
    *j = b;
    return true;
  }
  if (kMask && (src.mk[pl] == 0 || src.mk[pr] == 0)) return false;
  const int vl = src.px[pl];
  const int vr = src.px[pr];
  const unsigned L = static_cast<unsigned>(src.L);
  *i = static_cast<unsigned>(vl) < L ? src.s_row[vl] : 0;
  *j = static_cast<unsigned>(vr) < L ? src.s_row[vr] : 0;
  return true;
}

// op(i, j) for every admitted pair of the window (masked: both ends
// masked), and the marginals and difference histogram of those pairs.
// Returns this thread's admitted pairs.
template <bool kMask, int kBlock, typename Op>
__device__ __forceinline__ int walk_pairs(const PairSource& src, const Window& w, int* s_ml,
                                          int* s_mr, int* s_dh, Op op) {
  int local_pairs = 0;
  for (int q = threadIdx.x; q < w.n_pairs; q += kBlock) {
    int i, j;
    if (!pair_levels<kMask>(src, w, q, &i, &j)) continue;
    ++local_pairs;
    atomicAdd(&s_ml[i], 1);
    atomicAdd(&s_mr[j], 1);
    atomicAdd(&s_dh[i - j + src.L - 1], 1);
    op(i, j);
  }
  return local_pairs;
}

// The generic sum(G^2) limbs of one cell: g = a*2^12 + b ->
// [a^2, a*b, b^2 >> 8, b^2 & 255], as tpumcia.features.stats encodes them.
// g < 2^24, so every limb is below 2^24.
__device__ __forceinline__ void cell_limbs(int g, int l[4]) {
  const int a = g >> 12, b = g & 4095, bb = b * b;
  l[0] = a * a;
  l[1] = a * b;
  l[2] = bb >> 8;
  l[3] = bb & 255;
}

// Add a cell's limbs (the band scan).
__device__ __forceinline__ void add_limbs(int g, long long acc[4]) {
  int l[4];
  cell_limbs(g, l);
#pragma unroll
  for (int m = 0; m < 4; ++m) acc[m] += l[m];
}

// A cell went from old to old + 1: add the change of its limbs (cheap: of
// g^2, kept whole in acc[3]).
__device__ __forceinline__ void add_delta(unsigned old, bool cheap, long long acc[4]) {
  if (cheap) {
    acc[3] += 2 * static_cast<long long>(old) + 1;
    return;
  }
  int hi[4], lo[4];
  cell_limbs(static_cast<int>(old) + 1, hi);
  cell_limbs(static_cast<int>(old), lo);
#pragma unroll
  for (int m = 0; m < 4; ++m) acc[m] += hi[m] - lo[m];
}

__device__ __forceinline__ unsigned slot_of(unsigned key, int bits) {
  return (key * 0x9E3779B1u) >> (32 - bits);
}

// Count one more pair of key in the open-addressing table of 2^bits slots
// (key in the high half of a slot, count in the low kShift bits; the zero
// word is empty). Returns the key's count before the add.
template <typename Slot, int kShift>
__device__ __forceinline__ unsigned table_add(Slot* t, int bits, unsigned key) {
  const unsigned wrap = (1u << bits) - 1u;
  const Slot claim = (static_cast<Slot>(key) << kShift) | 1u;
  for (unsigned h = slot_of(key, bits);; h = (h + 1u) & wrap) {
    const Slot w = atomicCAS(&t[h], static_cast<Slot>(0), claim);
    if (w == 0) return 0u;
    if (static_cast<unsigned>(w >> kShift) == key) {
      return static_cast<unsigned>(atomicAdd(&t[h], static_cast<Slot>(1)) &
                                   ((static_cast<Slot>(1) << kShift) - 1));
    }
  }
}

// Count one more pair in cell k of the dense u16 G (two cells per u32 word;
// every count stays below 2^16, so nothing carries into the other half).
__device__ __forceinline__ unsigned dense_add(unsigned* g, unsigned k) {
  const unsigned sh = 16u * (k & 1u);
  return (atomicAdd(&g[k >> 1], 1u << sh) >> sh) & 0xFFFFu;
}

// Each warp's partial limb sums into s_red (followed by a block barrier).
__device__ __forceinline__ void reduce_limbs(long long acc[4],
                                             long long (*s_red)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) acc[m] = warp_sum(acc[m]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) s_red[threadIdx.x >> 5][m] = acc[m];
  }
  __syncthreads();
}

template <int kBlock>
__device__ __forceinline__ void sum_warps(long long (*s_red)[4], long long sq4[4]) {
  for (int m = 0; m < 4; ++m) sq4[m] = 0;
  for (int w = 0; w < kBlock / 32; ++w) {
#pragma unroll
    for (int m = 0; m < 4; ++m) sq4[m] += s_red[w][m];
  }
}

template <bool kMask, bool kNeedDiff>
__global__ void __launch_bounds__(kThreads, 4) glcm_stats_kernel(
    const int* __restrict__ img, const unsigned char* __restrict__ mask,
    int mask_channels, int channels, const int* __restrict__ lut, int H,
    int W, int L, Offsets offs, Layout lay, Outputs out) {
  // G (pair table slots, or dense words), then the plane when it is kept
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_hist[kMaxLevels];
  __shared__ int s_ml[kMaxLevels];
  __shared__ int s_mr[kMaxLevels];
  __shared__ int s_dh[2 * kMaxLevels - 1];  // signed difference histogram
  __shared__ int s_row[kMaxLevels];         // rescale row lut[clamp(vmax)]
  __shared__ BlockScalars s;
  __shared__ long long s_red[kThreads / 32][4];

  const long long item = blockIdx.x;  // b * channels + c
  const long long items = gridDim.x;
  const int tid = threadIdx.x, nt = kThreads;
  const int HW = H * W;
  const int* px;
  const unsigned char* mk;
  item_planes<kMask>(img, mask, mask_channels, channels, item, HW, &px, &mk);
  const int n_diff = 2 * L - 1;
  const int bits = lay.table_bits;
  const bool cheap = lay.cheap != 0;
  unsigned* g = reinterpret_cast<unsigned*>(smem);
  const int g_words = bits ? 1 << bits : (L * L + 1) / 2;
  unsigned short* s_lv = lay.plane ? reinterpret_cast<unsigned short*>(g + g_words) : nullptr;

  histogram_pass<kMask, kThreads>(px, mk, HW, L, lut, item, lay.vec, s_hist, s_row, s_lv, &s, out);
  const PairSource src{s_lv, px, mk, s_row, L, W};

  for (int o = 0; o < offs.n; ++o) {
    const Window win(H, W, offs.dr[o], offs.dc[o]);
    const long long oi = o * items + item;  // row of this offset's outputs

    // the previous offset's emission reads these tables: every thread is
    // past it (the __syncthreads at the end of the loop) before they reset
    zero_words<kThreads>(g, g_words);
    for (int k = tid; k < L; k += nt) {
      s_ml[k] = 0;
      s_mr[k] = 0;
    }
    for (int k = tid; k < n_diff; k += nt) s_dh[k] = 0;
    if (tid == 0) s.pairs = 0;
    __syncthreads();

    // every pair of the offset window; masked, only pairs whose both ends
    // are masked. sum(G^2) from the counts the G atomics return
    long long acc[4] = {0, 0, 0, 0};
    int local_pairs = walk_pairs<kMask, kThreads>(src, win, s_ml, s_mr, s_dh, [&](int i, int j) {
      const unsigned k = static_cast<unsigned>(i * L + j);
      add_delta(bits ? table_add<unsigned, 16>(g, bits, k) : dense_add(g, k), cheap, acc);
    });
    local_pairs = warp_sum(local_pairs);
    if ((tid & 31) == 0) atomicAdd(&s.pairs, local_pairs);
    __syncthreads();

    for (int k = tid; k < L; k += nt) {
      out.marg_l[oi * L + k] = static_cast<float>(s_ml[k]);
      out.marg_r[oi * L + k] = static_cast<float>(s_mr[k]);
    }
    if (kNeedDiff) {
      for (int k = tid; k < n_diff; k += nt) {
        out.dout[oi * n_diff + k] = static_cast<float>(s_dh[k]);
      }
    }
    // sum(G^2) limbs, same encodings as tpumcia.features.stats:
    //  cheap (H*W <= 4096 and L <= 256): s2 = sum g^2 -> [0, 0, s2>>8, s2&255]
    //  generic: g = a*2^12 + b -> [sum a^2, sum a*b, sum (b^2>>8), sum (b^2&255)]
    reduce_limbs(acc, s_red);

    if (tid < 32) {
      // difference reductions over the (2L-1)-bin histogram, on warp 0
      long long t_d2 = 0, t_hi = 0, t_lo = 0, t_abs = 0;
      double homog = 0.0;
      if (!kNeedDiff) {
        for (int k = tid; k < n_diff; k += 32) {
          const long long n = s_dh[k];
          const long long d = k - (L - 1);
          const long long d2 = d * d;
          t_d2 += n * d2;
          t_hi += n * (d2 >> 8);
          t_lo += n * (d2 & 255);
          t_abs += n * (d < 0 ? -d : d);
          homog += static_cast<double>(n) / (1.0 + static_cast<double>(d2));
        }
        t_d2 = warp_sum(t_d2);
        t_hi = warp_sum(t_hi);
        t_lo = warp_sum(t_lo);
        t_abs = warp_sum(t_abs);
        homog = warp_sum(homog);
      }
      if (tid == 0) {
        long long sq4[4];
        sum_warps<kThreads>(s_red, sq4);
        int* sq = out.sumsq + oi * 4;
        if (cheap) {
          sq[0] = 0;
          sq[1] = 0;
          sq[2] = static_cast<int>(sq4[3] >> 8);
          sq[3] = static_cast<int>(sq4[3] & 255);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m) sq[m] = static_cast<int>(sq4[m]);
        }
        if (!kNeedDiff) {
          float* ds = out.dout + oi * 4;
          if (cheap) {
            ds[0] = static_cast<float>(t_d2 >> 8);
            ds[1] = static_cast<float>(t_d2 & 255);
          } else {
            ds[0] = static_cast<float>(t_hi);
            ds[1] = static_cast<float>(t_lo);
          }
          ds[2] = static_cast<float>(t_abs);
          ds[3] = static_cast<float>(homog);
        }
        // masked: the admitted pairs, = sum(G); maskless: the whole window
        out.pairs[oi] = static_cast<float>(kMask ? s.pairs : win.n_pairs);
      }
    }
    __syncthreads();
  }
}

// rank[k] = the number of k' < k with counts[k'] > 0 where counts[k] > 0,
// else -1, for k < L; returns the number of k with counts[k] > 0. A block
// scan: each thread counts a contiguous run of levels, warps scan the
// counts with shuffles, warp 0 scans the warps' totals.
template <int kBlock>
__device__ int block_rank(const int* counts, int* rank, int L, int* s_scan) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = kBlock, warps = nt >> 5;
  const int per = (L + nt - 1) / nt;
  const int beg = min(L, tid * per), end = min(L, beg + per);
  int n = 0;
  for (int k = beg; k < end; ++k) n += counts[k] > 0;
  int x = n;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < warps ? s_scan[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < warps) s_scan[lane] = v;
  }
  __syncthreads();
  int next = x - n + (warp > 0 ? s_scan[warp - 1] : 0);
  for (int k = beg; k < end; ++k) rank[k] = counts[k] > 0 ? next++ : -1;
  const int total = s_scan[warps - 1];
  __syncthreads();  // s_scan is reused by the next call
  return total;
}

// Form B1d (see the header): the u64 pair table, or u32 G in bands over the
// occupied levels; the difference histogram always, generic limbs.
template <bool kMask, int kBlock>
__global__ void __launch_bounds__(kBlock) glcm_stats_large_kernel(
    const int* __restrict__ img, const unsigned char* __restrict__ mask,
    int mask_channels, int channels, const int* __restrict__ lut, int H,
    int W, int L, Offsets offs, Layout lay, Outputs out) {
  // G (u64 table slots, or one band of u32 cells), the 6L-1 int tables (and
  // the right-level ranks for bands), then the plane when it is kept
  extern __shared__ __align__(16) unsigned char smem[];
  const int bits = lay.table_bits;
  unsigned long long* table = reinterpret_cast<unsigned long long*>(smem);
  unsigned* s_band = reinterpret_cast<unsigned*>(smem);
  int* s_hist = reinterpret_cast<int*>(
      smem + (bits ? (8LL << bits) : 4LL * lay.band_words));  // after pass 1, the left-level ranks
  int* s_row = s_hist + L;     // L: rescale row lut[clamp(vmax)]
  int* s_ml = s_row + L;       // L
  int* s_mr = s_ml + L;        // L
  int* s_dh = s_mr + L;        // 2L-1: signed difference histogram
  int* s_rank_r = s_dh + 2 * L - 1;  // L, bands only: the right-level ranks
  int* s_rank_l = s_hist;
  unsigned short* s_lv = lay.plane ? reinterpret_cast<unsigned short*>(s_rank_r) : nullptr;
  __shared__ BlockScalars s;
  __shared__ int s_scan[kBlock / 32];
  __shared__ long long s_red[kBlock / 32][4];

  const long long item = blockIdx.x;  // b * channels + c
  const long long items = gridDim.x;
  const int tid = threadIdx.x, nt = kBlock;
  const int HW = H * W;
  const int* px;
  const unsigned char* mk;
  item_planes<kMask>(img, mask, mask_channels, channels, item, HW, &px, &mk);
  const int n_diff = 2 * L - 1;

  histogram_pass<kMask, kBlock>(px, mk, HW, L, lut, item, lay.vec, s_hist, s_row, s_lv, &s, out);
  const PairSource src{s_lv, px, mk, s_row, L, W};

  for (int o = 0; o < offs.n; ++o) {
    const Window win(H, W, offs.dr[o], offs.dc[o]);
    const long long oi = o * items + item;  // row of this offset's outputs

    if (bits) zero_words<kBlock>(reinterpret_cast<unsigned*>(table), 2 << bits);
    for (int k = tid; k < L; k += nt) {
      s_ml[k] = 0;
      s_mr[k] = 0;
    }
    for (int k = tid; k < n_diff; k += nt) s_dh[k] = 0;
    if (tid == 0) s.pairs = 0;
    __syncthreads();

    // the marginals, the difference histogram, the pair count and, with
    // the table, sum(G^2) from the counts its atomics return
    long long acc[4] = {0, 0, 0, 0};
    int local_pairs = walk_pairs<kMask, kBlock>(src, win, s_ml, s_mr, s_dh, [&](int i, int j) {
      if (bits) {
        const unsigned k = static_cast<unsigned>(i * L + j);
        add_delta(table_add<unsigned long long, 32>(table, bits, k), false, acc);
      }
    });
    local_pairs = warp_sum(local_pairs);
    if ((tid & 31) == 0) atomicAdd(&s.pairs, local_pairs);
    __syncthreads();
    for (int k = tid; k < L; k += nt) {
      out.marg_l[oi * L + k] = static_cast<float>(s_ml[k]);
      out.marg_r[oi * L + k] = static_cast<float>(s_mr[k]);
    }
    for (int k = tid; k < n_diff; k += nt) {
      out.dout[oi * n_diff + k] = static_cast<float>(s_dh[k]);
    }

    if (!bits) {
      // G over the occupied levels, R occupied rows at a time
      const int occ_l = block_rank<kBlock>(s_ml, s_rank_l, L, s_scan);
      const int occ_r = block_rank<kBlock>(s_mr, s_rank_r, L, s_scan);
      const int rows = occ_r > 0 ? lay.band_words / occ_r : 1;
      for (int lo = 0; lo < occ_l; lo += rows) {
        const int n_rows = min(rows, occ_l - lo);
        zero_words<kBlock>(s_band, n_rows * occ_r);
        __syncthreads();
        for (int q = tid; q < win.n_pairs; q += nt) {
          int i, j;
          if (!pair_levels<kMask>(src, win, q, &i, &j)) continue;
          const int band_row = s_rank_l[i] - lo;
          if (static_cast<unsigned>(band_row) < static_cast<unsigned>(n_rows)) {
            atomicAdd(&s_band[band_row * occ_r + s_rank_r[j]], 1u);
          }
        }
        __syncthreads();
        for (int k = tid; k < n_rows * occ_r; k += nt) add_limbs(s_band[k], acc);
        __syncthreads();  // the next band zeroes these cells
      }
    }
    reduce_limbs(acc, s_red);
    if (tid == 0) {
      long long sq4[4];
      sum_warps<kBlock>(s_red, sq4);
#pragma unroll
      for (int m = 0; m < 4; ++m) out.sumsq[oi * 4 + m] = static_cast<int>(sq4[m]);
      out.pairs[oi] = static_cast<float>(kMask ? s.pairs : win.n_pairs);
    }
    __syncthreads();
  }
}


// Form B1e's pair walks: op(i, j) for every admitted pair of the window.
template <bool kMask, int kBlock, typename Op>
__device__ __forceinline__ void for_each_pair(const PairSource& src, const Window& w, Op op) {
  for (int q = threadIdx.x; q < w.n_pairs; q += kBlock) {
    int i, j;
    if (pair_levels<kMask>(src, w, q, &i, &j)) op(i, j);
  }
}

// One pass of form B1e's level bands over kRows output rows laid end to end
// (row t: len[t] floats at rows[t]); pass p takes the levels [p*capacity,
// (p + 1)*capacity) of their concatenation. Row t's share, its levels
// [lo[t], lo[t] + n[t]), is counted in band words start[t] + (level -
// lo[t]) and emitted to dst[t] = rows[t] + lo[t]. start[t] is congruent to
// dst[t]'s address mod 16 bytes, so both sides of the emission's body are
// 16-byte aligned; that costs at most 15 words of the band's kBandSlack.
template <int kRows>
struct BandPass {
  float* dst[kRows];
  int lo[kRows], n[kRows], start[kRows];
  int end;  // the band words the pass uses
};

template <int kRows>
__device__ __forceinline__ BandPass<kRows> band_pass(float* const (&rows)[kRows],
                                                     const int (&len)[kRows], int capacity, int p) {
  BandPass<kRows> b;
  const int v0 = p * capacity;
  int base = 0, pos = 0;
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    b.lo[t] = min(max(v0 - base, 0), len[t]);
    b.n[t] = min(max(v0 + capacity - base, 0), len[t]) - b.lo[t];
    b.dst[t] = rows[t] + b.lo[t];
    const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(b.dst[t]) >> 2) & 3);
    b.start[t] = ((pos + 3) & ~3) + phase;
    if (b.n[t] > 0) pos = b.start[t] + b.n[t];
    base += len[t];
  }
  b.end = pos;
  return b;
}

// Count one more of each row's key that falls in the pass.
template <int kRows>
__device__ __forceinline__ void band_count(int* band, const BandPass<kRows>& b,
                                           const int (&key)[kRows]) {
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int k = key[t] - b.lo[t];
    if (static_cast<unsigned>(k) < static_cast<unsigned>(b.n[t])) atomicAdd(&band[b.start[t] + k], 1);
  }
}

// n band counts from src to dst as f32, each word written once with a
// streaming store: scalar up to dst's first 16-byte boundary and after its
// last, 16 bytes a thread between (src is congruent to dst mod 16 bytes).
template <int kBlock>
__device__ __forceinline__ void emit_band(float* dst, const int* src, int n) {
  const int tid = threadIdx.x;
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  const int head = min(n, (4 - phase) & 3);
  const int body = (n - head) >> 2;
  const int tail = head + 4 * body;
  if (tid < head) __stcs(dst + tid, static_cast<float>(src[tid]));
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int k = tid; k < body; k += kBlock) {
    const int4 v = s4[k];
    __stcs(d4 + k, make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                               static_cast<float>(v.z), static_cast<float>(v.w)));
  }
  if (tid < n - tail) __stcs(dst + tail + tid, static_cast<float>(src[tail + tid]));
}

// The block's plane into lv as u16 raw levels (kMasked for a masked-out
// pixel; kOutOfRange for a level outside [0, L), which breaks the caller's
// contract: no histogram counts it, and it rescales to 0), and its channel
// max and pixel count into s.
template <bool kMask, int kBlock>
__device__ void load_plane(const int* px, const unsigned char* mk, int HW, int L, bool vec,
                           unsigned short* lv, BlockScalars* s) {
  if (threadIdx.x == 0) {
    s->vmax = INT_MIN;
    s->count = 0;
  }
  __syncthreads();
  int local_max = INT_MIN;
  int local_count = 0;
  for_each_pixel<kMask, kBlock>(px, mk, HW, vec, [&](int p, int v, bool in) {
    const bool counted = in && static_cast<unsigned>(v) < static_cast<unsigned>(L);
    local_max = max(local_max, in ? v : -1);
    local_count += counted;
    lv[p] = !in ? kMasked : counted ? static_cast<unsigned short>(v) : kOutOfRange;
  });
  reduce_max_count(local_max, local_count, s);
}

// The plane's raw levels rescaled in place: entry lut[clamp(vmax)][v] of the
// reference's table, computed per pixel (row 0 is all zeros).
template <int kBlock>
__device__ void rescale_plane(unsigned short* lv, int HW, int L, int vmax) {
  const int m = min(max(vmax, 0), L - 1);
  const double top = static_cast<double>(L - 1);
  const double b = __ddiv_rn(static_cast<double>(m), top);
  for (int p = threadIdx.x; p < HW; p += kBlock) {
    const unsigned short v = lv[p];
    if (v != kMasked) {
      lv[p] = v == kOutOfRange || m == 0 ? 0 : static_cast<unsigned short>(rescale_level(v, b, top));
    }
  }
  __syncthreads();
}

// Form B1e (see the header): past 4096 levels. A unit is one (item, part),
// item = unit / parts; block b takes units b, b + gridDim.x, ... Each part
// takes the jobs part, part + parts, ... of its item: the histogram passes,
// then per offset G's walk and the band passes. Dynamic shared memory: the
// band (lay.band_words ints; the pair table too, unless that lives in the
// workspace), then the plane unless that lives there. A block's workspace
// slice holds the table, then the plane, where they live there. kShared:
// both in shared memory (the compiler then knows every pointer's space;
// generic pointers took 1 % longer at 2048x12x48x48, 7 % at 8x1x64x64 and
// 32768 levels).
template <bool kMask, bool kShared>
__global__ void __launch_bounds__(kThreads, 3) glcm_stats_level_bands_kernel(
    const int* __restrict__ img, const unsigned char* __restrict__ mask, int mask_channels,
    int channels, unsigned char* __restrict__ workspace, long long slice_bytes, long long items,
    int parts, int H, int W, int L, Offsets offs, Layout lay, Outputs out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bits = lay.table_bits;
  unsigned char* ws = workspace + blockIdx.x * slice_bytes;
  int* band = reinterpret_cast<int*>(smem);
  unsigned long long* table =
      reinterpret_cast<unsigned long long*>(kShared || !lay.table_global ? smem : ws);
  unsigned short* lv = reinterpret_cast<unsigned short*>(
      kShared || lay.plane ? smem + 4LL * lay.band_words
                           : ws + (lay.table_global ? 8LL << bits : 0LL));
  __shared__ BlockScalars s;
  __shared__ long long s_red[kThreads / 32][4];

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int n_diff = 2 * L - 1;
  const int capacity = lay.band_words - kBandSlack;
  const int hist_passes = (L + capacity - 1) / capacity;
  const int per_offset = 1 + (4 * L - 1 + capacity - 1) / capacity;  // G's walk, then the bands
  const int jobs = hist_passes + offs.n * per_offset;
  const PairSource src{lv, nullptr, nullptr, nullptr, L, W};
  for (long long unit = blockIdx.x; unit < items * parts; unit += gridDim.x) {
    const long long item = unit / parts;
    const int part = static_cast<int>(unit % parts);
    const int* px;
    const unsigned char* mk;
    item_planes<kMask>(img, mask, mask_channels, channels, item, HW, &px, &mk);
    load_plane<kMask, kThreads>(px, mk, HW, L, lay.vec, lv, &s);
    const int vmax = s.vmax;
    if (part == 0 && tid == 0) {
      // masked: the pixels the histogram holds; maskless: every pixel
      out.count[item] = static_cast<float>(kMask ? s.count : HW);
      out.vmax[item] = vmax;
    }
    bool rescaled = false;
    for (int job = part; job < jobs; job += parts) {
      if (job < hist_passes) {
        // a band of the raw-level histogram (the sentinels lie past every band)
        float* const rows[1] = {out.hist + item * L};
        const int len[1] = {L};
        const BandPass<1> b = band_pass(rows, len, capacity, job);
        zero_words<kThreads>(reinterpret_cast<unsigned*>(band), b.end);
        __syncthreads();
        for (int p = tid; p < HW; p += kThreads) {
          const int key[1] = {lv[p]};
          band_count(band, b, key);
        }
        __syncthreads();
        emit_band<kThreads>(b.dst[0], band + b.start[0], b.n[0]);
        __syncthreads();  // the next job resets the band
        continue;
      }
      if (!rescaled) {
        rescale_plane<kThreads>(lv, HW, L, vmax);
        rescaled = true;
      }
      const int o = (job - hist_passes) / per_offset;
      const int pass = (job - hist_passes) % per_offset - 1;  // -1: G's walk
      const Window win(H, W, offs.dr[o], offs.dc[o]);
      const long long oi = o * items + item;  // row of this offset's outputs
      if (pass < 0) {
        // sum(G^2) from the counts the pair table's atomics return; the pair count
        zero_words<kThreads>(reinterpret_cast<unsigned*>(table), 2 << bits);
        if (tid == 0) s.pairs = 0;
        __syncthreads();
        long long acc[4] = {0, 0, 0, 0};
        int local_pairs = 0;
        for_each_pair<kMask, kThreads>(src, win, [&](int i, int j) {
          ++local_pairs;
          const unsigned k = static_cast<unsigned>(i * L + j);  // < 2^30
          add_delta(table_add<unsigned long long, 32>(table, bits, k), false, acc);
        });
        local_pairs = warp_sum(local_pairs);
        if ((tid & 31) == 0) atomicAdd(&s.pairs, local_pairs);
        reduce_limbs(acc, s_red);
        if (tid == 0) {
          long long sq4[4];
          sum_warps<kThreads>(s_red, sq4);
#pragma unroll
          for (int m = 0; m < 4; ++m) out.sumsq[oi * 4 + m] = static_cast<int>(sq4[m]);
          out.pairs[oi] = static_cast<float>(kMask ? s.pairs : win.n_pairs);
        }
      } else {
        // a band of both marginals and the difference histogram, end to end
        float* const rows[3] = {out.marg_l + oi * L, out.marg_r + oi * L, out.dout + oi * n_diff};
        const int len[3] = {L, L, n_diff};
        const BandPass<3> b = band_pass(rows, len, capacity, pass);
        zero_words<kThreads>(reinterpret_cast<unsigned*>(band), b.end);
        __syncthreads();
        for_each_pair<kMask, kThreads>(src, win, [&](int i, int j) {
          const int key[3] = {i, j, i - j + L - 1};
          band_count(band, b, key);
        });
        __syncthreads();
#pragma unroll
        for (int t = 0; t < 3; ++t) emit_band<kThreads>(b.dst[t], band + b.start[t], b.n[t]);
      }
      __syncthreads();  // the next job resets the band, the table and s.pairs
    }
  }
}

using KernelFn = void (*)(const int*, const unsigned char*, int, int, const int*,
                          int, int, int, Offsets, Layout, Outputs);
using BandsKernelFn = void (*)(const int*, const unsigned char*, int, int, unsigned char*,
                               long long, long long, int, int, int, int, Offsets, Layout, Outputs);

// The twelve instances: small <mask, need_diff>, then large <mask> with the
// table's block size and with the bands', then the level bands <mask,
// shared> of form B1e.
constexpr int kInstances = 12;
constexpr int kBandsInstance = 8;

KernelFn kernel_at(int index) {
  switch (index) {
    case 0: return glcm_stats_kernel<false, false>;
    case 1: return glcm_stats_kernel<false, true>;
    case 2: return glcm_stats_kernel<true, false>;
    case 3: return glcm_stats_kernel<true, true>;
    case 4: return glcm_stats_large_kernel<false, kThreads>;
    case 5: return glcm_stats_large_kernel<true, kThreads>;
    case 6: return glcm_stats_large_kernel<false, kBandThreads>;
    default: return glcm_stats_large_kernel<true, kBandThreads>;
  }
}

// index kBandsInstance + 2 * masked + shared
BandsKernelFn bands_kernel_at(int index) {
  switch (index - kBandsInstance) {
    case 0: return glcm_stats_level_bands_kernel<false, false>;
    case 1: return glcm_stats_level_bands_kernel<false, true>;
    case 2: return glcm_stats_level_bands_kernel<true, false>;
    default: return glcm_stats_level_bands_kernel<true, true>;
  }
}

const void* instance_at(int index) {
  return index < kBandsInstance ? reinterpret_cast<const void*>(kernel_at(index))
                                : reinterpret_cast<const void*>(bands_kernel_at(index));
}

// Per instance, once: the dynamic shared memory a block of it may ask for
// (the device's opt-in less the kernel's static use), raised to that cap,
// and the carveout set to shared memory first, so that several blocks fit.
struct KernelLimits {
  cudaError_t err;
  int smem_max;
};

KernelLimits configure(const void* kernel) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  const int smem_max = err == cudaSuccess ? optin - static_cast<int>(attr.sharedSizeBytes) : 0;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  return {err, smem_max};
}

const KernelLimits& limits(int index) {
  static std::once_flag once[kInstances];
  static KernelLimits lim[kInstances];
  std::call_once(once[index], [index] { lim[index] = configure(instance_at(index)); });
  return lim[index];
}

struct Plan {
  KernelFn kernel;
  int threads;
  int smem;
  Layout lay;
};

// The layout of a launch: G (table or dense / bands), the plane where it
// fits beside G, the block size and the dynamic shared memory. The caller's
// table_bits says only whether the table is smaller than G; this is the one
// place that checks what fits in shared memory: a B1d table that does not
// fit beside the 6L-1 int per-level tables takes the bands.
cudaError_t plan(bool large, bool masked, bool need_diff, int HW, int L,
                 int table_bits, int cheap, Plan* p) {
  if (large && table_bits) {
    const KernelLimits& lim = limits(4 + masked);
    if (lim.err != cudaSuccess) return lim.err;
    if ((8LL << table_bits) + 4LL * (6 * L - 1) > lim.smem_max) table_bits = 0;
  }
  const int index = large ? 4 + masked + (table_bits ? 0 : 2) : 2 * masked + need_diff;
  const KernelLimits& lim = limits(index);
  if (lim.err != cudaSuccess) return lim.err;
  const long long smem_max = lim.smem_max;
  const long long plane = 2LL * HW;
  p->kernel = kernel_at(index);
  p->lay = Layout{large ? 0 : cheap, table_bits, 0, 0, 0};
  p->threads = kThreads;
  long long g, tables = 0;
  if (!large) {
    g = table_bits ? 4LL << table_bits : 4LL * ((static_cast<long long>(L) * L + 1) / 2);
  } else if (table_bits) {
    g = 8LL << table_bits;
    tables = 4LL * (6 * L - 1);
  } else {
    // bands: the whole opt-in (no more than a whole G of L*L cells needs)
    tables = 4LL * (7 * L - 1);
    long long smem = smem_max;
    if (smem > tables + 4LL * L * L) smem = tables + 4LL * L * L;
    const long long band_words = (smem - tables) / 4;
    if (band_words < L) return cudaErrorInvalidValue;  // not one row of G
    p->lay.band_words = static_cast<int>(band_words);
    p->threads = kBandThreads;
    p->smem = static_cast<int>(tables + 4 * band_words);
    return cudaSuccess;
  }
  if (g + tables > smem_max) return cudaErrorInvalidValue;
  p->lay.plane = g + tables + plane <= smem_max;
  p->smem = static_cast<int>(g + tables + (p->lay.plane ? plane : 0));
  return cudaSuccess;
}

bool is_large(long long hw, int L) { return hw >= 65536 || L > kMaxLevels; }

struct BandsPlan {
  BandsKernelFn kernel;
  int smem;
  Layout lay;
  int blocks_per_sm;      // resident blocks per SM the grid counts on
  int parts;              // blocks that share one (image, channel)
  int grid;               // blocks: every one resident at once
  long long slice_bytes;  // workspace bytes per block
};

// The layout of a B1e launch over `items` (image, channel)s and num_offsets
// offsets: the band of at least kBandWords levels in shared memory, sized
// to hold the pair table where that fits; the table in the workspace slice
// where it does not; the plane in shared memory where it fits beside the
// band, else in the slice; the persistent grid, and the parts an item is
// split into where the items are fewer than the resident blocks and no
// slice is needed (at most one part per job).
cudaError_t plan_bands(bool masked, int HW, int L, int table_bits, int num_offsets, long long items,
                       BandsPlan* p) {
  const KernelLimits& lim = limits(kBandsInstance + 2 * masked);
  if (lim.err != cudaSuccess) return lim.err;
  const long long table = 8LL << table_bits, plane = (2LL * HW + 15) & ~15LL;
  const long long least = 4LL * (kBandWords + kBandSlack);
  p->lay = Layout{0, table_bits, 0, 0, 0, 0};
  p->lay.table_global = table + 4LL * kBandSlack > lim.smem_max;
  const long long band = p->lay.table_global || table + 4LL * kBandSlack < least
      ? least : table + 4LL * kBandSlack;
  p->lay.band_words = static_cast<int>(band / 4);
  p->lay.plane = band + plane <= lim.smem_max;
  p->smem = static_cast<int>(band + (p->lay.plane ? plane : 0));
  p->slice_bytes = (p->lay.table_global ? table : 0) + (p->lay.plane ? 0 : plane);
  const int index = kBandsInstance + 2 * masked + (p->slice_bytes == 0);
  p->kernel = bands_kernel_at(index);
  const KernelLimits& run = limits(index);  // raises the instance's own cap
  if (run.err != cudaSuccess) return run.err;
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, reinterpret_cast<const void*>(p->kernel), kThreads, p->smem);
  }
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidValue;
  p->blocks_per_sm = blocks < kPersistentPerSM ? blocks : kPersistentPerSM;
  const long long resident = static_cast<long long>(p->blocks_per_sm) * sms;
  const int capacity = p->lay.band_words - kBandSlack;
  const long long jobs = (L + capacity - 1) / capacity +
                         num_offsets * (1LL + (4LL * L - 1 + capacity - 1) / capacity);
  p->parts = 1;
  if (p->slice_bytes == 0 && items > 0 && items < resident) {
    p->parts = static_cast<int>(resident / items < jobs ? resident / items : jobs);
  }
  const long long units = items * p->parts;
  p->grid = static_cast<int>(units < resident ? (units > 0 ? units : 1) : resident);
  return cudaSuccess;
}

bool workspace_shape_ok(long long hw, int H, int W, int L, int table_bits) {
  return H >= 1 && W >= 1 && hw < kMaxPixels && L > kMaxLargeLevels &&
         L <= kMaxWorkspaceLevels && table_bits >= 1 && table_bits <= 25;
}

}  // namespace

// offsets: 2 * num_offsets host ints, (dr, dc) pairs. mask: nullptr, or
// uint8 (batch, mask_channels, H, W) with mask_channels 1 or channels.
// dout: the difference histogram when need_diff, else dstats. Sizes with
// H*W >= 65536 or L > 256 take the B1d kernel, which needs need_diff and
// cheap == 0, L <= 4096 and H*W < 2^24. table_bits: log2 of the pair
// table's slots (at least 2x the largest offset's pair window), or 0 for
// the dense G (small sizes) or the bands (B1d).
extern "C" int tpumcia_glcm_stats(
    const int* img, const unsigned char* mask, int mask_channels,
    const int* lut, int batch, int channels, int H, int W, int L,
    const int* offsets, int num_offsets, int need_diff, int cheap,
    int table_bits, float* hist, float* count, int* vmax, float* marg_l,
    float* marg_r, float* dout, int* sumsq, float* pairs, void* stream) {
  const long long hw = static_cast<long long>(H) * W;
  const bool large = is_large(hw, L);
  if (L < 1 || H < 1 || W < 1 || batch < 0 || channels < 1 ||
      num_offsets < 1 || num_offsets > kMaxOffsets || table_bits < 0 || table_bits > 24 ||
      (mask != nullptr && mask_channels != 1 && mask_channels != channels) ||
      (large && (!need_diff || cheap || L > kMaxLargeLevels ||
                 hw >= kMaxPixels))) {
    return cudaErrorInvalidValue;
  }
  const long long items = static_cast<long long>(batch) * channels;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  Offsets offs{};
  offs.n = num_offsets;
  for (int o = 0; o < num_offsets; ++o) {
    offs.dr[o] = offsets[2 * o];
    offs.dc[o] = offsets[2 * o + 1];
    // the table must hold every key of the largest window twice over
    const long long n_pairs = static_cast<long long>(H - abs(offs.dr[o])) * (W - abs(offs.dc[o]));
    if (table_bits && (1LL << table_bits) < 2 * n_pairs) return cudaErrorInvalidValue;
  }
  Plan p;
  cudaError_t err = plan(large, mask != nullptr, need_diff != 0, static_cast<int>(hw), L,
                         table_bits, cheap, &p);
  if (err != cudaSuccess) return err;
  p.lay.vec = hw % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
              (mask == nullptr || reinterpret_cast<uintptr_t>(mask) % 4 == 0);
  if (items == 0) return cudaSuccess;
  const Outputs out{hist, count, vmax, marg_l, marg_r, dout, sumsq, pairs};
  p.kernel<<<static_cast<int>(items), p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      img, mask, mask == nullptr ? 1 : mask_channels, channels, lut, H, W, L, offs, p.lay, out);
  return static_cast<int>(cudaGetLastError());
}

// info[0..4] <- threads per block, dynamic shared memory bytes, resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), whether
// the plane is kept in shared memory, and the table_bits the launch uses (0
// where plan() took the dense G or the bands), for a launch of that shape.
extern "C" int tpumcia_glcm_launch_info(int H, int W, int L, int masked, int need_diff,
                                        int table_bits, int* info) {
  const long long hw = static_cast<long long>(H) * W;
  if (L < 1 || H < 1 || W < 1 || hw >= kMaxPixels || table_bits < 0 || table_bits > 24) {
    return cudaErrorInvalidValue;
  }
  Plan p;
  cudaError_t err = plan(is_large(hw, L), masked != 0, need_diff != 0, static_cast<int>(hw), L,
                         table_bits, 0, &p);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, reinterpret_cast<const void*>(p.kernel), p.threads, p.smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = p.threads;
  info[1] = p.smem;
  info[2] = blocks;
  info[3] = p.lay.plane;
  info[4] = p.lay.table_bits;
  return 0;
}

// Form B1e: 4096 < L <= 32768, always the difference histogram in dout and
// the generic limbs; no rescale table. workspace: workspace_bytes of device
// memory, 16-byte aligned, at least what tpumcia_glcm_workspace_info reports
// for this shape, offset count and item count (nullptr where that is 0: the
// pair table and the plane fit in shared memory); its contents before and
// after are meaningless. table_bits: log2 of the pair table's slots, at
// least 2x the largest offset's pair window. The other arguments as
// tpumcia_glcm_stats.
extern "C" int tpumcia_glcm_stats_workspace(
    const int* img, const unsigned char* mask, int mask_channels, int batch,
    int channels, int H, int W, int L, const int* offsets, int num_offsets,
    int table_bits, void* workspace, long long workspace_bytes, float* hist,
    float* count, int* vmax, float* marg_l, float* marg_r, float* dout,
    int* sumsq, float* pairs, void* stream) {
  const long long hw = static_cast<long long>(H) * W;
  if (!workspace_shape_ok(hw, H, W, L, table_bits) || batch < 0 || channels < 1 ||
      num_offsets < 1 || num_offsets > kMaxOffsets ||
      (mask != nullptr && mask_channels != 1 && mask_channels != channels)) {
    return cudaErrorInvalidValue;
  }
  const long long items = static_cast<long long>(batch) * channels;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  Offsets offs{};
  offs.n = num_offsets;
  for (int o = 0; o < num_offsets; ++o) {
    offs.dr[o] = offsets[2 * o];
    offs.dc[o] = offsets[2 * o + 1];
    const long long n_pairs = static_cast<long long>(H - abs(offs.dr[o])) * (W - abs(offs.dc[o]));
    if ((1LL << table_bits) < 2 * n_pairs) return cudaErrorInvalidValue;
  }
  BandsPlan p;
  cudaError_t err = plan_bands(mask != nullptr, static_cast<int>(hw), L, table_bits, num_offsets,
                               items, &p);
  if (err != cudaSuccess) return err;
  if (p.slice_bytes > 0 && (workspace == nullptr || reinterpret_cast<uintptr_t>(workspace) % 16 != 0 ||
                            workspace_bytes < p.slice_bytes * p.grid)) {
    return cudaErrorInvalidValue;
  }
  p.lay.vec = hw % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
              (mask == nullptr || reinterpret_cast<uintptr_t>(mask) % 4 == 0);
  if (items == 0) return cudaSuccess;
  const Outputs out{hist, count, vmax, marg_l, marg_r, dout, sumsq, pairs};
  p.kernel<<<p.grid, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      img, mask, mask == nullptr ? 1 : mask_channels, channels,
      p.slice_bytes > 0 ? static_cast<unsigned char*>(workspace) : nullptr, p.slice_bytes, items,
      p.parts, H, W, L, offs, p.lay, out);
  return static_cast<int>(cudaGetLastError());
}

// info[0..9] <- threads per block, dynamic shared memory bytes, resident
// blocks per SM the grid counts on, whether the plane is kept in shared
// memory, whether the pair table is, the grid's blocks, the workspace bytes
// the launch needs, the bytes of one block's slice, the blocks that share
// one item, and the levels one band pass holds, for a B1e launch of that
// shape over num_offsets offsets and `items` (image, channel)s.
extern "C" int tpumcia_glcm_workspace_info(int H, int W, int L, int masked, int table_bits,
                                           int num_offsets, long long items, long long* info) {
  const long long hw = static_cast<long long>(H) * W;
  if (!workspace_shape_ok(hw, H, W, L, table_bits) || items < 0 || num_offsets < 1 ||
      num_offsets > kMaxOffsets) {
    return cudaErrorInvalidValue;
  }
  BandsPlan p;
  const cudaError_t err = plan_bands(masked != 0, static_cast<int>(hw), L, table_bits, num_offsets,
                                     items, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = kThreads;
  info[1] = p.smem;
  info[2] = p.blocks_per_sm;
  info[3] = p.lay.plane;
  info[4] = !p.lay.table_global;
  info[5] = p.grid;
  info[6] = p.slice_bytes * p.grid;
  info[7] = p.slice_bytes;
  info[8] = p.parts;
  info[9] = p.lay.band_words - kBandSlack;
  return 0;
}

extern "C" const char* tpumcia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
