// GLCM sufficient statistics for one (image, channel) per thread block.
//
// Replaces the TPU kernels of tpumcia/features/pallas_glcm.py in every form
// the single-device extraction runs:
//   _kernel (driven by _pallas_stats_core), maskless or masked (has_mask),
//   emitting dstats (need_diff=False) or the difference histogram
//   (need_diff=True); and _kernel_multi (driven by _pallas_stats_multi_core),
//   the same outputs for up to kMaxOffsets GLCM offsets in one pass; at any
//   image size and level count up to the bounds below.
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
// Small sizes (H*W < 65536 and L <= 256: forms B1a, B1b, B1c, B2) take
// glcm_stats_kernel. What bounds it on an H100: each block reads its
// channel's H*W int32 pixels (and mask bytes) once for the histogram and
// once per offset for the pairs (16 KB at 64x64; the later reads are meant to
// come from L1/L2) and issues five shared-memory atomics per admitted pixel
// pair. G itself is 256 x 256 u16 counts packed two per u32 word, 128 KB of
// dynamic shared memory, which is zeroed and scanned once per offset: at
// 64x64 that is 32,768 words against 4,096 pixel pairs, and the 128 KB holds
// each SM to one resident block. The packing is exact while a cell count
// stays below 2^16, which H*W < 65536 guarantees. Several offsets share the
// histogram pass and the block's launch, and reuse the same 128 KB for each
// offset's G in turn, so shared memory does not grow with the offset count.
//
// Large sizes (form B1d: H*W >= 65536 or L > 256, always with the difference
// histogram, which is what the JAX package's entry asks for there) take
// glcm_stats_large_kernel. There a G cell can pass 65,535 pairs (a constant
// 300x300 channel at offset (0, 1) puts 89,700 in one), so cells are u32,
// and a u32 G outgrows shared memory (256 KB at L = 256, 4 MB at L = 1024,
// against the 227 KB a block may hold). Its design:
//  - every per-level table (histogram, rescale row, both marginals, the
//    (2L-1)-bin difference histogram, two rank tables) is sized from L in
//    dynamic shared memory: 7L-1 ints, 112 KB at L = 4096;
//  - per offset, one walk of the pair window fills the marginals, the
//    difference histogram and the pair count. Then the occupied left and
//    right levels (marginal > 0) are ranked, and G is built over those rows
//    and columns only, in bands of R occupied rows x every occupied column,
//    R = band words / occupied columns, in the shared memory left over
//    (about 50,000 u32 words at L = 1024). Each band re-walks the pair window
//    (the pixels come back from L1/L2), counts only the pairs whose left
//    level falls in it, and is scanned into the four 64-bit limb
//    accumulators. An unoccupied row or column of G is all zeros and adds
//    nothing to sum(G^2), so the limbs are those of the whole G;
//  - passes per offset: ceil(occupied left levels / R). At worst (every
//    level occupied on both sides) that is 2 at L = 256, 21 at L = 1024 and
//    586 at L = 4096; a channel with few distinct levels takes one.
// Its bounds: L <= kMaxLargeLevels = 4096 (the tables and one band row of L
// cells must fit in shared memory) and H*W < 2^24 (counts exact in f32).
// Its limbs are always the generic ones: the cheap gate needs H*W <= 4096
// and L <= 256, which B1d never meets.
//
// Exactness: every integer sum is accumulated in 64 bits and stored in the
// dtype the JAX package returns (f32 fields hold integers < 2^24).
// dstats[3] is summed in double and rounded once to f32.
//
// Entry point: tpumcia_glcm_stats (plain C, loaded with ctypes). It launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 256;  // the small kernel's static tables
constexpr int kMaxLargeLevels = 4096;
constexpr int kMaxPixels = 1 << 24;  // H*W bound: f32-exact counts
constexpr int kMaxOffsets = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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

// Pass 1 of both kernels: the raw histogram, pixel count and channel max
// over the (masked) pixels; then the rescale row lut[clamp(vmax)] into s_row
// and hist, count and vmax out. vmax takes -1 for every masked-out pixel, as
// the JAX package's max(where(mask, x, -1)) does. A level outside [0, L)
// breaks the caller's contract; it is dropped from the histogram (as a
// one-hot drops it) so that no shared-memory index leaves its table.
template <bool kMask>
__device__ void histogram_pass(const int* px, const unsigned char* mk,
                               int HW, int L, const int* lut, long long item,
                               int* s_hist, int* s_row, BlockScalars* s,
                               const Outputs& out) {
  const int tid = threadIdx.x;
  for (int k = tid; k < L; k += kThreads) s_hist[k] = 0;
  if (tid == 0) {
    s->vmax = INT_MIN;
    s->count = 0;
  }
  __syncthreads();
  int local_max = INT_MIN;
  int local_count = 0;
  for (int p = tid; p < HW; p += kThreads) {
    const int v = px[p];
    const bool in = !kMask || mk[p] != 0;
    local_max = max(local_max, in ? v : -1);
    if (in && static_cast<unsigned>(v) < static_cast<unsigned>(L)) {
      atomicAdd(&s_hist[v], 1);
      ++local_count;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    local_max = max(local_max, __shfl_down_sync(0xffffffffu, local_max, o));
  }
  local_count = warp_sum(local_count);
  if ((tid & 31) == 0) {
    atomicMax(&s->vmax, local_max);
    atomicAdd(&s->count, local_count);
  }
  __syncthreads();
  const int vmax = s->vmax;
  const int* row = lut + static_cast<long long>(min(max(vmax, 0), L - 1)) * L;
  for (int k = tid; k < L; k += kThreads) {
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
}

// The pair window of offset (dr, dc) in 2-D indices (no flat shift, so
// nothing wraps across a row end): pair q's left pixel is (r0 + q / wn,
// c0 + q % wn).
struct Window {
  int r0, c0, wn, n_pairs, step;  // step: flat index of the right pixel - left
  __device__ Window(int H, int W, int dr, int dc) {
    r0 = max(0, -dr);
    c0 = max(0, -dc);
    wn = W - max(0, dc) - c0;
    n_pairs = (H - max(0, dr) - r0) * wn;
    step = dr * W + dc;
  }
};

// Pair q's rescaled levels (i, j); false when masked and either end is out.
template <bool kMask>
__device__ __forceinline__ bool pair_levels(const Window& w, int q, int W,
                                            const int* px,
                                            const unsigned char* mk,
                                            const int* s_row, int L, int* i,
                                            int* j) {
  const int rr = q / w.wn;
  const int pl = (w.r0 + rr) * W + w.c0 + (q - rr * w.wn);
  const int pr = pl + w.step;
  if (kMask && (mk[pl] == 0 || mk[pr] == 0)) return false;
  const int vl = px[pl];
  const int vr = px[pr];
  *i = static_cast<unsigned>(vl) < static_cast<unsigned>(L) ? s_row[vl] : 0;
  *j = static_cast<unsigned>(vr) < static_cast<unsigned>(L) ? s_row[vr] : 0;
  return true;
}

// The generic sum(G^2) limbs of one cell: g = a*2^12 + b ->
// [a^2, a*b, b^2 >> 8, b^2 & 255], as tpumcia.features.stats encodes them.
__device__ __forceinline__ void add_limbs(long long g, long long acc[4]) {
  const long long a = g >> 12, b = g & 4095, bb = b * b;
  acc[0] += a * a;
  acc[1] += a * b;
  acc[2] += bb >> 8;
  acc[3] += bb & 255;
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

template <bool kMask, bool kNeedDiff>
__global__ void __launch_bounds__(kThreads) glcm_stats_kernel(
    const int* __restrict__ img, const unsigned char* __restrict__ mask,
    int mask_channels, int channels, const int* __restrict__ lut, int H,
    int W, int L, Offsets offs, int cheap, Outputs out) {
  extern __shared__ unsigned int g_words[];  // G as packed u16 pairs
  __shared__ int s_hist[kMaxLevels];
  __shared__ int s_ml[kMaxLevels];
  __shared__ int s_mr[kMaxLevels];
  __shared__ int s_dh[2 * kMaxLevels - 1];  // signed difference histogram
  __shared__ int s_row[kMaxLevels];         // rescale row lut[clamp(vmax)]
  __shared__ BlockScalars s;
  __shared__ long long s_red[kWarps][4];

  const long long item = blockIdx.x;  // b * channels + c
  const long long items = gridDim.x;
  const int tid = threadIdx.x;
  const int HW = H * W;
  const int* px;
  const unsigned char* mk;
  item_planes<kMask>(img, mask, mask_channels, channels, item, HW, &px, &mk);
  const int n_words = (L * L + 1) / 2;
  const int n_diff = 2 * L - 1;

  histogram_pass<kMask>(px, mk, HW, L, lut, item, s_hist, s_row, &s, out);

  for (int o = 0; o < offs.n; ++o) {
    const Window win(H, W, offs.dr[o], offs.dc[o]);
    const long long oi = o * items + item;  // row of this offset's outputs

    // the previous offset's emission reads these tables: every thread is
    // past it (the __syncthreads at the end of the loop) before they reset
    for (int k = tid; k < n_words; k += kThreads) g_words[k] = 0u;
    for (int k = tid; k < L; k += kThreads) {
      s_ml[k] = 0;
      s_mr[k] = 0;
    }
    for (int k = tid; k < n_diff; k += kThreads) s_dh[k] = 0;
    if (tid == 0) s.pairs = 0;
    __syncthreads();

    // pass 2: every pair of the offset window; masked, only pairs whose
    // both ends are masked
    int local_pairs = 0;
    for (int q = tid; q < win.n_pairs; q += kThreads) {
      int i, j;
      if (!pair_levels<kMask>(win, q, W, px, mk, s_row, L, &i, &j)) continue;
      ++local_pairs;
      atomicAdd(&s_ml[i], 1);
      atomicAdd(&s_mr[j], 1);
      atomicAdd(&s_dh[i - j + L - 1], 1);
      const int k = i * L + j;
      atomicAdd(&g_words[k >> 1], 1u << (16 * (k & 1)));
    }
    local_pairs = warp_sum(local_pairs);
    if ((tid & 31) == 0) atomicAdd(&s.pairs, local_pairs);
    __syncthreads();

    for (int k = tid; k < L; k += kThreads) {
      out.marg_l[oi * L + k] = static_cast<float>(s_ml[k]);
      out.marg_r[oi * L + k] = static_cast<float>(s_mr[k]);
    }
    if (kNeedDiff) {
      for (int k = tid; k < n_diff; k += kThreads) {
        out.dout[oi * n_diff + k] = static_cast<float>(s_dh[k]);
      }
    }

    // sum(G^2) limbs, same encodings as tpumcia.features.stats:
    //  cheap (H*W <= 4096 and L <= 256): s2 = sum g^2 -> [0, 0, s2>>8, s2&255]
    //  generic: g = a*2^12 + b -> [sum a^2, sum a*b, sum (b^2>>8), sum (b^2&255)]
    long long acc[4] = {0, 0, 0, 0};
    for (int k = tid; k < n_words; k += kThreads) {
      const unsigned int w = g_words[k];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long g = (w >> (16 * half)) & 0xFFFFu;
        if (cheap) {
          acc[3] += g * g;
        } else {
          add_limbs(g, acc);
        }
      }
    }
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
        long long sq4[4] = {0, 0, 0, 0};
        for (int w = 0; w < kWarps; ++w) {
#pragma unroll
          for (int m = 0; m < 4; ++m) sq4[m] += s_red[w][m];
        }
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
__device__ int block_rank(const int* counts, int* rank, int L, int* s_scan) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (L + kThreads - 1) / kThreads;
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
    int v = lane < kWarps ? s_scan[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < kWarps) s_scan[lane] = v;
  }
  __syncthreads();
  int next = x - n + (warp > 0 ? s_scan[warp - 1] : 0);
  for (int k = beg; k < end; ++k) rank[k] = counts[k] > 0 ? next++ : -1;
  const int total = s_scan[kWarps - 1];
  __syncthreads();  // s_scan is reused by the next call
  return total;
}

// Form B1d (see the header): u32 G in bands over the occupied levels, the
// difference histogram always, generic limbs. band_words: the u32 cells of
// dynamic shared memory past the 7L-1 int tables (>= L).
template <bool kMask>
__global__ void __launch_bounds__(kThreads) glcm_stats_large_kernel(
    const int* __restrict__ img, const unsigned char* __restrict__ mask,
    int mask_channels, int channels, const int* __restrict__ lut, int H,
    int W, int L, Offsets offs, int band_words, Outputs out) {
  extern __shared__ int tables[];
  int* s_hist = tables;            // L; after pass 1, the left-level ranks
  int* s_rank_r = s_hist + L;      // L: the right-level ranks
  int* s_row = s_rank_r + L;       // L: rescale row lut[clamp(vmax)]
  int* s_ml = s_row + L;           // L
  int* s_mr = s_ml + L;            // L
  int* s_dh = s_mr + L;            // 2L-1: signed difference histogram
  unsigned int* s_band = reinterpret_cast<unsigned int*>(s_dh + 2 * L - 1);
  int* s_rank_l = s_hist;
  __shared__ BlockScalars s;
  __shared__ int s_scan[kWarps];
  __shared__ long long s_red[kWarps][4];

  const long long item = blockIdx.x;  // b * channels + c
  const long long items = gridDim.x;
  const int tid = threadIdx.x;
  const int HW = H * W;
  const int* px;
  const unsigned char* mk;
  item_planes<kMask>(img, mask, mask_channels, channels, item, HW, &px, &mk);
  const int n_diff = 2 * L - 1;

  histogram_pass<kMask>(px, mk, HW, L, lut, item, s_hist, s_row, &s, out);

  for (int o = 0; o < offs.n; ++o) {
    const Window win(H, W, offs.dr[o], offs.dc[o]);
    const long long oi = o * items + item;  // row of this offset's outputs

    for (int k = tid; k < L; k += kThreads) {
      s_ml[k] = 0;
      s_mr[k] = 0;
    }
    for (int k = tid; k < n_diff; k += kThreads) s_dh[k] = 0;
    if (tid == 0) s.pairs = 0;
    __syncthreads();

    // the marginals, the difference histogram and the pair count
    int local_pairs = 0;
    for (int q = tid; q < win.n_pairs; q += kThreads) {
      int i, j;
      if (!pair_levels<kMask>(win, q, W, px, mk, s_row, L, &i, &j)) continue;
      ++local_pairs;
      atomicAdd(&s_ml[i], 1);
      atomicAdd(&s_mr[j], 1);
      atomicAdd(&s_dh[i - j + L - 1], 1);
    }
    local_pairs = warp_sum(local_pairs);
    if ((tid & 31) == 0) atomicAdd(&s.pairs, local_pairs);
    __syncthreads();
    for (int k = tid; k < L; k += kThreads) {
      out.marg_l[oi * L + k] = static_cast<float>(s_ml[k]);
      out.marg_r[oi * L + k] = static_cast<float>(s_mr[k]);
    }
    for (int k = tid; k < n_diff; k += kThreads) {
      out.dout[oi * n_diff + k] = static_cast<float>(s_dh[k]);
    }

    // G over the occupied levels, R occupied rows at a time
    const int occ_l = block_rank(s_ml, s_rank_l, L, s_scan);
    const int occ_r = block_rank(s_mr, s_rank_r, L, s_scan);
    const int rows = occ_r > 0 ? band_words / occ_r : 1;
    long long acc[4] = {0, 0, 0, 0};
    for (int lo = 0; lo < occ_l; lo += rows) {
      const int n_rows = min(rows, occ_l - lo);
      const int cells = n_rows * occ_r;
      for (int k = tid; k < cells; k += kThreads) s_band[k] = 0u;
      __syncthreads();
      for (int q = tid; q < win.n_pairs; q += kThreads) {
        int i, j;
        if (!pair_levels<kMask>(win, q, W, px, mk, s_row, L, &i, &j)) continue;
        const int band_row = s_rank_l[i] - lo;
        if (static_cast<unsigned>(band_row) < static_cast<unsigned>(n_rows)) {
          atomicAdd(&s_band[band_row * occ_r + s_rank_r[j]], 1u);
        }
      }
      __syncthreads();
      for (int k = tid; k < cells; k += kThreads) add_limbs(s_band[k], acc);
      __syncthreads();  // the next band zeroes these cells
    }
    reduce_limbs(acc, s_red);
    if (tid == 0) {
      long long sq4[4] = {0, 0, 0, 0};
      for (int w = 0; w < kWarps; ++w) {
#pragma unroll
        for (int m = 0; m < 4; ++m) sq4[m] += s_red[w][m];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) out.sumsq[oi * 4 + m] = static_cast<int>(sq4[m]);
      out.pairs[oi] = static_cast<float>(kMask ? s.pairs : win.n_pairs);
    }
    __syncthreads();
  }
}

template <bool kMask, bool kNeedDiff>
cudaError_t launch(const int* img, const unsigned char* mask,
                   int mask_channels, int channels, const int* lut,
                   int items, int H, int W, int L, const Offsets& offs,
                   int cheap, const Outputs& out, cudaStream_t stream) {
  const int smem = ((L * L + 1) / 2) * static_cast<int>(sizeof(unsigned int));
  auto kernel = glcm_stats_kernel<kMask, kNeedDiff>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (items == 0) return cudaSuccess;
  kernel<<<items, kThreads, smem, stream>>>(img, mask, mask_channels,
                                            channels, lut, H, W, L, offs,
                                            cheap, out);
  return cudaGetLastError();
}

// B1d: as much dynamic shared memory as the block may hold (no more than a
// whole G of L*L cells needs), the tables first and the band after them.
template <bool kMask>
cudaError_t launch_large(const int* img, const unsigned char* mask,
                         int mask_channels, int channels, const int* lut,
                         int items, int H, int W, int L, const Offsets& offs,
                         const Outputs& out, cudaStream_t stream) {
  auto kernel = glcm_stats_large_kernel<kMask>;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const long long table_bytes = (7LL * L - 1) * sizeof(int);
  const long long whole_g = table_bytes + 4LL * L * L;
  long long smem = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
  if (smem > whole_g) smem = whole_g;
  const long long band_words = (smem - table_bytes) / 4;
  if (band_words < L) return cudaErrorInvalidValue;  // not one row of G
  smem = table_bytes + band_words * 4;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (items == 0) return cudaSuccess;
  kernel<<<items, kThreads, static_cast<size_t>(smem), stream>>>(
      img, mask, mask_channels, channels, lut, H, W, L, offs,
      static_cast<int>(band_words), out);
  return cudaGetLastError();
}

}  // namespace

// offsets: 2 * num_offsets host ints, (dr, dc) pairs. mask: nullptr, or
// uint8 (batch, mask_channels, H, W) with mask_channels 1 or channels.
// dout: the difference histogram when need_diff, else dstats. Sizes with
// H*W >= 65536 or L > 256 take the B1d kernel, which needs need_diff and
// cheap == 0, L <= 4096 and H*W < 2^24.
extern "C" int tpumcia_glcm_stats(
    const int* img, const unsigned char* mask, int mask_channels,
    const int* lut, int batch, int channels, int H, int W, int L,
    const int* offsets, int num_offsets, int need_diff, int cheap,
    float* hist, float* count, int* vmax, float* marg_l, float* marg_r,
    float* dout, int* sumsq, float* pairs, void* stream) {
  const long long hw = static_cast<long long>(H) * W;
  const bool large = hw >= 65536 || L > kMaxLevels;
  if (L < 1 || H < 1 || W < 1 || batch < 0 || channels < 1 ||
      num_offsets < 1 || num_offsets > kMaxOffsets ||
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
  }
  const Outputs out{hist, count, vmax, marg_l, marg_r, dout, sumsq, pairs};
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(items);
  cudaError_t err;
  if (large) {
    err = mask != nullptr
              ? launch_large<true>(img, mask, mask_channels, channels, lut, n,
                                   H, W, L, offs, out, s)
              : launch_large<false>(img, mask, 1, channels, lut, n, H, W, L,
                                    offs, out, s);
  } else if (mask != nullptr) {
    err = need_diff ? launch<true, true>(img, mask, mask_channels, channels,
                                         lut, n, H, W, L, offs, cheap, out, s)
                    : launch<true, false>(img, mask, mask_channels, channels,
                                          lut, n, H, W, L, offs, cheap, out, s);
  } else {
    err = need_diff ? launch<false, true>(img, mask, 1, channels, lut, n, H,
                                          W, L, offs, cheap, out, s)
                    : launch<false, false>(img, mask, 1, channels, lut, n, H,
                                           W, L, offs, cheap, out, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* tpumcia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
