// GLCM sufficient statistics for one (image, channel) per thread block.
//
// Replaces the TPU kernels of tpumcia/features/pallas_glcm.py in every form
// the single-device extraction runs:
//   _kernel (driven by _pallas_stats_core), maskless or masked (has_mask),
//   emitting dstats (need_diff=False) or the difference histogram
//   (need_diff=True); and _kernel_multi (driven by _pallas_stats_multi_core),
//   the same outputs for up to kMaxOffsets GLCM offsets in one pass.
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
// What bounds it on an H100: each block reads its channel's H*W int32 pixels
// (and mask bytes) once for the histogram and once per offset for the pairs
// (16 KB at 64x64; the later reads are meant to come from L1/L2) and issues
// five shared-memory atomics per admitted pixel pair. G itself is 256 x 256
// u16 counts packed two per u32 word, 128 KB of dynamic shared memory, which
// is zeroed and scanned once per offset: at 64x64 that is 32,768 words
// against 4,096 pixel pairs, and the 128 KB holds each SM to one resident
// block. The packing is exact while a cell count stays below 2^16, which the
// wrapper guarantees by requiring H*W < 65536. Several offsets share the
// histogram pass and the block's launch, and reuse the same 128 KB for each
// offset's G in turn, so shared memory does not grow with the offset count.
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

constexpr int kMaxLevels = 256;
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
  __shared__ int s_vmax;
  __shared__ int s_count;
  __shared__ int s_pairs;
  __shared__ long long s_red[kWarps][4];

  const long long item = blockIdx.x;  // b * channels + c
  const long long items = gridDim.x;
  const int tid = threadIdx.x;
  const int HW = H * W;
  const int* px = img + item * HW;
  const unsigned char* mk = nullptr;
  if (kMask) {
    const long long b = item / channels;
    const long long c = mask_channels == 1 ? 0 : item % channels;
    mk = mask + (b * mask_channels + c) * HW;
  }
  const int n_words = (L * L + 1) / 2;
  const int n_diff = 2 * L - 1;

  for (int k = tid; k < L; k += kThreads) s_hist[k] = 0;
  if (tid == 0) {
    s_vmax = INT_MIN;
    s_count = 0;
  }
  __syncthreads();

  // pass 1: raw histogram, pixel count and channel max over the (masked)
  // pixels. vmax takes -1 for every masked-out pixel, as the JAX package's
  // max(where(mask, x, -1)) does. A level outside [0, L) breaks the caller's
  // contract; it is dropped from the histogram (as a one-hot drops it) so
  // that no shared-memory index leaves its table.
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
    atomicMax(&s_vmax, local_max);
    atomicAdd(&s_count, local_count);
  }
  __syncthreads();
  const int vmax = s_vmax;
  const int* row = lut + static_cast<long long>(min(max(vmax, 0), L - 1)) * L;
  for (int k = tid; k < L; k += kThreads) {
    s_row[k] = row[k];
    out.hist[item * L + k] = static_cast<float>(s_hist[k]);
  }
  if (tid == 0) {
    // masked: the pixels the histogram holds (the JAX kernel's sum(hist));
    // maskless: every pixel
    out.count[item] = static_cast<float>(kMask ? s_count : HW);
    out.vmax[item] = vmax;
  }

  for (int o = 0; o < offs.n; ++o) {
    const int dr = offs.dr[o], dc = offs.dc[o];
    const long long oi = o * items + item;  // row of this offset's outputs

    // the previous offset's emission reads these tables: every thread is
    // past it (the __syncthreads at the end of the loop) before they reset
    for (int k = tid; k < n_words; k += kThreads) g_words[k] = 0u;
    for (int k = tid; k < L; k += kThreads) {
      s_ml[k] = 0;
      s_mr[k] = 0;
    }
    for (int k = tid; k < n_diff; k += kThreads) s_dh[k] = 0;
    if (tid == 0) s_pairs = 0;
    __syncthreads();

    // pass 2: every pair of the offset window in 2-D indices (no flat
    // shift, so nothing wraps across a row end); masked, only pairs whose
    // both ends are masked
    const int r0 = max(0, -dr), r1 = H - max(0, dr);
    const int c0 = max(0, -dc), c1 = W - max(0, dc);
    const int wn = c1 - c0;
    const int n_pairs = (r1 - r0) * wn;
    int local_pairs = 0;
    for (int q = tid; q < n_pairs; q += kThreads) {
      const int rr = q / wn;
      const int r = r0 + rr;
      const int c = c0 + (q - rr * wn);
      const int pl = r * W + c;
      const int pr = (r + dr) * W + (c + dc);
      if (kMask && (mk[pl] == 0 || mk[pr] == 0)) continue;
      ++local_pairs;
      const int vl = px[pl];
      const int vr = px[pr];
      const int i =
          static_cast<unsigned>(vl) < static_cast<unsigned>(L) ? s_row[vl] : 0;
      const int j =
          static_cast<unsigned>(vr) < static_cast<unsigned>(L) ? s_row[vr] : 0;
      atomicAdd(&s_ml[i], 1);
      atomicAdd(&s_mr[j], 1);
      atomicAdd(&s_dh[i - j + L - 1], 1);
      const int k = i * L + j;
      atomicAdd(&g_words[k >> 1], 1u << (16 * (k & 1)));
    }
    local_pairs = warp_sum(local_pairs);
    if ((tid & 31) == 0) atomicAdd(&s_pairs, local_pairs);
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
          const long long a = g >> 12, b = g & 4095, bb = b * b;
          acc[0] += a * a;
          acc[1] += a * b;
          acc[2] += bb >> 8;
          acc[3] += bb & 255;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[m] = warp_sum(acc[m]);
    if ((tid & 31) == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m) s_red[tid >> 5][m] = acc[m];
    }
    __syncthreads();

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
        long long s[4] = {0, 0, 0, 0};
        for (int w = 0; w < kWarps; ++w) {
#pragma unroll
          for (int m = 0; m < 4; ++m) s[m] += s_red[w][m];
        }
        int* sq = out.sumsq + oi * 4;
        if (cheap) {
          sq[0] = 0;
          sq[1] = 0;
          sq[2] = static_cast<int>(s[3] >> 8);
          sq[3] = static_cast<int>(s[3] & 255);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m) sq[m] = static_cast<int>(s[m]);
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
        out.pairs[oi] = static_cast<float>(kMask ? s_pairs : n_pairs);
      }
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

}  // namespace

// offsets: 2 * num_offsets host ints, (dr, dc) pairs. mask: nullptr, or
// uint8 (batch, mask_channels, H, W) with mask_channels 1 or channels.
// dout: the difference histogram when need_diff, else dstats.
extern "C" int tpumcia_glcm_stats(
    const int* img, const unsigned char* mask, int mask_channels,
    const int* lut, int batch, int channels, int H, int W, int L,
    const int* offsets, int num_offsets, int need_diff, int cheap,
    float* hist, float* count, int* vmax, float* marg_l, float* marg_r,
    float* dout, int* sumsq, float* pairs, void* stream) {
  if (L < 1 || L > kMaxLevels || batch < 0 || channels < 1 ||
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
  }
  const Outputs out{hist, count, vmax, marg_l, marg_r, dout, sumsq, pairs};
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(items);
  cudaError_t err;
  if (mask != nullptr) {
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
