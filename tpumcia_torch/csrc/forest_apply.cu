// Random-forest inference: every (draw, row) lane walks every tree to its
// leaf, reading a permuted draw's columns in place.
//
// Replaces no TPU kernel. tpumcia scores a forest with XLA operations alone
// (tpumcia/models/forest_device.py: the GEMM form, or the lock-step
// descent), and its permutation sweep materialises each permuted copy of
// the rows before scoring it. The port scores a forest by this walk alone;
// its plain version, _apply_walk (models/forest_device.py), runs off the
// card. On an H100 the port's GEMM form over the copies moved about 1 GB and
// ran a dense float32 product per block of trees to answer what a walk
// answers in about ten comparisons a lane.
//
// What it computes. X: (N, F) float32 scaled rows. perm: nullptr, or (D, N)
// int64 row permutations with mask: (G, F) bytes, draw d belonging to group
// d / repeats. Lane (d, n) reads feature f of its row as X[perm[d, n], f]
// where mask[d / repeats, f] is nonzero, else as X[n, f]: the rows that
// torch.where(permuted, X[perm], X) would hold, without the copy. The lane
// walks tree t from roots[t], going left iff x <= threshold (so NaN goes
// right), until a leaf (feature < 0), with no depth cap; it adds the leaf's
// class fractions to its sums in tree order, in float32, and writes
// sum * (1 / T) to out[d, n, :] (D = 1 without perm): PyTorch's float32
// division by a host scalar on the card, so the shares equal the plain
// version's (_apply_walk in models/forest_device.py) bit for bit. One thread owns each output row and no
// atomic is used, so two runs are bit-equal.
//
// What bounds it on an H100. Few bytes (X stays in L2, each permutation is
// read once and each share written once: about 70 MB over the 690 draws of
// a 69-column sweep of 3,000 rows) and no product for the tensor cores:
// each node step is a dependent chain of a node load, a mask byte and a
// feature load. The design keeps that chain short and the warps converged:
//  - the forest (16-byte nodes, the roots and the distinct rows of leaf
//    fractions) is copied into shared memory once per resident block, and
//    the blocks then loop over the lanes (a persistent grid). A forest too
//    large for shared memory is read through L1/L2 by the same code;
//  - lanes are ordered draw-minor (lane = n * D + d), so a warp holds one
//    row under 32 consecutive draws: its threads walk the same tree at a
//    time, follow one path and read the same node and feature (broadcasts)
//    until a permuted column sends some of them elsewhere. The plain apply
//    (D = 1) gives a warp 32 adjacent rows;
//  - the class sums live in registers, kClassTile at a time: a forest of
//    more classes walks its trees once per tile of classes.
//
// Entry points (plain C, loaded with ctypes): tpumcia_forest_apply launches
// on the caller's stream, allocates nothing and returns cudaGetLastError();
// tpumcia_forest_launch_info reports the block size, dynamic shared memory,
// resident blocks per SM, whether the forest sits in shared memory and the
// grid a launch of that forest over that many lanes would use.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;
constexpr int kClassTile = 32;

// feature (-1 at a leaf), the threshold's float32 bits, the left and right
// children's indices in the forest; at a leaf z is its row of values
using Node = int4;

struct Forest {
  const Node* nodes;
  const float* values;  // (num_values, classes) distinct leaf fractions
  const int* roots;     // (trees,) each tree's root node
  int num_nodes;
  int num_values;
  int classes;
  int trees;
};

size_t shared_bytes(int num_nodes, int num_values, int classes, int trees) {
  return static_cast<size_t>(num_nodes) * sizeof(Node) +
         static_cast<size_t>(num_values) * classes * sizeof(float) +
         static_cast<size_t>(trees) * sizeof(int);
}

template <bool kShared, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks) forest_apply_kernel(
    const float* __restrict__ X, int N, int F, const long long* __restrict__ perm,
    const unsigned char* __restrict__ mask, int repeats, int D, Forest forest,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Node* nodes = forest.nodes;
  const float* values = forest.values;
  const int* roots = forest.roots;
  const int K = forest.classes;
  if constexpr (kShared) {
    Node* s_nodes = reinterpret_cast<Node*>(smem);
    float* s_values = reinterpret_cast<float*>(s_nodes + forest.num_nodes);
    int* s_roots = reinterpret_cast<int*>(s_values + forest.num_values * K);
    for (int i = threadIdx.x; i < forest.num_nodes; i += blockDim.x) {
      s_nodes[i] = __ldg(forest.nodes + i);
    }
    for (int i = threadIdx.x; i < forest.num_values * K; i += blockDim.x) {
      s_values[i] = __ldg(forest.values + i);
    }
    for (int i = threadIdx.x; i < forest.trees; i += blockDim.x) {
      s_roots[i] = __ldg(forest.roots + i);
    }
    __syncthreads();
    nodes = s_nodes;
    values = s_values;
    roots = s_roots;
  }
  const float inv_trees = __fdiv_rn(1.0f, static_cast<float>(forest.trees));
  const long long lanes = static_cast<long long>(N) * D;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       lane < lanes; lane += stride) {
    const int n = static_cast<int>(lane / D);
    const int d = static_cast<int>(lane - static_cast<long long>(n) * D);
    const float* row = X + static_cast<size_t>(n) * F;
    const float* permuted_row = row;
    const unsigned char* permuted = nullptr;
    if (perm != nullptr) {
      permuted_row = X + static_cast<size_t>(__ldg(perm + static_cast<size_t>(d) * N + n)) * F;
      permuted = mask + static_cast<size_t>(d / repeats) * F;
    }
    float* o = out + (static_cast<size_t>(d) * N + n) * K;
    for (int k0 = 0; k0 < K; k0 += kClassTile) {
      const int width = K - k0 < kClassTile ? K - k0 : kClassTile;
      float acc[kClassTile];
#pragma unroll
      for (int k = 0; k < kClassTile; ++k) acc[k] = 0.0f;
      for (int t = 0; t < forest.trees; ++t) {
        Node nd = load<kShared>(nodes + load<kShared>(roots + t));
        while (nd.x >= 0) {
          const float* src = permuted != nullptr && __ldg(permuted + nd.x) ? permuted_row : row;
          const float x = __ldg(src + nd.x);
          nd = load<kShared>(nodes + (x <= __int_as_float(nd.y) ? nd.z : nd.w));
        }
        const float* leaf = values + static_cast<size_t>(nd.z) * K + k0;
#pragma unroll
        for (int k = 0; k < kClassTile; ++k) {
          if (k < width) acc[k] += load<kShared>(leaf + k);
        }
      }
#pragma unroll
      for (int k = 0; k < kClassTile; ++k) {
        if (k < width) o[k0 + k] = acc[k] * inv_trees;
      }
    }
  }
}

using KernelFn = void (*)(const float*, int, int, const long long*, const unsigned char*, int,
                          int, Forest, float*);

struct Plan {
  KernelFn kernel;
  int smem;
  int blocks_per_sm;
  int grid;
};

// On the current device: the forest in shared memory where it fits in the
// dynamic shared memory a block may ask for (the device's opt-in less the
// kernel's static use), with the kernel's cap raised to that amount. The
// cap is an attribute of the kernel on each device, so it is set before
// every launch, to the same value on a device, as CUTLASS does.
cudaError_t plan(int num_nodes, int num_values, int classes, int trees, long long lanes,
                 Plan* p) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const KernelFn in_shared = forest_apply_kernel<true>;
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(in_shared));
  if (err != cudaSuccess) return err;
  const int smem_max = optin - static_cast<int>(attr.sharedSizeBytes);
  const size_t need = shared_bytes(num_nodes, num_values, classes, trees);
  const bool shared = need <= static_cast<size_t>(smem_max);
  p->kernel = shared ? in_shared : forest_apply_kernel<false>;
  p->smem = shared ? static_cast<int>(need) : 0;
  if (shared) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(in_shared),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &p->blocks_per_sm, reinterpret_cast<const void*>(p->kernel), kThreads, p->smem);
  }
  if (err != cudaSuccess) return err;
  if (p->blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long wanted = (lanes + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * p->blocks_per_sm;
  p->grid = static_cast<int>(wanted < resident ? wanted : resident);
  return cudaSuccess;
}

bool valid_forest(const int* nodes, int num_nodes, int num_values, int classes, int trees) {
  return num_nodes >= 1 && num_values >= 1 && trees >= 1 && classes >= 1 &&
         reinterpret_cast<uintptr_t>(nodes) % alignof(Node) == 0;
}

}  // namespace

// X: (N, F) float32. perm: nullptr (then mask is nullptr and D is 1), or
// (D, N) int64 rows of X with mask (ceil(D / repeats), F) uint8. nodes:
// (num_nodes, 4) int32, 16-byte aligned, each child index above its
// parent's; roots: (trees,) int32; values: (num_values, classes) float32;
// every feature below F. out: (D, N, classes) float32.
extern "C" int tpumcia_forest_apply(
    const float* X, int N, int F, const long long* perm, const unsigned char* mask,
    int repeats, int D, const int* nodes, int num_nodes, const int* roots, int trees,
    const float* values, int num_values, int classes, float* out, void* stream) {
  if (N < 0 || F < 1 || D < 1 || repeats < 1 || (perm == nullptr) != (mask == nullptr) ||
      (perm == nullptr && D != 1) ||
      !valid_forest(nodes, num_nodes, num_values, classes, trees)) {
    return cudaErrorInvalidValue;
  }
  const long long lanes = static_cast<long long>(N) * D;
  if (lanes == 0) return cudaSuccess;
  Plan p;
  cudaError_t err = plan(num_nodes, num_values, classes, trees, lanes, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Forest forest{reinterpret_cast<const Node*>(nodes), values, roots,
                      num_nodes, num_values, classes, trees};
  p.kernel<<<p.grid, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      X, N, F, perm, mask, repeats, D, forest, out);
  return static_cast<int>(cudaGetLastError());
}

// info[0..4] <- threads per block, dynamic shared memory bytes (0 where the
// forest is read from device memory), resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), whether the forest sits
// in shared memory, and the grid, for a launch of that forest over lanes
// (draw, row) lanes.
extern "C" int tpumcia_forest_launch_info(int num_nodes, int num_values, int classes, int trees,
                                          long long lanes, int* info) {
  if (num_nodes < 1 || num_values < 1 || trees < 1 || classes < 1 || lanes < 1) {
    return cudaErrorInvalidValue;
  }
  Plan p;
  const cudaError_t err = plan(num_nodes, num_values, classes, trees, lanes, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = kThreads;
  info[1] = p.smem;
  info[2] = p.blocks_per_sm;
  info[3] = p.smem > 0;
  info[4] = p.grid;
  return 0;
}
