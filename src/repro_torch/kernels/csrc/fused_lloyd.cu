// Fused Lloyd pass over a stack of subsets, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` in src/repro/kernels/fused.py
// (one Lloyd pass: online argmin of ||c||^2 - 2 x.c over centroid tiles, then
// a weighted one-hot segment-sum into sums (k,d), counts (k,) and the SSE;
// `assign_only` stops at labels and distances).  Here the pass runs over a
// lane dimension: x (M,S,d), c (M,k,d), w (M,S), restricted to the lanes
// listed in `lanes`, so one launch serves a whole S2 reducer stack.
//
// What bounds it on this card: the score product.  One pass does 2*S*k*d
// IEEE f32 operations per lane against 4*S*d bytes of points, i.e. about
// k/2 = 512 FLOP per byte at k = 1024, far above the H100's f32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP per byte.  It is compute-bound on the
// f32 FMA pipes (no tensor cores: TF32 would change labels against the
// reference, which scores in IEEE f32).
//
// What the design does about it:
//   * phase 1 (`assign_kernel`) is a register-blocked SIMT product: a block
//     owns 128 points of one lane and walks all centroids in 128-wide tiles,
//     each thread holding an 8x8 tile of scores in registers and folding it
//     into a running (best, index) per row at the end of every centroid
//     tile.  Centroids are scanned in increasing index and replaced only on
//     a strict `<`; the 16 threads that share a row merge their candidates
//     by (score, index), so the lowest index wins every tie, as in the
//     reference.  Scores are ||c||^2 - 2 x.c; ||x||^2 is added back once
//     per row at the end, mind = max(best + ||x||^2, 0).
//   * the TPU kernel keeps the (k, d) accumulators resident in VMEM across
//     its sequential grid.  Blocks here run in no order and one lane's
//     accumulator (1024 x 64 f32 = 256 KB) exceeds a block's shared memory,
//     so the reduction over points is a second pass (`accumulate_kernel`),
//     one block per lane: an integer histogram of labels, a scan, a stable
//     counting sort of the point indices by label (one warp, 32 points at a
//     time, ranks from __match_any_sync), then one warp per cluster summing
//     its points in increasing point order.  The SSE is a fixed-shape tree
//     reduction.  No float atomics anywhere: the same inputs give the same
//     bits on every run.  The labels and distances make one round trip
//     through device memory between the passes (8 bytes a point, against
//     the 256 bytes a point the product reads at d = 64).
//   * no padding of d, S or k: every ragged edge is masked in the kernels.
//   * the scoring and the reduction are device functions in lloyd_device.cuh,
//     shared with the whole-solve kernel (lloyd_solve.cu) and the assign and
//     centroid-update kernels (sweeps.cu), so that a lane of those kernels
//     picks the same labels and sums as this pass.
//
// Plain C interface, loaded with ctypes: `fused_lloyd` returns the first
// non-zero cudaGetLastError() after a launch, 0 on success.

#include <cuda_runtime.h>
#include <math.h>

#include "lloyd_device.cuh"

namespace {

using lloyd::BM;
using lloyd::NT;
constexpr int ACC_THREADS = 1024;

constexpr int NORM_THREADS = 256;

__global__ void __launch_bounds__(NORM_THREADS)
centroid_norms_kernel(const float* __restrict__ c,
                      const int* __restrict__ lanes, int k, int d,
                      float* __restrict__ cn) {
  const int g = blockIdx.y;
  const int j0 = blockIdx.x * NORM_THREADS;
  lloyd::centroid_norms<NORM_THREADS>(
      c + ((long long)lanes[g] * k + j0) * d, min(NORM_THREADS, k - j0), d,
      cn + (long long)g * k + j0);
}

__global__ void __launch_bounds__(NT, 2)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              const float* __restrict__ cn, const int* __restrict__ lanes,
              int S, int d, int k,
              int* __restrict__ labels, float* __restrict__ mind) {
  __shared__ lloyd::ScoreTiles sm;
  const int g = blockIdx.y;
  const long long lane = lanes[g];
  const long long o = (long long)g * S;
  lloyd::score_tile<false>(x + lane * S * (long long)d,
                           c + lane * k * (long long)d, cn + (long long)g * k,
                           S, d, k, blockIdx.x * BM, sm, labels + o, mind + o,
                           nullptr, nullptr, nullptr, 0);
}

__global__ void __launch_bounds__(ACC_THREADS)
accumulate_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ lanes,
                  const int* __restrict__ labels,
                  const float* __restrict__ mind, int S, int d, int k,
                  int* __restrict__ order, float* __restrict__ sums,
                  float* __restrict__ counts, float* __restrict__ sse) {
  extern __shared__ int smem[];
  __shared__ float red[ACC_THREADS];
  const int g = blockIdx.x;
  const float total = lloyd::block_weighted_sum<ACC_THREADS>(
      w + (long long)lanes[g] * S, mind + (long long)g * S, S, red);
  if (threadIdx.x == 0) sse[g] = total;
  lloyd::lane_segment_sums<ACC_THREADS>(x, w, lanes, labels, S, d, k, order,
                                        smem, sums, counts);
}

}  // namespace

extern "C" int fused_lloyd(const float* x, const float* c, const float* w,
                           const int* lanes, int L, int S, int d, int k,
                           float* cn, int* labels, float* mind, int* order,
                           float* sums, float* counts, float* sse,
                           int assign_only, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  centroid_norms_kernel<<<dim3((k + NORM_THREADS - 1) / NORM_THREADS, L),
                          NORM_THREADS, 0, stream>>>(c, lanes, k, d, cn);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  assign_kernel<<<dim3((S + BM - 1) / BM, L), NT, 0, stream>>>(
      x, c, cn, lanes, S, d, k, labels, mind);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (assign_only) return 0;
  const size_t smem = (2 * (size_t)k + 1) * sizeof(int);
  err = cudaFuncSetAttribute(accumulate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  accumulate_kernel<<<L, ACC_THREADS, smem, stream>>>(
      x, w, lanes, labels, mind, S, d, k, order, sums, counts, sse);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}
