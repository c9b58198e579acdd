// One pass over the points outside the Lloyd loop, for Hopper (sm_90a):
// the assign pass, the centroid update and the k-means|| init sweep.
//
// Replaces three TPU kernels:
//   * `_assign_kernel` in src/repro/kernels/assign.py: labels = argmin_j
//     (||c_j||^2 - 2 x.c_j), lowest j on ties, and mind = max(best + ||x||^2,
//     0), here over a lane dimension x (M,S,d), c (M,k,d) restricted to the
//     listed lanes (`assign`);
//   * `_update_kernel` in src/repro/kernels/centroid_update.py: the weighted
//     per-cluster sums (k,d) and counts (k,) of given labels, a label outside
//     [0, k) contributing nothing (`centroid_update`);
//   * `_init_sweep_kernel` in src/repro/kernels/init.py: one k-means|| round
//     over x (n,d) against the round's new candidates c (c,d):
//     new_mind = min(old_mind, max(min_j(||c_j||^2 - 2 x.c_j) + ||x||^2, 0)),
//     sampled = u * psi_prev < ell * new_mind and w > 0 and psi_prev > 0,
//     psi = sum(w * new_mind) (`init_sweep`).
//
// What bounds them on this card:
//   * assign and the init sweep: the score product, 2*S*k*d IEEE f32
//     operations against 4*S*d bytes of points (k/2 FLOP a byte; 1,024 at
//     the init sweep's 2,048 candidates, 8,200 at the seeding's weighting
//     assign against about 16,400 candidates), far above the f32 ridge of
//     about 20 FLOP a byte: compute-bound on the f32 FMA pipes (no tensor
//     cores: TF32 would change labels and draws against the reference).
//   * the centroid update: bytes.  It reads each point once (4*d bytes)
//     for d multiply-adds, far below the ridge.
//
// What the design does about it:
//   * scoring is the fused pass's own device code (lloyd_device.cuh):
//     centroid_norms and score_tile<false>, a block of 256 threads owning
//     128 points and walking every centroid in 128-wide tiles with 8x8
//     register blocking.  The assign's labels and distances are therefore
//     the fused pass's bit for bit, at any k (k need not be a multiple of
//     anything: the ragged tile is masked).
//   * the centroid update is the fused pass's accumulate pass without the
//     SSE (lane_segment_sums): one block of 1,024 threads per lane, a
//     stable counting sort of the point indices by label, then one warp per
//     cluster summing its points in increasing point order.  No float
//     atomics: a repeat launch gives the same bits, and the sums are the
//     fused pass's given the same labels.  The cost: a lane's sort runs in
//     one warp of one SM, so one large lane is slow (PERF.md records it).
//   * the init sweep scores its block's rows with score_tile, which writes
//     the candidate minimum; after a barrier the block's first 128 threads
//     fold old_mind, draw and write new_mind and sampled for one row each,
//     and the block's partial potential is a fixed-shape tree.  A second
//     one-block launch sums the partials in a fixed order, so psi needs no
//     float atomics and a repeat launch gives the same bits.  psi_prev is
//     read from device memory, so the launch needs no host copy of it (the
//     seeding loop still waits once a round, for the rows it drew).
//     Invalid candidates get +inf norms and never win; with no candidate
//     (c = 0) the minimum is +inf and mind is left as it was.
//   * every offset into x, c and the per-lane buffers is 64-bit: at the
//     seeding's shapes n*d = 2^29 and k*d is about 1.05M.
//
// Plain C interface, loaded with ctypes: each entry returns the first
// non-zero cudaGetLastError() after its launches, 0 on success.

#include <cuda_runtime.h>
#include <math.h>

#include "lloyd_device.cuh"

namespace {

using lloyd::BM;
using lloyd::NT;
constexpr int NORM_THREADS = 256;
constexpr int UPDATE_THREADS = 1024;
constexpr int PSI_THREADS = 1024;

// ||c_j||^2 of the listed lanes' centroids (lanes == nullptr: lane 0), +inf
// where valid[j] == 0 (valid == nullptr: every centroid is valid)
__global__ void __launch_bounds__(NORM_THREADS)
norms_kernel(const float* __restrict__ c, const int* __restrict__ lanes,
             const unsigned char* __restrict__ valid, int k, int d,
             float* __restrict__ cn) {
  const int g = blockIdx.y;
  const int j0 = blockIdx.x * NORM_THREADS;
  const long long lane = lanes == nullptr ? 0 : lanes[g];
  float* out = cn + (long long)g * k + j0;
  lloyd::centroid_norms<NORM_THREADS>(c + (lane * k + j0) * (long long)d,
                                      min(NORM_THREADS, k - j0), d, out);
  const int j = j0 + threadIdx.x;
  // the thread that wrote out[threadIdx.x] overrides it
  if (valid != nullptr && j < k && valid[j] == 0) out[threadIdx.x] = INFINITY;
}

__global__ void __launch_bounds__(NT, 2)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              const float* __restrict__ cn, const int* __restrict__ lanes,
              int S, int d, int k, int* __restrict__ labels,
              float* __restrict__ mind) {
  __shared__ lloyd::ScoreTiles sm;
  const int g = blockIdx.y;
  const long long lane = lanes[g];
  const long long o = (long long)g * S;
  lloyd::score_tile<false>(x + lane * S * (long long)d,
                           c + lane * k * (long long)d, cn + (long long)g * k,
                           S, d, k, blockIdx.x * BM, sm, labels + o, mind + o,
                           nullptr, nullptr, nullptr, 0);
}

__global__ void __launch_bounds__(UPDATE_THREADS)
update_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const int* __restrict__ lanes, const int* __restrict__ labels,
              int S, int d, int k, int* __restrict__ order,
              float* __restrict__ sums, float* __restrict__ counts) {
  extern __shared__ int smem[];
  lloyd::lane_segment_sums<UPDATE_THREADS>(x, w, lanes, labels, S, d, k,
                                           order, smem, sums, counts);
}

// new_mind is written by score_tile (the candidate minimum) and read back
// after a barrier by other threads of the block: not __restrict__, so no
// load of it goes through the non-coherent cache
__global__ void __launch_bounds__(NT, 2)
init_sweep_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ cn,
                  const float* __restrict__ old_mind,
                  const float* __restrict__ u, const float* __restrict__ w,
                  const float* __restrict__ psi_prev, float ell, int n, int d,
                  int nc, float* new_mind, unsigned char* __restrict__ sampled,
                  float* __restrict__ partial) {
  __shared__ lloyd::ScoreTiles sm;
  __shared__ float red[NT];
  const int row0 = blockIdx.x * BM;
  lloyd::score_tile<false>(x, c, cn, n, d, nc, row0, sm, nullptr, new_mind,
                           nullptr, nullptr, nullptr, 0);
  __syncthreads();
  const int row = row0 + threadIdx.x;
  if (threadIdx.x < BM && row < n) {
    const float pp = *psi_prev;
    const float nm = fminf(old_mind[row], new_mind[row]);
    const float wr = w[row];
    new_mind[row] = nm;
    sampled[row] = (u[row] * pp < ell * nm) && wr > 0.f && pp > 0.f;
  }
  const float total = lloyd::block_weighted_sum<NT>(
      w + row0, new_mind + row0, min(BM, n - row0), red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// psi = the sum of the nb per-block partials: strided sums, then a
// fixed-shape tree, one block
__global__ void __launch_bounds__(PSI_THREADS)
psi_kernel(const float* __restrict__ partial, int nb,
           float* __restrict__ psi) {
  __shared__ float red[PSI_THREADS];
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int i = tid; i < nb; i += PSI_THREADS) s += partial[i];
  red[tid] = s;
  __syncthreads();
  for (int h = PSI_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] += red[tid + h];
    __syncthreads();
  }
  if (tid == 0) psi[0] = red[0];
}

}  // namespace

extern "C" int assign(const float* x, const float* c, const int* lanes,
                      int L, int S, int d, int k, float* cn, int* labels,
                      float* mind, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  norms_kernel<<<dim3((k + NORM_THREADS - 1) / NORM_THREADS, L),
                 NORM_THREADS, 0, stream>>>(c, lanes, nullptr, k, d, cn);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  assign_kernel<<<dim3((S + BM - 1) / BM, L), NT, 0, stream>>>(
      x, c, cn, lanes, S, d, k, labels, mind);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

extern "C" int centroid_update(const float* x, const float* w,
                               const int* lanes, const int* labels, int L,
                               int S, int d, int k, int* order, float* sums,
                               float* counts, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = (2 * (size_t)k + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  update_kernel<<<L, UPDATE_THREADS, smem, stream>>>(x, w, lanes, labels, S,
                                                     d, k, order, sums,
                                                     counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

extern "C" int init_sweep(const float* x, const float* c,
                          const unsigned char* valid, const float* old_mind,
                          const float* u, const float* w,
                          const float* psi_prev, float ell, int n, int d,
                          int nc, float* cn, float* new_mind,
                          unsigned char* sampled, float* partial, float* psi,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (nc > 0) {
    norms_kernel<<<dim3((nc + NORM_THREADS - 1) / NORM_THREADS, 1),
                   NORM_THREADS, 0, stream>>>(c, nullptr, valid, nc, d, cn);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int nb = (n + BM - 1) / BM;
  init_sweep_kernel<<<nb, NT, 0, stream>>>(x, c, cn, old_mind, u, w,
                                           psi_prev, ell, n, d, nc, new_mind,
                                           sampled, partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  psi_kernel<<<1, PSI_THREADS, 0, stream>>>(partial, nb, psi);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}
