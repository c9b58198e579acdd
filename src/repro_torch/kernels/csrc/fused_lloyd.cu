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
//
// Plain C interface, loaded with ctypes: `fused_lloyd` returns the first
// non-zero cudaGetLastError() after a launch, 0 on success.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 128;   // points per block
constexpr int BN = 128;   // centroids per tile
constexpr int BK = 16;    // feature chunk
constexpr int TM = 8;     // rows per thread
constexpr int TN = 8;     // columns per thread
constexpr int NT = 256;   // threads per block, a 16 x 16 grid of 8x8 tiles
constexpr int PAD = 4;    // shared-row padding against bank conflicts on store
constexpr int ACC_THREADS = 1024;

__global__ void centroid_norms_kernel(const float* __restrict__ c,
                                      const int* __restrict__ lanes,
                                      int k, int d, float* __restrict__ cn) {
  const int g = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const float* cr = c + ((long long)lanes[g] * k + j) * d;
  float s = 0.f;
  for (int t = 0; t < d; ++t) s = fmaf(cr[t], cr[t], s);
  cn[(long long)g * k + j] = s;
}

__global__ void __launch_bounds__(NT, 2)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              const float* __restrict__ cn, const int* __restrict__ lanes,
              int S, int d, int k,
              int* __restrict__ labels, float* __restrict__ mind) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int g = blockIdx.y;
  const long long lane = lanes[g];
  const int row0 = blockIdx.x * BM;
  const float* xl = x + lane * S * (long long)d;
  const float* cl = c + lane * k * (long long)d;
  const float* cnl = cn + (long long)g * k;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    bidx[i] = 0;
  }

  for (int j0 = 0; j0 < k; j0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += BK) {
#pragma unroll
      for (int q = 0; q < (BM * BK) / NT; ++q) {
        const int e = tid + q * NT;
        const int r = e / BK;
        const int kk = e % BK;
        const int col = d0 + kk;
        const int row = row0 + r;
        const int cj = j0 + r;
        As[kk][r] = (row < S && col < d) ? xl[(long long)row * d + col] : 0.f;
        Bs[kk][r] = (cj < k && col < d) ? cl[(long long)cj * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
        const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold this tile into the running argmin: columns in increasing index,
    // strict < so the first minimum stays
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = j0 + tx * TN + j;
      if (col < k) {
        const float cv = cnl[col];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = cv - 2.f * acc[i][j];
          if (s < best[i]) {
            best[i] = s;
            bidx[i] = col;
          }
        }
      }
    }
  }

  // merge the 16 column-owners of each row: lower score, then lower index
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (ov < best[i] || (ov == best[i] && oi < bidx[i])) {
        best[i] = ov;
        bidx[i] = oi;
      }
    }
  }

  float bv = best[0];
  int bi = bidx[0];
#pragma unroll
  for (int i = 1; i < TM; ++i) {
    if (i == tx) {
      bv = best[i];
      bi = bidx[i];
    }
  }
  const int row = row0 + ty * TM + tx;
  if (tx < TM && row < S) {
    const float* xr = xl + (long long)row * d;
    float x2 = 0.f;
    for (int t = 0; t < d; ++t) x2 = fmaf(xr[t], xr[t], x2);
    const long long o = (long long)g * S + row;
    labels[o] = bi;
    mind[o] = fmaxf(bv + x2, 0.f);
  }
}

__global__ void __launch_bounds__(ACC_THREADS)
accumulate_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ lanes,
                  const int* __restrict__ labels,
                  const float* __restrict__ mind, int S, int d, int k,
                  int* __restrict__ order, float* __restrict__ sums,
                  float* __restrict__ counts, float* __restrict__ sse) {
  extern __shared__ int smem[];
  int* start = smem;            // k + 1 segment starts
  int* cursor = smem + k + 1;   // k fill cursors
  __shared__ float red[ACC_THREADS];

  const int g = blockIdx.x;
  const long long lane = lanes[g];
  const int tid = threadIdx.x;
  const int wid = tid / 32;
  const int lid = tid % 32;
  const int* lab = labels + (long long)g * S;
  const float* md = mind + (long long)g * S;
  const float* wl = w + lane * S;
  const float* xl = x + lane * S * (long long)d;
  int* ord = order + (long long)g * S;

  // weighted SSE: strided partial sums, then a fixed-shape tree
  float part = 0.f;
  for (int i = tid; i < S; i += ACC_THREADS) part = fmaf(wl[i], md[i], part);
  red[tid] = part;
  for (int j = tid; j < k; j += ACC_THREADS) cursor[j] = 0;
  __syncthreads();
  for (int s = ACC_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) sse[g] = red[0];

  // integer histogram of labels (exact in any order)
  for (int i = tid; i < S; i += ACC_THREADS) atomicAdd(&cursor[lab[i]], 1);
  __syncthreads();

  // exclusive scan of the histogram by warp 0: contiguous chunks per lane
  if (wid == 0) {
    const int per = (k + 31) / 32;
    const int lo = min(lid * per, k);
    const int hi = min(lo + per, k);
    int run = 0;
    for (int j = lo; j < hi; ++j) run += cursor[j];
    int incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lid >= off) incl += v;
    }
    int pos = incl - run;
    for (int j = lo; j < hi; ++j) {
      const int cnt = cursor[j];
      start[j] = pos;
      cursor[j] = pos;
      pos += cnt;
    }
    if (lid == 31) start[k] = incl;
  }
  __syncthreads();

  // stable counting sort of point indices by label, 32 points at a time
  if (wid == 0) {
    for (int base = 0; base < S; base += 32) {
      const int i = base + lid;
      const bool valid = i < S;
      const int l = valid ? lab[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, l);
      const int rank = __popc(peers & ((1u << lid) - 1u));
      const int first = __ffs(peers) - 1;
      const int at = valid ? cursor[l] : 0;
      __syncwarp();
      if (valid) {
        ord[at + rank] = i;
        if (lid == first) cursor[l] = at + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // one warp per cluster: sums and counts in increasing point order
  for (int j = wid; j < k; j += ACC_THREADS / 32) {
    const int beg = start[j];
    const int end = start[j + 1];
    float cnt = 0.f;
    for (int t0 = 0; t0 < d; t0 += 32) {
      const int t = t0 + lid;
      float acc = 0.f;
      for (int p = beg; p < end; ++p) {
        const int i = ord[p];
        const float wi = wl[i];
        if (t0 == 0) cnt += wi;
        if (t < d) acc = fmaf(wi, xl[(long long)i * d + t], acc);
      }
      if (t < d) sums[((long long)g * k + j) * d + t] = acc;
    }
    if (lid == 0) counts[(long long)g * k + j] = cnt;
  }
}

}  // namespace

extern "C" int fused_lloyd(const float* x, const float* c, const float* w,
                           const int* lanes, int L, int S, int d, int k,
                           float* cn, int* labels, float* mind, int* order,
                           float* sums, float* counts, float* sse,
                           int assign_only, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  centroid_norms_kernel<<<dim3((k + 255) / 256, L), 256, 0, stream>>>(
      c, lanes, k, d, cn);
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
