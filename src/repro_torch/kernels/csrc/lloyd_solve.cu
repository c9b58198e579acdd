// Whole Lloyd solve of every lane of a subset stack in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels `_batched_kernel` in
// src/repro/kernels/batch_resident.py (the whole solve of a stack of
// subsets, a group of T lanes per grid step) and `_resident_kernel` in
// src/repro/kernels/resident.py (the same for one subset): the convergence
// loop with per-lane trip counts and freeze, keep-old division, the
// in-loop farthest-point reseed of empty clusters, the optional bound-gated
// block skip (prune="bounds"), and a final scoring pass for the SSE.  The
// resident solve is this kernel with one lane.
//
// What bounds it on this card: the score product.  A trip of one lane does
// 2*S*k*d IEEE f32 operations (2.1 GFLOP at S = 16384, k = 1024, d = 64)
// against 4*S*d bytes of points, far above the f32 ridge of about 20 FLOP
// a byte, so it is compute-bound on the f32 FMA pipes (no tensor cores:
// TF32 would change labels against the reference).
//
// What the design does about it, and what it gives up:
//   * one thread block (256 threads) per lane runs that lane's whole solve,
//     with no host between trips.  One lane's points (4 MB) and its (k, d)
//     accumulator (256 KB) do not fit a block's shared memory, so they
//     stream from device memory or L2 on every trip; centroids, sums,
//     counts, labels, distances and the sort order live in a per-lane
//     workspace that the wrapper allocates.  A lane that stops leaves its
//     loop, the TPU kernel's `where(active, ...)` freeze without the wasted
//     work.  The cost: a lane's solve runs on one SM, so a stack takes as
//     long as its slowest lanes on the SMs they land on.
//   * the score pass and the segment-sum are the fused pass's own device
//     code (lloyd_device.cuh): the same 8x8 register-blocked tiles, the
//     same lowest-index tie-break, the same stable counting sort and
//     point-order per-cluster sums.  A lane therefore follows the fused
//     engine's host loop label for label and sum for sum.  No float
//     atomics: a repeat launch gives the same bits, and a lane of a stack
//     gives the same bits as the same lane launched alone.
//   * reseed (reseed_empty): when a trip leaves a cluster empty, one more
//     score pass against the updated centroids gives each point's distance;
//     the e-th empty cluster in index order then takes the e-th farthest
//     point of positive weight (block-wide argmax by (distance desc, row
//     asc), the taken row excluded), while e < min(k, S) and the distance
//     is finite: the semantics of ref.reseed_rows.
//   * bounds (template flag BOUNDS): the score pass also keeps the second
//     best score with the assigned column masked; a pruning block of bb rows
//     keeps its margin min(d2 - d1) and the drift accumulated since it was
//     scored, and is skipped while margin > 2 * drift.  Skipped rows keep
//     their cached labels; the segment-sum runs over all labels either way,
//     so the pruned solve is bit-for-bit the exact one.  Skip counters are
//     integer atomics, summed over lanes, per trip.
//   * division, sqrt and the stop test are IEEE f32 (no fast-math flags).
//
// Plain C interface, loaded with ctypes: `lloyd_solve` returns the first
// non-zero CUDA error of the launch, 0 on success.

#include <cuda_runtime.h>
#include <math.h>

#include "lloyd_device.cuh"

namespace {

using lloyd::BM;
using lloyd::NT;

// argmax of score[0, S) by (value desc, row asc), into (val, row) for every
// thread of the block.  Starts and ends with a barrier.
__device__ void block_argmax(const float* score, int S, float* wv, int* wr,
                             float& val, int& row) {
  const int tid = threadIdx.x;
  const int wid = tid / 32;
  const int lid = tid % 32;
  float bv = -INFINITY;
  int br = S;
  __syncthreads();
  for (int i = tid; i < S; i += NT) {
    const float v = score[i];
    if (v > bv || (v == bv && i < br)) {
      bv = v;
      br = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int orow = __shfl_xor_sync(0xffffffffu, br, off);
    if (ov > bv || (ov == bv && orow < br)) {
      bv = ov;
      br = orow;
    }
  }
  if (lid == 0) {
    wv[wid] = bv;
    wr[wid] = br;
  }
  __syncthreads();
  if (wid == 0) {
    bv = lid < NT / 32 ? wv[lid] : -INFINITY;
    br = lid < NT / 32 ? wr[lid] : S;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int orow = __shfl_xor_sync(0xffffffffu, br, off);
      if (ov > bv || (ov == bv && orow < br)) {
        bv = ov;
        br = orow;
      }
    }
    if (lid == 0) {
      wv[0] = bv;
      wr[0] = br;
    }
  }
  __syncthreads();
  val = wv[0];
  row = wr[0];
  __syncthreads();
}

// One block per lane.  Dynamic shared memory: start (k + 1) and cursor (k)
// of the counting sort, the centroid norms (k), and under BOUNDS one skip
// flag per pruning block (nb).
template <bool BOUNDS>
__global__ void __launch_bounds__(NT, 2)
solve_kernel(const float* __restrict__ x, const float* __restrict__ c0,
             const float* __restrict__ w, int S, int d, int k, int max_iters,
             float tol, int reseed, int bb, int nb, float* c, int* labels,
             float* mind, float* gap, int* order, float* sums, float* counts,
             float* margin, float* dacc, float* sse, int* iters, int* conv,
             int* passes, int* skips) {
  __shared__ lloyd::ScoreTiles sm;
  __shared__ float red[NT];
  __shared__ float wv[NT / 32];
  __shared__ int wr[NT / 32];
  extern __shared__ int dyn[];
  int* start = dyn;
  int* cursor = dyn + k + 1;
  float* cn = reinterpret_cast<float*>(dyn + 2 * k + 1);
  int* skipb = dyn + 3 * k + 1;

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const long long kd = (long long)k * d;
  const float* xl = x + g * S * (long long)d;
  const float* wl = w + g * S;
  float* cl = c + g * kd;
  int* lab = labels + g * S;
  float* md = mind + g * S;
  float* gp = BOUNDS ? gap + g * S : nullptr;
  int* ord = order + g * S;
  float* sl = sums + g * kd;
  float* cnt = counts + g * k;
  float* mg = BOUNDS ? margin + g * nb : nullptr;
  float* da = BOUNDS ? dacc + g * nb : nullptr;
  const int ntiles = (S + BM - 1) / BM;
  const int kk = min(k, S);   // reseed candidates, S the padded capacity

  for (long long e = tid; e < kd; e += NT) cl[e] = c0[e];
  if (BOUNDS) {
    for (int b = tid; b < nb; b += NT) {
      mg[b] = -INFINITY;   // a fresh block is always scored
      da[b] = 0.f;
    }
  }
  __syncthreads();

  int it = 0;
  int npass = 0;
  float shift = INFINITY;
  while (it < max_iters && shift > tol) {
    lloyd::centroid_norms<NT>(cl, k, d, cn);
    if (BOUNDS) {
      for (int b = tid; b < nb; b += NT) skipb[b] = mg[b] > 2.f * da[b];
    }
    __syncthreads();

    // the trip's score pass: labels (and under BOUNDS the gaps) of every
    // row whose pruning block is not skipped
    for (int t = 0; t < ntiles; ++t) {
      const int r0 = t * BM;
      if (BOUNDS) {
        const int b1 = (min(r0 + BM, S) - 1) / bb;
        bool live = false;
        for (int b = r0 / bb; b <= b1; ++b) live = live || skipb[b] == 0;
        if (!live) continue;
      }
      lloyd::score_tile<BOUNDS>(xl, cl, cn, S, d, k, r0, sm, lab, nullptr,
                                gp, wl, BOUNDS ? skipb : nullptr, bb);
    }
    __syncthreads();
    int nskip = 0;
    if (BOUNDS) {
      for (int b = tid; b < nb; b += NT) {
        if (skipb[b]) continue;
        const int hi = min((b + 1) * bb, S);
        float m = INFINITY;
        for (int r = b * bb; r < hi; ++r) m = fminf(m, gp[r]);
        mg[b] = m;
      }
      if (tid == 0) {
        for (int b = 0; b < nb; ++b) nskip += skipb[b];
      }
    }

    lloyd::segment_sums<NT>(xl, wl, lab, S, d, k, ord, start, cursor, sl,
                            cnt);

    // keep-old division in place; thread tid owns rows j = tid (mod NT) and
    // the largest movement among them
    float tmax = 0.f;
    int empty = 0;
    for (int j = tid; j < k; j += NT) {
      const float n = cnt[j];
      if (n > 0.f) {
        float acc = 0.f;
        for (int t = 0; t < d; ++t) {
          const long long e = (long long)j * d + t;
          const float nv = sl[e] / fmaxf(n, 1.f);
          const float df = nv - cl[e];
          acc = fmaf(df, df, acc);
          cl[e] = nv;
        }
        tmax = fmaxf(tmax, sqrtf(acc));
      } else {
        empty = 1;
      }
    }

    if (__syncthreads_or(reseed && empty)) {
      // distances to the updated centroids; rows of zero weight score -inf
      lloyd::centroid_norms<NT>(cl, k, d, cn);
      __syncthreads();
      for (int t = 0; t < ntiles; ++t) {
        lloyd::score_tile<false>(xl, cl, cn, S, d, k, t * BM, sm, nullptr,
                                 md, nullptr, nullptr, nullptr, 0);
      }
      __syncthreads();
      for (int i = tid; i < S; i += NT) {
        if (!(wl[i] > 0.f)) md[i] = -INFINITY;
      }
      int e = 0;
      for (int j = 0; j < k && e < kk; ++j) {
        if (!(cnt[j] <= 0.f)) continue;
        float v;
        int r;
        block_argmax(md, S, wv, wr, v, r);
        // not finite: every later pick would be no better
        if (!(v > -INFINITY && v < INFINITY)) break;
        const float* xr = xl + (long long)r * d;
        float* cj = cl + (long long)j * d;
        if (tid == 0) {
          float acc = 0.f;
          for (int t = 0; t < d; ++t) {
            const float df = xr[t] - cj[t];
            acc = fmaf(df, df, acc);
          }
          tmax = fmaxf(tmax, sqrtf(acc));
          md[r] = -INFINITY;
        }
        __syncthreads();
        for (int t = tid; t < d; t += NT) cj[t] = xr[t];
        ++e;
      }
      ++npass;
    }

    // the trip's shift: max over the block of the per-thread movements
    red[tid] = tmax;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] = fmaxf(red[tid], red[tid + s]);
      __syncthreads();
    }
    shift = red[0];
    if (BOUNDS) {
      for (int b = tid; b < nb; b += NT) {
        da[b] = skipb[b] ? da[b] + shift : shift;
      }
      if (tid == 0) {
        atomicAdd(&skips[2 * it], nskip);
        atomicAdd(&skips[2 * it + 1], nb);
      }
    }
    ++it;
    ++npass;
    __syncthreads();
  }

  // final statistics with the converged centroids
  lloyd::centroid_norms<NT>(cl, k, d, cn);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    lloyd::score_tile<false>(xl, cl, cn, S, d, k, t * BM, sm, nullptr, md,
                             nullptr, nullptr, nullptr, 0);
  }
  __syncthreads();
  const float total = lloyd::block_weighted_sum<NT>(wl, md, S, red);
  if (tid == 0) {
    sse[g] = total;
    iters[g] = it;
    conv[g] = shift <= tol ? 1 : 0;
    passes[g] = npass + 1;
  }
}

template <bool BOUNDS>
int launch(const float* x, const float* c0, const float* w, int M, int S,
           int d, int k, int max_iters, float tol, int reseed, int bb, int nb,
           float* c, int* labels, float* mind, float* gap, int* order,
           float* sums, float* counts, float* margin, float* dacc, float* sse,
           int* iters, int* conv, int* passes, int* skips,
           cudaStream_t stream) {
  const size_t smem = (3 * (size_t)k + 1 + (BOUNDS ? nb : 0)) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      solve_kernel<BOUNDS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  solve_kernel<BOUNDS><<<M, NT, smem, stream>>>(
      x, c0, w, S, d, k, max_iters, tol, reseed, bb, nb, c, labels, mind,
      gap, order, sums, counts, margin, dacc, sse, iters, conv, passes,
      skips);
  return (int)cudaGetLastError();
}

}  // namespace

// bb > 0 turns on prune="bounds" with pruning blocks of bb rows, nb of them
// a lane; gap, margin and dacc may be null otherwise.
extern "C" int lloyd_solve(const float* x, const float* c0, const float* w,
                           int M, int S, int d, int k, int max_iters,
                           float tol, int reseed, int bb, int nb, float* c,
                           int* labels, float* mind, float* gap, int* order,
                           float* sums, float* counts, float* margin,
                           float* dacc, float* sse, int* iters, int* conv,
                           int* passes, int* skips, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bb > 0) {
    return launch<true>(x, c0, w, M, S, d, k, max_iters, tol, reseed, bb, nb,
                        c, labels, mind, gap, order, sums, counts, margin,
                        dacc, sse, iters, conv, passes, skips, stream);
  }
  return launch<false>(x, c0, w, M, S, d, k, max_iters, tol, reseed, 0, 0, c,
                       labels, mind, gap, order, sums, counts, margin, dacc,
                       sse, iters, conv, passes, skips, stream);
}
