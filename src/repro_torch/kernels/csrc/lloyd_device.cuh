// Device code shared by the fused Lloyd pass (fused_lloyd.cu), the
// whole-solve kernel (lloyd_solve.cu) and the assign, centroid-update and
// init-sweep kernels (sweeps.cu), so that all of them pick the same labels
// and the same per-cluster sums bit for bit.
//
//   * score_tile: one 128-point tile of a lane scored against all k
//     centroids, register-blocked 8x8 per thread (256 threads), running
//     (best, index) per row, lowest index on ties; optionally the second
//     best score with the assigned column masked (the bound of
//     prune="bounds").
//   * segment_sums: the weighted per-cluster sums and counts of a lane from
//     its labels, by a stable counting sort and one warp per cluster
//     summing its points in increasing point order (no float atomics); a
//     label outside [0, k) contributes nothing.  lane_segment_sums is the
//     same as the body of a kernel with one block per listed lane, shared
//     by the fused pass's accumulate kernel and the centroid-update kernel
//     (sweeps.cu).
//   * block_weighted_sum: the lane's SSE as a fixed-shape tree.
//
// Arrays that the whole-solve kernel writes while it runs (centroids,
// labels, distances) are not marked __restrict__, so that no load of them
// goes through the non-coherent read-only cache.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lloyd {

constexpr int BM = 128;   // points per tile
constexpr int BN = 128;   // centroids per tile
constexpr int BK = 16;    // feature chunk
constexpr int TM = 8;     // rows per thread
constexpr int TN = 8;     // columns per thread
constexpr int NT = 256;   // threads of a scoring block, 16 x 16 8x8 tiles
constexpr int PAD = 4;    // shared-row padding against bank conflicts

struct ScoreTiles {
  __align__(16) float As[BK][BM + PAD];
  __align__(16) float Bs[BK][BN + PAD];
};

// ||c_j||^2 for j < k, one thread per centroid, sequential over d
template <int NTH>
__device__ void centroid_norms(const float* cl, int k, int d, float* cn) {
  for (int j = threadIdx.x; j < k; j += NTH) {
    const float* cr = cl + (long long)j * d;
    float s = 0.f;
    for (int t = 0; t < d; ++t) s = fmaf(cr[t], cr[t], s);
    cn[j] = s;
  }
}

// Score rows [row0, row0 + BM) of a lane against its k centroids.  Called
// by all NT threads of the block.  For each valid row it writes, where the
// pointer is given and the row's pruning block is not skipped
// (skipb == nullptr, or skipb[row / bb] == 0):
//   labels[row] = argmin_j (cn[j] - 2 x.c_j), lowest j on ties;
//   mind[row]   = max(best + ||x||^2, 0);
//   gap[row]    = sqrt(max(second + ||x||^2, 0)) - sqrt(max(best + ||x||^2,
//                 0)) where wl[row] > 0, +inf elsewhere (SECOND only).
template <bool SECOND>
__device__ void score_tile(const float* __restrict__ xl, const float* cl,
                           const float* cn, int S, int d, int k, int row0,
                           ScoreTiles& sm, int* labels, float* mind,
                           float* gap, const float* wl, const int* skipb,
                           int bb) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float best[TM];
  float second[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    second[i] = INFINITY;
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
        sm.As[kk][r] =
            (row < S && col < d) ? xl[(long long)row * d + col] : 0.f;
        sm.Bs[kk][r] =
            (cj < k && col < d) ? cl[(long long)cj * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&sm.As[kk][ty * TM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sm.As[kk][ty * TM + 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&sm.Bs[kk][tx * TN]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sm.Bs[kk][tx * TN + 4]);
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
        const float cv = cn[col];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = cv - 2.f * acc[i][j];
          if (s < best[i]) {
            if (SECOND) second[i] = best[i];
            best[i] = s;
            bidx[i] = col;
          } else if (SECOND && s < second[i]) {
            second[i] = s;
          }
        }
      }
    }
  }

  // merge the 16 column owners of each row: lower score, then lower index;
  // the loser's best competes for the winner's second
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      float os = INFINITY;
      if (SECOND) os = __shfl_xor_sync(0xffffffffu, second[i], off);
      if (ov < best[i] || (ov == best[i] && oi < bidx[i])) {
        if (SECOND) second[i] = fminf(best[i], os);
        best[i] = ov;
        bidx[i] = oi;
      } else if (SECOND) {
        second[i] = fminf(second[i], ov);
      }
    }
  }

  float bv = best[0];
  float sv = second[0];
  int bi = bidx[0];
#pragma unroll
  for (int i = 1; i < TM; ++i) {
    if (i == tx) {
      bv = best[i];
      sv = second[i];
      bi = bidx[i];
    }
  }
  const int row = row0 + ty * TM + tx;
  if (tx < TM && row < S && (skipb == nullptr || skipb[row / bb] == 0)) {
    const float* xr = xl + (long long)row * d;
    float x2 = 0.f;
    for (int t = 0; t < d; ++t) x2 = fmaf(xr[t], xr[t], x2);
    if (labels != nullptr) labels[row] = bi;
    if (mind != nullptr) mind[row] = fmaxf(bv + x2, 0.f);
    if (SECOND) {
      gap[row] = wl[row] > 0.f ? sqrtf(fmaxf(sv + x2, 0.f)) -
                                     sqrtf(fmaxf(bv + x2, 0.f))
                               : INFINITY;
    }
  }
}

// sum_i wl[i] * md[i] over i < S: strided partial sums, then a fixed-shape
// tree in red[NTH].  Every thread gets the total.  Starts and ends with a
// barrier, so red may be reused around it.
template <int NTH>
__device__ float block_weighted_sum(const float* __restrict__ wl,
                                    const float* md, int S, float* red) {
  const int tid = threadIdx.x;
  float part = 0.f;
  for (int i = tid; i < S; i += NTH) part = fmaf(wl[i], md[i], part);
  __syncthreads();
  red[tid] = part;
  __syncthreads();
  for (int s = NTH / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// Weighted per-cluster sums (k, d) and counts (k,) of a lane from its
// labels.  start (k + 1) and cursor (k) are shared-memory ints, ord an
// (S,) int workspace.  Called by all NTH threads; ends with a barrier.
template <int NTH>
__device__ void segment_sums(const float* __restrict__ xl,
                             const float* __restrict__ wl, const int* lab,
                             int S, int d, int k, int* ord, int* start,
                             int* cursor, float* sums, float* counts) {
  const int tid = threadIdx.x;
  const int wid = tid / 32;
  const int lid = tid % 32;

  for (int j = tid; j < k; j += NTH) cursor[j] = 0;
  __syncthreads();

  // integer histogram of labels (exact in any order); a label outside
  // [0, k) is counted nowhere, so its point is left out of the sort
  for (int i = tid; i < S; i += NTH) {
    const int l = lab[i];
    if ((unsigned)l < (unsigned)k) atomicAdd(&cursor[l], 1);
  }
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
      const int raw = i < S ? lab[i] : -1;
      const bool valid = (unsigned)raw < (unsigned)k;
      const int l = valid ? raw : -1;
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
  for (int j = wid; j < k; j += NTH / 32) {
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
      if (t < d) sums[(long long)j * d + t] = acc;
    }
    if (lid == 0) counts[j] = cnt;
  }
  __syncthreads();
}

// segment_sums as the body of a kernel with one block per listed lane:
// block g sums lane lanes[g] of x (M,S,d) and w (M,S) by row g of labels
// (L,S) into row g of sums (L,k,d) and counts (L,k).  order is an (L,S) int
// workspace; smem holds 2k + 1 ints of dynamic shared memory.
template <int NTH>
__device__ void lane_segment_sums(const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  const int* __restrict__ lanes,
                                  const int* __restrict__ labels, int S,
                                  int d, int k, int* __restrict__ order,
                                  int* smem, float* __restrict__ sums,
                                  float* __restrict__ counts) {
  const long long g = blockIdx.x;
  const long long lane = lanes[g];
  segment_sums<NTH>(x + lane * S * (long long)d, w + lane * S, labels + g * S,
                    S, d, k, order + g * S, smem, smem + k + 1,
                    sums + g * k * (long long)d, counts + g * k);
}

}  // namespace lloyd
