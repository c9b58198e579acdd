// Device code shared by the fused Lloyd pass (fused_lloyd.cu), the
// whole-solve kernel (lloyd_solve.cu) and the assign, centroid-update and
// init-sweep kernels (sweeps.cu), so that all of them pick the same labels
// and the same per-cluster sums bit for bit.
//
//   * score_tile: one 128-point tile of a lane scored against all k
//     centroids, register-blocked 8x8 per thread (256 threads), running
//     (best, index) per row, lowest index on ties; optionally the second
//     best score with the assigned column masked (the bound of
//     prune="bounds").  The feature chunks are double-buffered: cp.async
//     copies chunk s + 1 into one buffer while the FMAs of chunk s read the
//     other, one barrier a chunk.  Each thread computes its copy sources
//     once a tile and issues the next chunk's copies after the chunk's
//     first FMA rounds, so that the warps leaving the barrier start on
//     FMAs and not all at once on address arithmetic.  The barrier is a
//     named one, so that two groups of 256 threads of one block (the
//     whole-solve kernel's halves) can score two tiles each at its own
//     pace.  Every score is still the sum over d in increasing order, so
//     the pipeline changes no bit.
//   * segment_sums: the weighted per-cluster sums and counts of a lane from
//     its labels, by a stable counting sort and one warp per cluster
//     summing its points in increasing point order (no float atomics); a
//     label outside [0, k) contributes nothing.  Its steps (label_histogram,
//     scan_counts, stable_scatter, cluster_sums) are separate so that the
//     whole-solve kernel can run them across the blocks of a cluster with
//     the same bits.  lane_segment_sums is the same as the body of a kernel
//     with one block per listed lane, the fused pass's accumulate kernel.
//     The centroid-update kernel (sweeps.cu) spreads the same sort over
//     many blocks and sums with cluster_sums's arithmetic, so its sums are
//     these bit for bit.
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
constexpr int COPY_AT = 4;   // the next chunk's copies go out after this many
                             // of the chunk's 16 FMA rounds

static_assert(BM == BN && NT == 256 && BK == 16 && (BM * BK) % NT == 0,
              "stage_chunk maps thread (tx, ty) to column tx of rows ty + 16q");

// two buffers of a feature chunk: point rows As[b][kk][r] and centroid
// rows Bs[b][kk][c], transposed so that a thread reads its 8 rows and its
// 8 columns as two float4 each
struct ScoreTiles {
  __align__(16) float As[2][BK][BM + PAD];
  __align__(16) float Bs[2][BK][BN + PAD];
};

// 4-byte asynchronous copy from global to shared memory; with pred false it
// reads nothing and writes a zero
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// barrier `id` of the NT threads of one scoring group (id 0 with a block
// of NT threads: __syncthreads)
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NT) : "memory");
}

// Start copying feature chunk [d0, d0 + BK) of the tile's point rows and
// of centroid rows [j0, j0 + BN) into buffer b: thread (tx, ty) of the
// scoring group copies column d0 + tx of rows ty + 16q, q < 8, and zero
// past every edge (the same elements, and the same zeros, as a plain load
// would).  xa points at the thread's first point row (row arow = row0 +
// ty) and cb at the lane's centroid row ty, both at column tx; a copy that
// is masked off reads nothing, whatever its address.
__device__ __forceinline__ void stage_chunk(const float* xa, const float* cb,
                                            int arow, int S, int d, int k,
                                            int j0, int d0, ScoreTiles& sm,
                                            int b) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x % NT / 16;
  const bool cok = d0 + tx < d;
  const long long step = 16LL * d;
  const float* pa = xa + d0;
  const float* pb = cb + (long long)j0 * d + d0;
#pragma unroll
  for (int q = 0; q < BM / 16; ++q) {
    const int r = ty + 16 * q;
    cp_async_f32(&sm.As[b][tx][r], pa + q * step, cok && arow + 16 * q < S);
    cp_async_f32(&sm.Bs[b][tx][r], pb + q * step, cok && j0 + r < k);
  }
}

// ||c_j||^2 for j < k, one thread per centroid, sequential over d (read
// four at a time where the rows are 16-byte aligned)
template <int NTH>
__device__ void centroid_norms(const float* cl, int k, int d, float* cn) {
  const bool vec = (d & 3) == 0 && ((unsigned long long)cl & 15) == 0;
  for (int j = threadIdx.x; j < k; j += NTH) {
    const float* cr = cl + (long long)j * d;
    float s = 0.f;
    int t = 0;
    if (vec) {
#pragma unroll 4
      for (; t < d; t += 4) {
        const float4 v = *reinterpret_cast<const float4*>(cr + t);
        s = fmaf(v.x, v.x, s);
        s = fmaf(v.y, v.y, s);
        s = fmaf(v.z, v.z, s);
        s = fmaf(v.w, v.w, s);
      }
    }
    for (; t < d; ++t) s = fmaf(cr[t], cr[t], s);
    cn[j] = s;
  }
}

// Score rows [row0, row0 + BM) of a lane against its k centroids; rows at
// or past S are masked (S may be a block's own row limit).  Called by the
// NT threads of a scoring group (threads [g NT, (g + 1) NT) of the block,
// meeting at barrier `bar`; a block of NT threads: g = 0, bar = 0); it
// starts with a barrier, so consecutive calls may share one ScoreTiles.
// That barrier is the group's own: it does not order writes to cn (or to
// anything else) made by the block's other group, so the caller puts a
// block barrier between computing the norms and the call.
// For each valid row it writes, where the
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
                           int bb, int bar = 0) {
  const int tid = threadIdx.x % NT;
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

  // steps walk (centroid tile j0, feature chunk d0) with the chunk
  // fastest; a step computes on buffer buf while the next chunk (jn, dn)
  // lands in the other
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // the thread's copy sources, kept for the whole tile
  const int arow = row0 + ty;
  const float* xa = xl + (long long)arow * d + tx;
  const float* cb = cl + (long long)ty * d + tx;

  group_sync(bar);   // every thread of the group is done with both buffers
  stage_chunk(xa, cb, arow, S, d, k, 0, 0, sm, 0);
  cp_async_commit();
  int buf = 0;
  for (int j0 = 0, d0 = 0; j0 < k;) {
    int jn = j0;
    int dn = d0 + BK;
    if (dn >= d) {
      dn = 0;
      jn += BN;
    }
    cp_async_wait_all();
    // this chunk is in buffer buf for every thread, and every thread is
    // done with the previous one, so buffer buf ^ 1 may be refilled; the
    // copies of the next chunk are issued after the first FMAs, so that the
    // group's warps do not all wait on their addresses at once
    group_sync(bar);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk == COPY_AT && jn < k) {
        stage_chunk(xa, cb, arow, S, d, k, jn, dn, sm, buf ^ 1);
        cp_async_commit();
      }
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sm.As[buf][kk][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.As[buf][kk][ty * TM + 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&sm.Bs[buf][kk][tx * TN]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sm.Bs[buf][kk][tx * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    buf ^= 1;
    if (jn != j0) {
      // the last chunk of centroid tile j0: fold it into the running
      // argmin, columns in increasing index, strict < so the first minimum
      // stays
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = j0 + tx * TN + j;
        if (col < k) {
          const float cv = cn[col];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float sc = cv - 2.f * acc[i][j];
            if (sc < best[i]) {
              if (SECOND) second[i] = best[i];
              best[i] = sc;
              bidx[i] = col;
            } else if (SECOND && sc < second[i]) {
              second[i] = sc;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    j0 = jn;
    d0 = dn;
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

// sum_i wl[i] * md[i] over i < S: strided partial sums of the block's first
// NTH threads, then a fixed-shape tree in red[NTH] (the other threads only
// wait at the barriers).  Every thread gets the total.  Starts and ends
// with a barrier, so red may be reused around it.
template <int NTH>
__device__ float block_weighted_sum(const float* __restrict__ wl,
                                    const float* md, int S, float* red) {
  const int tid = threadIdx.x;
  float part = 0.f;
  if (tid < NTH) {
    for (int i = tid; i < S; i += NTH) part = fmaf(wl[i], md[i], part);
  }
  __syncthreads();
  if (tid < NTH) red[tid] = part;
  __syncthreads();
  for (int s = NTH / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// Integer histogram of the labels of rows [lo, hi) into hist (k), which it
// zeroes first; a label outside [0, k) is counted nowhere.  Exact in any
// order.  Called by all NTH threads; ends with a barrier.
template <int NTH>
__device__ void label_histogram(const int* lab, int lo, int hi, int k,
                                int* hist) {
  for (int j = threadIdx.x; j < k; j += NTH) hist[j] = 0;
  __syncthreads();
  for (int i = lo + threadIdx.x; i < hi; i += NTH) {
    const int l = lab[i];
    if ((unsigned)l < (unsigned)k) atomicAdd(&hist[l], 1);
  }
  __syncthreads();
}

// Exclusive scan of cnt (k) into start (k + 1, start[k] the total) and
// cursor[j] = start[j] + off[j] (off == nullptr: + 0), by warp 0 alone, in
// contiguous chunks per lane.  cnt may be start or cursor and off may be
// cursor: each entry is read before it is written.
__device__ void scan_counts(const int* cnt, const int* off, int k, int* start,
                            int* cursor) {
  const int lid = threadIdx.x % 32;
  const int per = (k + 31) / 32;
  const int lo = min(lid * per, k);
  const int hi = min(lo + per, k);
  int run = 0;
  for (int j = lo; j < hi; ++j) run += cnt[j];
  int incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lid >= o) incl += v;
  }
  int pos = incl - run;
  for (int j = lo; j < hi; ++j) {
    const int c = cnt[j];
    const int add = off == nullptr ? 0 : off[j];
    start[j] = pos;
    cursor[j] = pos + add;
    pos += c;
  }
  if (lid == 31) start[k] = incl;
}

// Stable counting sort of rows [lo, hi) by label into ord, 32 rows at a
// time, each label's next slot in cursor (advanced); rows whose label is
// outside [0, k) are left out.  Warp 0 alone.
__device__ void stable_scatter(const int* lab, int lo, int hi, int k,
                               int* cursor, int* ord) {
  const int lid = threadIdx.x % 32;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lid;
    const int raw = i < hi ? lab[i] : -1;
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

// Sums (k, d) and counts (k,) of clusters [jlo, jhi) from the sorted order:
// one warp per cluster, its points in increasing point order, lane l
// summing columns l and l + 32 of each 64-wide chunk.  The warp reads 32
// points' indices and weights at a time and passes them round by shuffle,
// so the loads of the rows do not wait on one another.  Called by all NTH
// threads (no barrier).
template <int NTH>
__device__ void cluster_sums(const float* __restrict__ xl,
                             const float* __restrict__ wl, const int* ord,
                             const int* start, int jlo, int jhi, int d,
                             float* sums, float* counts) {
  const int wid = threadIdx.x / 32;
  const int lid = threadIdx.x % 32;
  for (int j = jlo + wid; j < jhi; j += NTH / 32) {
    const int beg = start[j];
    const int end = start[j + 1];
    float cnt = 0.f;
    for (int t0 = 0; t0 < d; t0 += 64) {
      const int t = t0 + lid;
      const int t2 = t + 32;
      float acc = 0.f;
      float acc2 = 0.f;
      for (int p0 = beg; p0 < end; p0 += 32) {
        const int n = min(32, end - p0);
        const int mi = lid < n ? ord[p0 + lid] : 0;
        const float mw = lid < n ? wl[mi] : 0.f;
#pragma unroll 4
        for (int q = 0; q < n; ++q) {
          const int i = __shfl_sync(0xffffffffu, mi, q);
          const float wi = __shfl_sync(0xffffffffu, mw, q);
          const float* xr = xl + (long long)i * d;
          if (t0 == 0) cnt += wi;
          if (t < d) acc = fmaf(wi, xr[t], acc);
          if (t2 < d) acc2 = fmaf(wi, xr[t2], acc2);
        }
      }
      if (t < d) sums[(long long)j * d + t] = acc;
      if (t2 < d) sums[(long long)j * d + t2] = acc2;
    }
    if (lid == 0) counts[j] = cnt;
  }
}

// Weighted per-cluster sums (k, d) and counts (k,) of a lane from its
// labels.  start (k + 1) and cursor (k) are shared-memory ints, ord an
// (S,) int workspace.  Called by all NTH threads; ends with a barrier.
template <int NTH>
__device__ void segment_sums(const float* __restrict__ xl,
                             const float* __restrict__ wl, const int* lab,
                             int S, int d, int k, int* ord, int* start,
                             int* cursor, float* sums, float* counts) {
  label_histogram<NTH>(lab, 0, S, k, cursor);
  if (threadIdx.x < 32) scan_counts(cursor, nullptr, k, start, cursor);
  __syncthreads();
  if (threadIdx.x < 32) stable_scatter(lab, 0, S, k, cursor, ord);
  __syncthreads();
  cluster_sums<NTH>(xl, wl, ord, start, 0, k, d, sums, counts);
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
