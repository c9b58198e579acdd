// The stable counting sort by label and the per-cluster sums of a stack
// of lanes, spread over the whole card: the centroid-update kernel
// (sweeps.cu, `centroid_update`) and the fused Lloyd step's accumulate
// (fused_lloyd.cu) both launch it through `segment_sums` below, so the two
// give the same sums and counts bit for bit on the same labels.
//
// Each listed lane is cut into chunks of C rows (C a multiple of 32, chosen
// by the wrapper, `centroid_update.chunk_plan`, so that lanes x chunks gives
// every SM at least four blocks), and six launches on the caller's stream
// do the rest:
//   1. histogram (lanes x chunks blocks): each chunk counts its labels in
//      shared memory, with one int atomic per distinct label of a warp's 32
//      rows (exact in any order), into hist (L, chunks, k);
//   2. chunk prefix (columns x segments x lanes): per cluster, the exclusive
//      prefix of the chunks' counts inside each segment of CHUNK_SEG
//      chunks, in place, and each segment's total;
//   3. segment prefix (columns x lanes): per cluster, the exclusive prefix
//      of the segments' totals, in place, and the cluster's total; then
//      lane start (one block a lane): start[j] (k + 1), the exclusive scan
//      of the totals in cluster order.  All integer: chunk c's first slot
//      for cluster j is start[j] plus the counts of j in chunks before c,
//      exactly;
//   4. scatter (lanes x chunks blocks): one warp scatters its chunk's rows
//      from those slots, 32 rows a step, ranked by __match_any_sync, with
//      the labels of 8 steps loaded ahead;
//   5. sums ((k / 8) x lanes blocks of 8 warps): one warp per (lane,
//      cluster) sums its rows in increasing point order with
//      lloyd::cluster_sums's FMA order (columns t and t + 32 of each
//      64-wide chunk), loading 8 rows ahead, with no branch around the
//      FMAs.
// A stable sort by label is unique, so the order does not depend on C, and
// the sums are cluster_sums's (the whole-solve kernel's) given the same
// labels.  No float atomics: a repeat launch gives the same bits.  A label
// outside [0, k) contributes nothing.  What bounds it is bytes (each point
// read once, 4*d bytes for d multiply-adds, far below the f32 ridge).  The
// limit that the bits impose: a cluster that holds most of a lane is summed
// by one warp in point order (about 100 ns a row on the H100, PERF.md).
// k is at most 232,448 / 4 = 58,112 on the H100: the histogram and scatter
// passes keep k counts in one block's shared memory.
//
// bfloat16 accumulate (bn > 0, KernelSpec.acc_dtype="bfloat16"): the sum
// pass rounds each point and weight to bfloat16, and cuts each cluster's
// rows, in point order, at every multiple of bn rows of the lane (the
// reference's blocks of bn rows): the weighted partial sum of a block is
// summed in f32, rounded to bfloat16, and the partials are added in f32 in
// block order; the counts are the blocks' f32 partials added in block
// order.  bn = 0 is the f32 pass, whose code and bits are unchanged.

#pragma once

#include <cuda_runtime.h>

#include "lloyd_device.cuh"

namespace {

constexpr int CHUNK_SEG = 16;          // chunks per segment of the prefix pass
constexpr int HIST_THREADS = 256;
constexpr int COLUMN_THREADS = 256;
constexpr int START_THREADS = 1024;
constexpr int SCATTER_THREADS = 128;   // all load the cursors, warp 0 scatters
constexpr int SCATTER_AHEAD = 8;       // 32-row steps loaded at once
constexpr int SUM_THREADS = 256;       // 8 warps, 8 clusters a block
constexpr int SUM_AHEAD = 8;           // rows a warp loads at once
// a cluster of more rows than this prefetches each next 32-row group into
// L2: its warp outlasts the pass, so latency, not bandwidth, bounds it (with
// many warps in flight the prefetches only add L2 traffic)
constexpr int PREFETCH_ROWS = 1024;
static_assert(32 % SUM_AHEAD == 0, "a batch of rows stays inside one 32-row "
                                   "group of the order");

// 1. hist[g][c][j]: rows of chunk c of row g of labels labelled j; a label
// outside [0, k) is counted nowhere.  Dynamic shared memory: k ints.
__global__ void __launch_bounds__(HIST_THREADS)
update_histogram_kernel(const int* __restrict__ labels, int S, int k,
                        int C, int* __restrict__ hist) {
  extern __shared__ int cnt[];
  const int c = blockIdx.x;
  const long long g = blockIdx.y;
  const int lid = threadIdx.x % 32;
  const int lo = c * C;
  const int hi = min(lo + C, S);
  const int* lab = labels + g * S;
  for (int j = threadIdx.x; j < k; j += HIST_THREADS) cnt[j] = 0;
  __syncthreads();
  // base is the same for the 32 threads of a warp, so all of them take
  // part in every __match_any_sync
  for (int base = lo + (int)threadIdx.x - lid; base < hi;
       base += HIST_THREADS) {
    const int i = base + lid;
    const int raw = i < hi ? lab[i] : -1;
    const int l = (unsigned)raw < (unsigned)k ? raw : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, l);
    if (l >= 0 && lid == __ffs(peers) - 1) atomicAdd(&cnt[l], __popc(peers));
  }
  __syncthreads();
  int* out = hist + (g * gridDim.x + c) * (long long)k;
  for (int j = threadIdx.x; j < k; j += HIST_THREADS) out[j] = cnt[j];
}

// 2. Per cluster j (one thread) and segment p of CHUNK_SEG chunks: hist's
// column j over the segment's chunks becomes its exclusive prefix, and
// seg[g][p][j] the segment's total.
__global__ void __launch_bounds__(COLUMN_THREADS)
update_prefix_kernel(int* __restrict__ hist, int chunks, int k,
                     int* __restrict__ seg) {
  const int j = blockIdx.x * COLUMN_THREADS + threadIdx.x;
  const int p = blockIdx.y;
  const long long g = blockIdx.z;
  if (j >= k) return;
  const int c0 = p * CHUNK_SEG;
  const int n = min(CHUNK_SEG, chunks - c0);
  int* col = hist + (g * chunks + c0) * (long long)k + j;
  int h[CHUNK_SEG];
#pragma unroll
  for (int u = 0; u < CHUNK_SEG; ++u) h[u] = u < n ? col[(long long)u * k] : 0;
  int run = 0;
#pragma unroll
  for (int u = 0; u < CHUNK_SEG; ++u) {
    if (u < n) col[(long long)u * k] = run;
    run += h[u];
  }
  seg[(g * gridDim.y + p) * (long long)k + j] = run;
}

// exclusive scan of v over the block's NTH threads, in thread order; red
// holds NTH / 32 ints.  Called by all threads; ends with a barrier.
template <int NTH>
__device__ int block_exclusive_scan(int v, int* red) {
  const int lid = threadIdx.x % 32;
  const int wid = threadIdx.x / 32;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lid >= o) incl += t;
  }
  if (lid == 31) red[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int tot = lid < NTH / 32 ? red[lid] : 0;
    int wincl = tot;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wincl, o);
      if (lid >= o) wincl += t;
    }
    if (lid < NTH / 32) red[lid] = wincl - tot;
  }
  __syncthreads();
  const int out = red[wid] + incl - v;
  __syncthreads();
  return out;
}

// 3a. Per cluster j (one thread): seg's column j over the segments becomes
// its exclusive prefix, and start[g][j] the cluster's total.
__global__ void __launch_bounds__(COLUMN_THREADS)
update_segscan_kernel(int* __restrict__ seg, int segs, int k,
                      int* __restrict__ start) {
  const int j = blockIdx.x * COLUMN_THREADS + threadIdx.x;
  const long long g = blockIdx.y;
  if (j >= k) return;
  int* col = seg + g * segs * (long long)k + j;
  int run = 0;
  for (int p0 = 0; p0 < segs; p0 += CHUNK_SEG) {
    const int n = min(CHUNK_SEG, segs - p0);
    int h[CHUNK_SEG];
#pragma unroll
    for (int u = 0; u < CHUNK_SEG; ++u)
      h[u] = u < n ? col[(long long)(p0 + u) * k] : 0;
#pragma unroll
    for (int u = 0; u < CHUNK_SEG; ++u) {
      if (u < n) col[(long long)(p0 + u) * k] = run;
      run += h[u];
    }
  }
  start[g * (k + 1) + j] = run;
}

// 3b. One block a lane: start[g] (k + 1 entries) becomes the exclusive scan
// of the clusters' totals, start[k] the rows with a valid label.  Thread t
// owns the contiguous clusters [lo, hi).
__global__ void __launch_bounds__(START_THREADS)
update_start_kernel(int k, int* __restrict__ start) {
  __shared__ int red[START_THREADS / 32];
  int* st = start + blockIdx.x * (long long)(k + 1);
  const int per = (k + START_THREADS - 1) / START_THREADS;
  const int lo = min((int)threadIdx.x * per, k);
  const int hi = min(lo + per, k);
  int run = 0;
  for (int j = lo; j < hi; ++j) run += st[j];
  int pos = block_exclusive_scan<START_THREADS>(run, red);
  for (int j = lo; j < hi; ++j) {
    const int v = st[j];
    st[j] = pos;
    pos += v;
  }
  if (threadIdx.x == START_THREADS - 1) st[k] = pos;
}

// 4. Chunk c of row g: each label's first slot is start[g][j] +
// seg[g][c / CHUNK_SEG][j] + hist[g][c][j] (cursor, in shared memory: k
// ints); warp 0 scatters the chunk's rows in order, 32 a step, as
// stable_scatter does.
__global__ void __launch_bounds__(SCATTER_THREADS)
update_scatter_kernel(const int* __restrict__ labels,
                      const int* __restrict__ hist,
                      const int* __restrict__ seg,
                      const int* __restrict__ start, int S, int k, int C,
                      int segs, int* __restrict__ order) {
  extern __shared__ int cursor[];
  const int c = blockIdx.x;
  const long long g = blockIdx.y;
  const int* hc = hist + (g * gridDim.x + c) * (long long)k;
  const int* sc = seg + (g * segs + c / CHUNK_SEG) * (long long)k;
  const int* st = start + g * (k + 1);
  for (int j = threadIdx.x; j < k; j += SCATTER_THREADS)
    cursor[j] = st[j] + sc[j] + hc[j];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lid = threadIdx.x;
  const int lo = c * C;
  const int hi = min(lo + C, S);
  const int* lab = labels + g * S;
  int* ord = order + g * S;
  for (int base = lo; base < hi; base += 32 * SCATTER_AHEAD) {
    int raw[SCATTER_AHEAD];
#pragma unroll
    for (int u = 0; u < SCATTER_AHEAD; ++u) {
      const int i = base + 32 * u + lid;
      raw[u] = i < hi ? lab[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < SCATTER_AHEAD; ++u) {
      const int i = base + 32 * u + lid;
      const bool valid = (unsigned)raw[u] < (unsigned)k;
      const int l = valid ? raw[u] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, l);
      const int rank = __popc(peers & ((1u << lid) - 1u));
      const int at = valid ? cursor[l] : 0;
      __syncwarp();
      if (valid) {
        ord[at + rank] = i;
        if (lid == __ffs(peers) - 1) cursor[l] = at + __popc(peers);
      }
      __syncwarp();
    }
  }
}

// 5. One warp per (row g, cluster j): lloyd::cluster_sums's arithmetic for
// one cluster (cnt += w_i and acc = fmaf(w_i, x_i[t], acc) over its rows in
// increasing point order, columns t and t + 32 of each 64-wide chunk), with
// the columns of SUM_AHEAD rows loaded before their FMAs and the next
// 32-row group's indices, weights and (past PREFETCH_ROWS) rows one group
// ahead.  The FMAs take no branch: a row past the cluster's end enters as
// w = 0 and x = 0, and fmaf(0, 0, acc) is acc (acc is never -0: it starts
// at +0, and a sum that is exactly zero rounds to +0), so the bits are
// cluster_sums's.
// BF16 (bn > 0): the bfloat16 accumulate of the header; a block change is
// the same for the whole warp (every lane reads the same row), so the
// flushes do not diverge, and a row past the cluster's end starts no block.
template <bool BF16>
__global__ void __launch_bounds__(SUM_THREADS)
update_sum_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ lanes,
                  const int* __restrict__ order,
                  const int* __restrict__ start, int S, int d, int k, int bn,
                  float* __restrict__ sums, float* __restrict__ counts) {
  const int j = blockIdx.x * (SUM_THREADS / 32) + threadIdx.x / 32;
  if (j >= k) return;
  const long long g = blockIdx.y;
  const long long lane = lanes[g];
  const float* xl = x + lane * S * (long long)d;
  const float* wl = w + lane * S;
  const int* ord = order + g * S;
  const int beg = start[g * (k + 1) + j];
  const int end = start[g * (k + 1) + j + 1];
  float* srow = sums + (g * k + j) * (long long)d;
  const int lid = threadIdx.x % 32;
  const bool big = end - beg > PREFETCH_ROWS;
  for (int t0 = 0; t0 < d; t0 += 64) {
    const int t = t0 + lid;
    const int t2 = t + 32;
    const bool ok = t < d;
    const bool ok2 = t2 < d;
    float acc = 0.f;
    float acc2 = 0.f;
    float cnt = 0.f;
    // BF16: the finished blocks' totals, and the block acc/acc2/cnt sum
    float tot = 0.f;
    float tot2 = 0.f;
    float ctot = 0.f;
    int cur = -1;
    // indices two groups ahead; weights and (in a big cluster) rows one
    int n = min(32, end - beg);
    int mi = lid < n ? ord[beg + lid] : 0;
    float mw = lid < n ? wl[mi] : 0.f;
    int n1 = min(32, end - beg - 32);
    int mi1 = lid < n1 ? ord[beg + 32 + lid] : 0;
    for (int p0 = beg; p0 < end; p0 += 32) {
      const int n2 = min(32, end - p0 - 64);
      const int mi2 = lid < n2 ? ord[p0 + 64 + lid] : 0;
      if (big && lid < n1) {
        const float* pr = xl + (long long)mi1 * d + t0;
        asm volatile("prefetch.global.L2 [%0];" ::"l"(pr));
        if (ok2) asm volatile("prefetch.global.L2 [%0];" ::"l"(pr + 32));
      }
      const float mw1 = lid < n1 ? wl[mi1] : 0.f;
      for (int q0 = 0; q0 < n; q0 += SUM_AHEAD) {
        float v[SUM_AHEAD], v2[SUM_AHEAD];
        int blk[SUM_AHEAD];
#pragma unroll
        for (int u = 0; u < SUM_AHEAD; ++u) {
          const int q = q0 + u;
          const int i = __shfl_sync(0xffffffffu, mi, q);
          const float* xr = xl + (long long)i * d;
          v[u] = q < n && ok ? xr[t] : 0.f;
          v2[u] = q < n && ok2 ? xr[t2] : 0.f;
          if (BF16) {
            v[u] = lloyd::round_bf16(v[u]);
            v2[u] = lloyd::round_bf16(v2[u]);
            blk[u] = q < n ? i / bn : -1;
          }
        }
#pragma unroll
        for (int u = 0; u < SUM_AHEAD; ++u) {
          float wi = __shfl_sync(0xffffffffu, mw, q0 + u);
          if (BF16) {
            if (blk[u] >= 0 && blk[u] != cur) {
              tot += lloyd::round_bf16(acc);
              tot2 += lloyd::round_bf16(acc2);
              ctot += cnt;
              acc = acc2 = cnt = 0.f;
              cur = blk[u];
            }
            wi = lloyd::round_bf16(wi);
          }
          cnt += wi;
          acc = fmaf(wi, v[u], acc);
          acc2 = fmaf(wi, v2[u], acc2);
        }
      }
      n = n1;
      mi = mi1;
      mw = mw1;
      n1 = n2;
      mi1 = mi2;
    }
    if (BF16) {
      acc = tot + lloyd::round_bf16(acc);
      acc2 = tot2 + lloyd::round_bf16(acc2);
      cnt = ctot + cnt;
    }
    if (ok) srow[t] = acc;
    if (ok2) srow[t2] = acc2;
    if (t0 == 0 && lid == 0) counts[g * k + j] = cnt;
  }
}

// The six passes over the listed lanes: chunks of C rows (C a multiple of
// 32; chunks = ceil(S / C) and segs = ceil(chunks / CHUNK_SEG), checked
// here) and the workspaces hist (L, chunks, k), seg (L, segs, k), start
// (L, k + 1) and order (L, S) ints, all from the caller.  Row g of labels
// (L, S) sorts lane lanes[g] of x (M, S, d) and w (M, S) into row g of sums
// (L, k, d) and counts (L, k); bn > 0 is the bfloat16 accumulate over
// blocks of bn rows.  Returns the first error of a launch.
cudaError_t segment_sums(const float* x, const float* w, const int* lanes,
                         const int* labels, int L, int S, int d, int k,
                         int C, int chunks, int segs, int* hist, int* seg,
                         int* start, int* order, float* sums, float* counts,
                         int bn, cudaStream_t stream) {
  if (L < 1 || L > 65535 || S < 1 || d < 1 || k < 1 || C < 32 || C % 32 != 0
      || bn < 0
      || (long long)chunks != ((long long)S + C - 1) / C
      || segs != (chunks + CHUNK_SEG - 1) / CHUNK_SEG || segs > 65535)
    return cudaErrorInvalidValue;
  const int smem = k * (int)sizeof(int);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(update_histogram_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(update_scatter_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  update_histogram_kernel<<<dim3(chunks, L), HIST_THREADS, smem, stream>>>(
      labels, S, k, C, hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  update_prefix_kernel<<<dim3((k + COLUMN_THREADS - 1) / COLUMN_THREADS, segs,
                              L),
                         COLUMN_THREADS, 0, stream>>>(hist, chunks, k, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  update_segscan_kernel<<<dim3((k + COLUMN_THREADS - 1) / COLUMN_THREADS, L),
                          COLUMN_THREADS, 0, stream>>>(seg, segs, k, start);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  update_start_kernel<<<L, START_THREADS, 0, stream>>>(k, start);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  update_scatter_kernel<<<dim3(chunks, L), SCATTER_THREADS, smem, stream>>>(
      labels, hist, seg, start, S, k, C, segs, order);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid((k + SUM_THREADS / 32 - 1) / (SUM_THREADS / 32), L);
  if (bn > 0) {
    update_sum_kernel<true><<<grid, SUM_THREADS, 0, stream>>>(
        x, w, lanes, order, start, S, d, k, bn, sums, counts);
  } else {
    update_sum_kernel<false><<<grid, SUM_THREADS, 0, stream>>>(
        x, w, lanes, order, start, S, d, k, 0, sums, counts);
  }
  return cudaGetLastError();
}

}  // namespace
