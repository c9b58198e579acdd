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
//   * the centroid update is a stable counting sort by label spread over
//     the whole card, then one warp per cluster.  A stable sort by label is
//     unique, so a sort cut into chunks gives the same order as the fused
//     pass's one-warp scatter, and the same sums bit for bit.  Each listed
//     lane is cut into chunks of C rows (C a multiple of 32, chosen by the
//     wrapper so that lanes x chunks gives every SM at least four blocks),
//     and six launches on the caller's stream do the rest:
//       1. histogram (lanes x chunks blocks): each chunk counts its labels
//          in shared memory, with one int atomic per distinct label of a
//          warp's 32 rows (exact in any order), into hist (L, chunks, k);
//       2. chunk prefix (columns x segments x lanes): per cluster, the
//          exclusive prefix of the chunks' counts inside each segment of
//          CHUNK_SEG chunks, in place, and each segment's total;
//       3. segment prefix (columns x lanes): per cluster, the exclusive
//          prefix of the segments' totals, in place, and the cluster's
//          total; then lane start (one block a lane): start[j] (k + 1), the
//          exclusive scan of the totals in cluster order.  All integer:
//          chunk c's first slot for cluster j is start[j] plus the counts
//          of j in chunks before c, exactly;
//       4. scatter (lanes x chunks blocks): one warp scatters its chunk's
//          rows from those slots, 32 rows a step, ranked by
//          __match_any_sync, with the labels of 8 steps loaded ahead;
//       5. sums ((k / 8) x lanes blocks of 8 warps): one warp per (lane,
//          cluster) sums its rows in increasing point order with
//          cluster_sums's FMA order (columns t and t + 32 of each 64-wide
//          chunk), loading 8 rows ahead, with no branch around the FMAs.
//     No float atomics: a repeat launch gives the same bits, and the sums
//     are the fused pass's given the same labels.  What bounds it is bytes
//     (each point read once, 4*d bytes for d multiply-adds, far below the
//     ridge; no wgmma or TMA: the gain is spreading the sort and the gather
//     over all SMs).  The limit that the bits impose: a cluster that holds
//     most of a lane is summed by one warp in point order (about 100 ns a
//     row on the H100, PERF.md).
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
constexpr int PSI_THREADS = 1024;
// the centroid update's passes
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
__global__ void __launch_bounds__(SUM_THREADS)
update_sum_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ lanes,
                  const int* __restrict__ order,
                  const int* __restrict__ start, int S, int d, int k,
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
#pragma unroll
        for (int u = 0; u < SUM_AHEAD; ++u) {
          const int q = q0 + u;
          const int i = __shfl_sync(0xffffffffu, mi, q);
          const float* xr = xl + (long long)i * d;
          v[u] = q < n && ok ? xr[t] : 0.f;
          v2[u] = q < n && ok2 ? xr[t2] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < SUM_AHEAD; ++u) {
          const float wi = __shfl_sync(0xffffffffu, mw, q0 + u);
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
    if (ok) srow[t] = acc;
    if (ok2) srow[t2] = acc2;
    if (t0 == 0 && lid == 0) counts[g * k + j] = cnt;
  }
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

// The centroid update of the listed lanes: chunks of C rows (C a multiple
// of 32; chunks = ceil(S / C) and segs = ceil(chunks / CHUNK_SEG), checked
// here) and the workspaces hist (L, chunks, k), seg (L, segs, k), start
// (L, k + 1) and order (L, S) ints, all from the caller.
extern "C" int centroid_update(const float* x, const float* w,
                               const int* lanes, const int* labels, int L,
                               int S, int d, int k, int C, int chunks,
                               int segs, int* hist, int* seg, int* start,
                               int* order, float* sums, float* counts,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (L < 1 || L > 65535 || S < 1 || d < 1 || k < 1 || C < 32 || C % 32 != 0
      || (long long)chunks != ((long long)S + C - 1) / C
      || segs != (chunks + CHUNK_SEG - 1) / CHUNK_SEG || segs > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = k * (int)sizeof(int);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(update_histogram_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(update_scatter_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  update_histogram_kernel<<<dim3(chunks, L), HIST_THREADS, smem, stream>>>(
      labels, S, k, C, hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  update_prefix_kernel<<<dim3((k + COLUMN_THREADS - 1) / COLUMN_THREADS, segs,
                              L),
                         COLUMN_THREADS, 0, stream>>>(hist, chunks, k, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  update_segscan_kernel<<<dim3((k + COLUMN_THREADS - 1) / COLUMN_THREADS, L),
                          COLUMN_THREADS, 0, stream>>>(seg, segs, k, start);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  update_start_kernel<<<L, START_THREADS, 0, stream>>>(k, start);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  update_scatter_kernel<<<dim3(chunks, L), SCATTER_THREADS, smem, stream>>>(
      labels, hist, seg, start, S, k, C, segs, order);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  update_sum_kernel<<<dim3((k + SUM_THREADS / 32 - 1) / (SUM_THREADS / 32),
                           L),
                      SUM_THREADS, 0, stream>>>(x, w, lanes, order, start, S,
                                                d, k, sums, counts);
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
