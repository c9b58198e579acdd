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
// TF32 would change labels against the reference).  A lane's solve is a
// chain of dependent trips, so what else bounds it is how many SMs one lane
// can use and how well each SM keeps its FMA pipes fed.
//
// What the design does about it:
//   * one thread-block cluster of R blocks per lane, on R SMs of one GPC,
//     launched with cudaLaunchKernelEx; the wrapper picks R from the
//     stack's size and what the card reports (batch_resident.cluster_plan:
//     a lone lane takes 16, a large stack 2) and splits a lane's rows among
//     the R blocks (batch_resident.cluster_rows, passed to the kernel):
//     block r owns rows [rows[r], rows[r + 1]), a contiguous range of whole
//     128-row tiles (whole units of lcm(128, pruning block) rows, so that no
//     pruning block straddles two blocks), and the clusters [k r / R,
//     k (r + 1) / R).  Per trip:
//       - score pass: each block scores its own rows (labels, and the gaps
//         of prune="bounds"); a row's result does not depend on which block
//         scores it;
//       - counting sort: each block counts its own rows' labels in shared
//         memory; after a cluster barrier every block reads the R
//         histograms through distributed shared memory, so its cursor for
//         cluster j is start[j] plus the counts of lower ranks, and it
//         scatters its own rows into the lane's order: the same stable
//         order, by point, as one block's sort;
//       - segment sums: after a cluster barrier, each cluster is summed by
//         one warp of its owner block in increasing point order, read from
//         the order in device memory (cluster_sums: the same bits as the
//         fused pass's and the centroid update's segment_sums);
//       - division: the owner divides its centroid rows keep-old in place
//         in the lane's centroid buffer; the shift is the max over the
//         blocks' movements and the empty flag their OR, exchanged through
//         distributed shared memory at a cluster barrier, which also
//         publishes the new centroids (barrier.cluster is release/acquire
//         at cluster scope);
//       - reseed (reseed_empty): when a trip leaves a cluster empty, one
//         more score pass against the updated centroids gives each point's
//         distance; the e-th empty cluster in index order takes the e-th
//         farthest point of positive weight by (distance desc, row asc),
//         each block's own argmax combined across the cluster, the taken
//         row excluded, while e < min(k, S) and the distance is finite: the
//         semantics of ref.reseed_rows;
//       - the stop test reads the cluster-wide shift, so the whole cluster
//         leaves its loop together.  A lane that stops leaves its loop, the
//         TPU kernel's `where(active, ...)` freeze without the wasted work.
//     The final SSE is the fixed-shape tree of 256 threads over the whole
//     lane, summed by block 0 after a cluster barrier, so its bits do not
//     depend on R.
//   * a block is 512 threads, one an SM at 128 registers: two scoring
//     groups of 256, each scoring every other tile of the block's range with
//     its own two cp.async buffers and its own named barrier, so one group
//     computes while the other waits.  Both walk the same chunks of the
//     lane's centroids at about the same time, so an SM streams one lane's
//     centroids and not two (PERF.md has the measurements behind this).
//   * the score pass and the segment-sum are the fused pass's own device
//     code (lloyd_device.cuh): the same 8x8 register-blocked tiles, fed by a
//     cp.async double buffer, the same lowest-index tie-break, the same
//     stable counting sort and point-order per-cluster sums.  A lane
//     therefore follows the fused engine's host loop label for label and
//     sum for sum, at every R.  No float atomics: a repeat launch gives the
//     same bits, and a lane of a stack gives the same bits as the same lane
//     launched alone.
//   * what it gives up: clusters of 4, 8 or 16 one-block-an-SM blocks fit
//     120, 120 and 112 of the H100's 132 SMs (the rest of each GPC stays
//     idle), so a large stack takes R = 2; and the per-trip sort and sums,
//     three cluster barriers and the per-block centroid norms add about 2%
//     to a trip.  One lane's points (4 MB) and its (k, d) accumulator (256
//     KB) do not fit shared memory, so they stream from device memory or
//     L2 on every trip; centroids, sums, counts, labels, distances and the
//     sort order live in a per-lane workspace that the wrapper allocates.
//   * bounds (template flag BOUNDS): the score pass also keeps the second
//     best score with the assigned column masked; a pruning block of bb rows
//     keeps its margin min(d2 - d1) and the drift accumulated since it was
//     scored, and is skipped while margin > 2 * drift.  Skipped rows keep
//     their cached labels; the segment-sum runs over all labels either way,
//     so the pruned solve is bit-for-bit the exact one.  Skip counters are
//     integer atomics, summed over blocks and lanes, per trip.
//   * division, sqrt and the stop test are IEEE f32 (no fast-math flags).
//   * bfloat16 carry (template flag CARRY_BF16: seeds given in bfloat16, the
//     points widened to f32 by the wrapper, exactly): each divided centroid
//     and each reseed pick is rounded to bfloat16 before the shift is
//     taken, as the reference's kernels round every trip's centroids and
//     picks through the carry dtype.  The f32 instantiations are unchanged.
//
// Plain C interface, loaded with ctypes: `lloyd_solve` returns the first
// non-zero CUDA error of the launch, 0 on success; `lloyd_solve_clusters`
// reports how many clusters of R blocks the card holds at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "lloyd_device.cuh"

namespace cg = cooperative_groups;

namespace {

using lloyd::BM;
using lloyd::NT;

// a block of ST = 512 threads (one block an SM at 128 registers) is two
// scoring groups of NT threads, each scoring its own tiles with its own
// buffers and barrier; both walk the same centroid chunks at about the
// same time
constexpr int GROUPS = 2;
constexpr int ST = GROUPS * NT;
constexpr int MAX_CLUSTER = 16;

// (v, r) comes before (bv, br): the larger value, then the lower row
__device__ __forceinline__ bool beats(float v, int r, float bv, int br) {
  return v > bv || (v == bv && r < br);
}

// argmax of score[lo, hi) by (value desc, row asc), into (val, row) for
// every thread of the block; (-inf, none) for an empty range.  Starts and
// ends with a barrier.
__device__ void block_argmax(const float* score, int lo, int hi, int none,
                             float* wv, int* wr, float& val, int& row) {
  const int tid = threadIdx.x;
  const int wid = tid / 32;
  const int lid = tid % 32;
  float bv = -INFINITY;
  int br = none;
  __syncthreads();
  for (int i = lo + tid; i < hi; i += ST) {
    const float v = score[i];
    if (beats(v, i, bv, br)) {
      bv = v;
      br = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int orow = __shfl_xor_sync(0xffffffffu, br, off);
    if (beats(ov, orow, bv, br)) {
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
    bv = lid < ST / 32 ? wv[lid] : -INFINITY;
    br = lid < ST / 32 ? wr[lid] : none;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int orow = __shfl_xor_sync(0xffffffffu, br, off);
      if (beats(ov, orow, bv, br)) {
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

// One value of each block, exchanged across the cluster through
// distributed shared memory.  A call writes slot[p], waits at the cluster
// barrier and reads every block's slot[p]; p alternates between calls, so
// a slot is written again only after the next call's barrier, which every
// block reaches after it has read the slot.  Every block makes the same
// calls in the same order.
struct Exchange {
  float f[2];
  int i[2];
};

// max of f (>= 0) and OR of i over the threads of every block of the
// cluster, for every thread
__device__ void cluster_max_or(const cg::cluster_group& cluster,
                               Exchange* ex, int& p, float* wv, int* wr,
                               float& f, int& i) {
  const int wid = threadIdx.x / 32;
  const int lid = threadIdx.x % 32;
  for (int off = 16; off > 0; off >>= 1) {
    f = fmaxf(f, __shfl_xor_sync(0xffffffffu, f, off));
    i |= __shfl_xor_sync(0xffffffffu, i, off);
  }
  if (lid == 0) {
    wv[wid] = f;
    wr[wid] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < ST / 32; ++w) {
      f = fmaxf(f, wv[w]);
      i |= wr[w];
    }
    ex->f[p] = f;
    ex->i[p] = i;
  }
  cluster.sync();
  f = 0.f;
  i = 0;
  for (int r = 0; r < (int)cluster.num_blocks(); ++r) {
    const Exchange* o = cluster.map_shared_rank(ex, r);
    f = fmaxf(f, o->f[p]);
    i |= o->i[p];
  }
  p ^= 1;
}

// the cluster's argmax of the blocks' (v, r) pairs by (value desc, row
// asc), for every thread; (v, r) is the same in every thread of a block
__device__ void cluster_argmax(const cg::cluster_group& cluster,
                               Exchange* ex, int& p, float& v, int& r) {
  if (threadIdx.x == 0) {
    ex->f[p] = v;
    ex->i[p] = r;
  }
  cluster.sync();
  for (int q = 0; q < (int)cluster.num_blocks(); ++q) {
    const Exchange* o = cluster.map_shared_rank(ex, q);
    const float ov = o->f[p];
    const int orow = o->i[p];
    if (beats(ov, orow, v, r)) {
      v = ov;
      r = orow;
    }
  }
  p ^= 1;
}

// How a lane's rows are split among the blocks of its cluster: block r
// owns rows [row[r], row[r + 1]).
struct RowSplit {
  int row[MAX_CLUSTER + 1];
};

// Words of dynamic shared memory that hold the score pass's tiles, or the
// counting sort's start (k + 1) and cursor (k), whichever is larger.
__host__ __device__ inline int tile_words(int k) {
  const int tiles = (int)(GROUPS * sizeof(lloyd::ScoreTiles) / sizeof(int));
  return tiles > 2 * k + 1 ? tiles : 2 * k + 1;
}

// One cluster of R blocks per lane; R = the cluster's size.  Dynamic
// shared memory, in three parts that each hold two things at different
// times of a trip:
//   * tile_words(k): the score pass's tiles, or the counting sort's start
//     and cursor.  Both are this block's own.  A score pass ends with no
//     copy in flight and at a block barrier before the sort writes start,
//     and the sort's last read of start ends at a block barrier before the
//     next score pass;
//   * k words: the centroid norms during a score pass, or this block's
//     label histogram during the sort.  The norms are read only by this
//     block's score passes, which end at a block barrier before the
//     histogram is built, and the other blocks' last reads of the
//     histogram end at the cluster barrier after the scatter, before any
//     norms are computed again;
//   * under BOUNDS, one skip flag per pruning block (nb; a block fills only
//     its own).
template <bool BOUNDS, bool CARRY_BF16>
__global__ void __launch_bounds__(ST, 1)
solve_kernel(const float* __restrict__ x, const float* __restrict__ c0,
             long long c0_stride, const float* __restrict__ w, int S, int d,
             int k, int max_iters, float tol, int reseed, int bb, int nb,
             RowSplit split, float* c, int* labels, float* mind, float* gap,
             int* order, float* sums, float* counts, float* margin,
             float* dacc, float* sse, int* iters, int* conv, int* passes,
             int* skips) {
  __shared__ float red[NT];
  __shared__ float wv[ST / 32];
  __shared__ int wr[ST / 32];
  __shared__ Exchange ex;
  extern __shared__ __align__(16) int smem[];
  const int grp = threadIdx.x / NT;   // this thread's scoring group
  lloyd::ScoreTiles& sm = reinterpret_cast<lloyd::ScoreTiles*>(smem)[grp];
  int* start = smem;
  int* cursor = smem + k + 1;
  int* hist = smem + tile_words(k);
  float* cn = reinterpret_cast<float*>(hist);
  int* skipb = hist + k;

  const cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long g = blockIdx.x / R;
  const int tid = threadIdx.x;
  const long long kd = (long long)k * d;
  const float* xl = x + g * S * (long long)d;
  const float* c0l = c0 + g * c0_stride;   // this lane's seeds
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
  const int kk = min(k, S);   // reseed candidates, S the padded capacity

  // this block's rows [lo, hi), pruning blocks [blo, bhi), clusters
  // [jlo, jhi)
  int lo = 0;
  int hi = 0;
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) {
    // a constant index: the split stays in the parameter space
    if (q == rank) {
      lo = split.row[q];
      hi = split.row[q + 1];
    }
  }
  const int blo = BOUNDS ? lo / bb : 0;
  const int bhi = BOUNDS && lo < hi ? (hi + bb - 1) / bb : blo;
  const int jlo = (int)((long long)k * rank / R);
  const int jhi = (int)((long long)k * (rank + 1) / R);

  for (long long e = jlo * (long long)d + tid; e < jhi * (long long)d;
       e += ST) {
    cl[e] = c0l[e];
  }
  if (BOUNDS) {
    for (int b = blo + tid; b < bhi; b += ST) {
      mg[b] = -INFINITY;   // a fresh block is always scored
      da[b] = 0.f;
    }
  }
  int p = 0;        // the exchange's slot parity, the same in every block
  cluster.sync();   // the seeds are in the lane's centroid buffer

  int it = 0;
  int npass = 0;
  float shift = INFINITY;
  while (it < max_iters && shift > tol) {
    lloyd::centroid_norms<ST>(cl, k, d, cn);
    if (BOUNDS) {
      for (int b = blo + tid; b < bhi; b += ST) skipb[b] = mg[b] > 2.f * da[b];
    }
    __syncthreads();

    // the trip's score pass over this block's rows, group g taking tiles
    // g, g + 2, ...: labels (and under BOUNDS the gaps) of every row whose
    // pruning block is not skipped
    for (int r0 = lo + grp * BM; r0 < hi; r0 += GROUPS * BM) {
      if (BOUNDS) {
        const int b1 = (min(r0 + BM, hi) - 1) / bb;
        bool live = false;
        for (int b = r0 / bb; b <= b1; ++b) live = live || skipb[b] == 0;
        if (!live) continue;
      }
      lloyd::score_tile<BOUNDS>(xl, cl, cn, hi, d, k, r0, sm, lab, nullptr,
                                gp, wl, BOUNDS ? skipb : nullptr, bb,
                                1 + grp);
    }
    __syncthreads();
    int nskip = 0;
    if (BOUNDS) {
      for (int b = blo + tid; b < bhi; b += ST) {
        if (skipb[b]) continue;
        const int end = min((b + 1) * bb, S);
        float m = INFINITY;
        for (int r = b * bb; r < end; ++r) m = fminf(m, gp[r]);
        mg[b] = m;
      }
      if (tid == 0) {
        for (int b = blo; b < bhi; ++b) nskip += skipb[b];
      }
    }

    // counting sort across the cluster: this block's histogram, then
    // every block's through distributed shared memory
    lloyd::label_histogram<ST>(lab, lo, hi, k, hist);
    cluster.sync();
    for (int j = tid; j < k; j += ST) {
      int tot = 0;
      int below = 0;
      for (int r = 0; r < R; ++r) {
        const int h = cluster.map_shared_rank(hist, r)[j];
        tot += h;
        if (r < rank) below += h;
      }
      start[j] = tot;
      cursor[j] = below;
    }
    __syncthreads();
    if (tid < 32) lloyd::scan_counts(start, cursor, k, start, cursor);
    __syncthreads();
    if (tid < 32) lloyd::stable_scatter(lab, lo, hi, k, cursor, ord);
    cluster.sync();   // the lane's order is complete

    lloyd::cluster_sums<ST>(xl, wl, ord, start, jlo, jhi, d, sl, cnt);
    __syncthreads();

    // keep-old division of this block's clusters in place; thread tid owns
    // rows j = jlo + tid (mod ST) and the largest movement among them
    float tmax = 0.f;
    int empty = 0;
    for (int j = jlo + tid; j < jhi; j += ST) {
      const float n = cnt[j];
      if (n > 0.f) {
        float acc = 0.f;
        for (int t = 0; t < d; ++t) {
          const long long e = (long long)j * d + t;
          float nv = sl[e] / fmaxf(n, 1.f);
          if (CARRY_BF16) nv = lloyd::round_bf16(nv);
          const float df = nv - cl[e];
          acc = fmaf(df, df, acc);
          cl[e] = nv;
        }
        tmax = fmaxf(tmax, sqrtf(acc));
      } else {
        empty = 1;
      }
    }
    // the shift so far and whether any cluster of the lane is empty; the
    // barrier publishes the divided centroids and the counts
    float mx = tmax;
    int any_empty = empty;
    cluster_max_or(cluster, &ex, p, wv, wr, mx, any_empty);
    shift = mx;

    if (reseed && any_empty) {
      // distances to the updated centroids; rows of zero weight score -inf
      lloyd::centroid_norms<ST>(cl, k, d, cn);
      __syncthreads();   // each group's score pass reads every norm
      for (int r0 = lo + grp * BM; r0 < hi; r0 += GROUPS * BM) {
        lloyd::score_tile<false>(xl, cl, cn, hi, d, k, r0, sm, nullptr, md,
                                 nullptr, nullptr, nullptr, 0, 1 + grp);
      }
      __syncthreads();
      for (int i = lo + tid; i < hi; i += ST) {
        if (!(wl[i] > 0.f)) md[i] = -INFINITY;
      }
      float lv;
      int lr;
      block_argmax(md, lo, hi, S, wv, wr, lv, lr);
      int e = 0;
      for (int j = 0; j < k && e < kk; ++j) {
        if (!(cnt[j] <= 0.f)) continue;
        float v = lv;
        int r = lr;
        cluster_argmax(cluster, &ex, p, v, r);
        // not finite: every later pick would be no better
        if (!(v > -INFINITY && v < INFINITY)) break;
        if (j >= jlo && j < jhi && tid == 0) {
          const float* xr = xl + (long long)r * d;
          float* cj = cl + (long long)j * d;
          float acc = 0.f;
          for (int t = 0; t < d; ++t) {
            const float xv = CARRY_BF16 ? lloyd::round_bf16(xr[t]) : xr[t];
            const float df = xv - cj[t];
            acc = fmaf(df, df, acc);
          }
          tmax = fmaxf(tmax, sqrtf(acc));
          for (int t = 0; t < d; ++t)
            cj[t] = CARRY_BF16 ? lloyd::round_bf16(xr[t]) : xr[t];
        }
        if (r >= lo && r < hi) {
          // the taken row was this block's: its next best
          if (tid == 0) md[r] = -INFINITY;
          block_argmax(md, lo, hi, S, wv, wr, lv, lr);
        }
        ++e;
      }
      ++npass;
      // the trip's shift with the reseeded clusters' movements; the
      // barrier publishes the reseeded centroids
      mx = tmax;
      int none = 0;
      cluster_max_or(cluster, &ex, p, wv, wr, mx, none);
      shift = mx;
    }

    if (BOUNDS) {
      for (int b = blo + tid; b < bhi; b += ST) {
        da[b] = skipb[b] ? da[b] + shift : shift;
      }
      if (tid == 0) {
        atomicAdd(&skips[2 * it], nskip);
        atomicAdd(&skips[2 * it + 1], bhi - blo);
      }
    }
    ++it;
    ++npass;
  }

  // final statistics with the converged centroids: every block scores its
  // rows, then block 0 sums the whole lane in the fixed-shape tree of NT
  // threads (its bits do not depend on R or on ST)
  lloyd::centroid_norms<ST>(cl, k, d, cn);
  __syncthreads();   // each group's score pass reads every norm
  for (int r0 = lo + grp * BM; r0 < hi; r0 += GROUPS * BM) {
    lloyd::score_tile<false>(xl, cl, cn, hi, d, k, r0, sm, nullptr, md,
                             nullptr, nullptr, nullptr, 0, 1 + grp);
  }
  // also the last barrier: no block reads another's shared memory after it
  cluster.sync();
  if (rank != 0) return;
  const float total = lloyd::block_weighted_sum<NT>(wl, md, S, red);
  if (tid == 0) {
    sse[g] = total;
    iters[g] = it;
    conv[g] = shift <= tol ? 1 : 0;
    passes[g] = npass + 1;
  }
}

// the launch configuration of clusters of R blocks; sets the kernel's
// shared-memory and cluster-size attributes
template <bool BOUNDS, bool CARRY_BF16>
cudaError_t configure(int k, int nb, int R, unsigned grid,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const size_t smem =
      ((size_t)tile_words(k) + k + (BOUNDS ? nb : 0)) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      solve_kernel<BOUNDS, CARRY_BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (R > 8) {
    err = cudaFuncSetAttribute(solve_kernel<BOUNDS, CARRY_BF16>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(ST);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)R;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// rows (R + 1 entries) splits [0, S) into R ranges in order, each starting
// at a whole pruning block (bb > 0)
bool valid_split(const int* rows, int R, int S, int bb, RowSplit* split) {
  if (rows[0] != 0 || rows[R] != S) return false;
  for (int r = 0; r <= R; ++r) {
    if (r > 0 && rows[r] < rows[r - 1]) return false;
    if (bb > 0 && r < R && rows[r] % bb != 0) return false;
    split->row[r] = rows[r];
  }
  return true;
}

template <bool BOUNDS, bool CARRY_BF16>
int launch(const float* x, const float* c0, long long c0_stride,
           const float* w, int M, int S, int d, int k, int max_iters,
           float tol, int reseed, int bb, int nb, const int* rows, int R,
           float* c, int* labels, float* mind, float* gap, int* order,
           float* sums, float* counts, float* margin, float* dacc,
           float* sse, int* iters, int* conv, int* passes, int* skips,
           cudaStream_t stream) {
  if (R < 1 || R > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  RowSplit split{};
  if (!valid_split(rows, R, S, bb, &split)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<BOUNDS, CARRY_BF16>(
      k, nb, R, (unsigned)(M * R), stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, solve_kernel<BOUNDS, CARRY_BF16>, x, c0,
                           c0_stride, w, S, d, k, max_iters, tol, reseed, bb,
                           nb, split, c, labels, mind, gap, order, sums,
                           counts, margin, dacc, sse, iters, conv, passes,
                           skips);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool BOUNDS, bool CARRY_BF16>
int clusters(int k, int nb, int R, int* n) {
  if (R < 1 || R > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure<BOUNDS, CARRY_BF16>(k, nb, R, (unsigned)R, 0, &cfg, &attr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(
        n, solve_kernel<BOUNDS, CARRY_BF16>, &cfg);
  }
  // a refused shape is this call's answer: leave no error for the next
  // launch's check to find
  cudaGetLastError();
  return (int)err;
}

}  // namespace

// Lane g starts from the seeds at c0 + g * c0_stride: a stride of 0 shares
// one (k, d) block among the lanes, k * d gives each lane its own.
// bb > 0 turns on prune="bounds"; with pruning blocks of bb rows, nb of them
// a lane; gap, margin and dacc may be null otherwise.  carry_bf16 != 0 rounds
// the carry to bfloat16 (CARRY_BF16).  R blocks a lane (a cluster); block r
// of a cluster owns the lane's rows [rows[r], rows[r + 1]), rows a host
// array of R + 1 entries from 0 to S, each but the last a multiple of bb
// under pruning (else cudaErrorInvalidValue).
extern "C" int lloyd_solve(const float* x, const float* c0,
                           long long c0_stride, const float* w,
                           int M, int S, int d, int k, int max_iters,
                           float tol, int reseed, int bb, int nb,
                           int carry_bf16, const int* rows, int R, float* c,
                           int* labels, float* mind, float* gap, int* order,
                           float* sums, float* counts, float* margin,
                           float* dacc, float* sse, int* iters, int* conv,
                           int* passes, int* skips, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto run = [&](auto bounds, auto carry) {
    constexpr bool B = decltype(bounds)::value;
    constexpr bool C = decltype(carry)::value;
    return launch<B, C>(x, c0, c0_stride, w, M, S, d, k, max_iters, tol,
                        reseed, B ? bb : 0, B ? nb : 0, rows, R, c, labels,
                        mind, gap, order, sums, counts, margin, dacc, sse,
                        iters, conv, passes, skips, stream);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (bb > 0) return carry_bf16 ? run(T{}, T{}) : run(T{}, F{});
  return carry_bf16 ? run(F{}, T{}) : run(F{}, F{});
}

// how many clusters of R blocks the card holds at once for this k and nb
// (bounds != 0: the pruning kernel; carry_bf16 != 0: the bfloat16 carry)
// into *n; 0 on success, else the CUDA error (a cluster size the card
// refuses)
extern "C" int lloyd_solve_clusters(int k, int nb, int bounds, int carry_bf16,
                                    int R, int* n) {
  *n = 0;
  if (bounds) {
    return carry_bf16 ? clusters<true, true>(k, nb, R, n)
                      : clusters<true, false>(k, nb, R, n);
  }
  return carry_bf16 ? clusters<false, true>(k, nb, R, n)
                    : clusters<false, false>(k, nb, R, n);
}
