#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` (one
``nvcc`` per source, all started together), holds each against its plain
PyTorch version, drives the IPKMeans main path (kd-tree S1 -> S2 with
empty-cluster reseeding -> min-ASSE S3) at full size through
``repro_torch.core.ipkmeans.ipkmeans``, and checks the result.  Phases:

  1. device and build: the card's name and power limit, the build times,
     and each kernel's registers, shared memory and spills (ptxas);
  2. [lane], [ragged]: the fused pass against its plain version, both
     modes, at the main path's lane shape and on a ragged case; determinism
     on a repeat launch; its times (taken again over the whole stack in
     [stack], and those go into the report);
  3. [solve]: the whole-solve kernel against its plain version on two
     stacks, reseed on and off, prune "none" and "bounds", at clusters of
     R = 1, 2, 4, 8 blocks a lane (and 16 where the card takes it), every R
     bit-identical to R = 1; bounds bit-identical to exact, one batched
     launch bit-identical to one resident launch per lane, a repeat launch
     bit-identical; then each stack from one seed block a lane (``(M, k,
     d)`` seeds), against the plain version and one resident solve a lane
     from its own seeds;
  4. [small]: the whole pipeline on a small input, card against CPU;
  5. [main]: the main path at full size (n = 2**23, d = 64, K = 1024,
     M = 512), on ``backend="fused"`` (the first slice's path) and on
     ``backend="batched"`` (the reference's main configuration) with
     prune "none" and "bounds", each with the launch counts reset just
     before and read just after; the cluster size R the rule picks; the
     whole-solve kernel's times at the whole stack at each R (whole solves,
     and one score pass with max_iters=0 of the stack and of a lone lane),
     the whole solves of the stack's first 16 and 48 lanes at each R beside
     the rule's pick, and an 8-lane slice against its plain version;
  5a. [serve]: the serving tier (``NearestCentroidServer``,
     ``BucketPolicy()``: buckets of 8 to 4096 rows) over [main]'s batched
     centroids, counts the main input's cluster sizes: a stream of 2048
     requests of 1..4096 rows and 4 of 2**16 (chunked), one dispatch each,
     a refresh on ``fused`` (2**16 rows of the main mixture, drifting by
     0.25 a refresh) every 256 dispatches, the counts set to 0 just before
     and read just after (one fused launch a chunk and a refresh) and no
     plain version called; the served rows bit for bit the unpadded launch
     (each epoch, each bucket), coalesced dispatch bit for bit direct
     assigns in the reference's FIFO steps, one build a bucket, the plain
     version's labels (near-tie rule), each refresh against ``twopass``
     (centroids and counts bit for bit) and the plain oracle, the refreshed
     centroids beating the stale ones on a drifted batch, ``tuned`` against
     ``resident`` on 4 lanes with an empty tuning cache, and a cached bf16
     spec reaching bucket 4096 (the bf16 checks pass, the f32 control
     fails them); latency p50/p99 by bucket, rows/s, refresh times beside
     their bound;
  6. [resident]: one full-width solve through ``kmeans(...,
     backend="resident")``, its R, beside the fused engine's solve;
  6a. [recover]: ``ipkmeans_recoverable`` at [main]'s size and
     configuration on ``batched``, 4 workers of 128 lanes, 2 iterations a
     round, a snapshot every 2 rounds: crash-free, and with the worker of
     the longest-running stack crashed at round 3; each with the counts set
     to 0 just before and read just after (one whole-solve launch a stack a
     round on its unconverged lanes, one fused launch for the lane SSEs),
     each bit for bit [main]'s batched run, and only the crashed stack
     advanced more often; rounds, launches, lane-rounds recomputed, and the
     S2 time beside [main]'s;
  6b. [ckpt]: an ``AsyncCheckpointer`` round trip of [main]'s batched
     centroids on the card in float32 and bfloat16, restored to the card
     bit for bit;
  7. [assign] (run before [main]): the assign kernel against its plain
     version on one large ragged lane (n = 2**20, k = 4100) and a ragged
     8-lane stack with an exact tie and an empty cluster, bit for bit the
     fused pass's assign mode and a repeat; its times;
  8. [update]: the assign kernel's labels and distances on the main stack
     against its plain version, then the centroid-update kernel against its
     plain version on those labels, on [assign]'s large lane, on that lane
     skewed (half its rows in one cluster, 10% labelled -1 or k) and on a
     small case with labels -1 and k, bit for bit the fused pass's sums on
     the same labels and a repeat; its chunk plans; its times on the stack,
     the large lane and the skewed lane beside their bounds and the library
     yardstick, and each pass's device time (torch.profiler);
  9. [init]: one init sweep at n = 2**23 against 2048 candidates, with
     psi_prev from a round 0, against its plain version (draws equal except
     at boundary rows); round 0 draws nothing, no candidate leaves mind as
     it was, a repeat is bit-identical; its times;
  9a. [tune] (after [init]): every score tile width (``KernelSpec.
     block_k`` 64 and 256) of the fused step (both modes), the assign and
     the init sweep, float32 and bfloat16, bit for bit the default width's
     launch on the main stack, on a ragged lane of [assign]'s at k = 100
     and 4100, and on [init]'s sweep; the default's outputs against the
     plain versions; each width timed beside the default, its bound and the
     default row's library call.  The whole solve of the main stack at 16,
     64 and 512 lanes a launch (``group_t``), bit for bit one launch, in
     ceil(512 / t) launches, each launch's R, its times.  The tuner's sweep
     (``autotune_step`` at 16384x64x1024 and the serving bucket
     4096x64x1024, ``autotune_init_sweep`` at 2**21 rows against 2048
     candidates, ``autotune_batched`` on the main stack with reseed on)
     into a fresh tuning cache, and the autotune CLI on a small shape;
     then [main]'s configuration on ``batched`` with that cache: bit for
     bit [main]'s run in ceil(512 / t*) launches, its S2 time beside
     [main]'s;
 10. [seed]: k-means|| seeding of the main input through ``resolve_init``
     on the kernels (9 sweeps, 1 assign) and on the plain oracles with the
     same draws, its stage times; each of the kernel run's sweeps and its
     weighting assign against the plain version on the same inputs; then
     the whole job
     ``ipkmeans(cfg.with_init("kmeans||"))`` on ``backend="batched"``;
 11. [twopass]: the main path on ``backend="twopass"`` against the fused
     engine's run;
 12. [pkmeans]: the PKMeans baseline through ``repro_torch.pkmeans`` on
     [main]'s input and seeds, on ``backend="twopass"`` (the assign and
     centroid-update kernels every trip): iterations, wall time, launches,
     SSE, and the IPKMeans/PKMeans ratios of SSE and time against [main]'s
     batched job (printed, not gated); one trip's time beside its bound;
     one fused one-lane step's beside its bound and the library yardstick
     (row-chunked), with each kernel's device time (torch.profiler);
     ``twopass`` and ``fused`` bit-identical for 3 iterations; ``twopass``
     against the plain ``eager`` engine on the first 2**18 points, and trip
     by trip for 2 trips on the whole lane, with one fused step against the
     eager step there; then whole jobs on ``fused`` and ``batched`` (the
     fused kernel every trip) with the ``twopass`` job's settings, their
     times, launches, and centroids, iterations and SSE bit for bit the
     ``twopass`` job's;
 13. [s1]: at the main input, the histogram builder's region ids against
     the sort builder's, the bucketed labeler, the sorted pack against the
     scatter pack bit for bit, their times; ``ipkmeans`` on ``batched``
     with ``s1="histogram", pack="sorted"``, ``partition="kd_random"`` and
     ``"random"``, their stage times and SSE;
 14. [merge]: ``hierarchical_merge`` of the first 8 lanes' intermediate
     centroids of [main]'s batched run (N = 8192) on the card, timed, and
     on the CPU, survivors bit for bit (the reference's flat argmin
     search timed beside the row minima on the card); the merged SSE
     against min-ASSE's;
 15. [bf16]: the main path on the main input in bfloat16 (points and
     seeds, 1 GB), on ``batched`` and ``fused``: bfloat16 results, equal
     lane iterations, intermediate centroids and SSE bit for bit between
     the engines and the resident solves of the first lanes; the bf16
     carry's whole solve timed beside the f32 kernel on the same stack and
     held against its plain version over one trip of an 8-lane slice; one
     call of each bf16-accumulate wrapper (``spec=KernelSpec(acc_dtype=
     "bfloat16")``: the fused step and the assign at 512x16384x64, k =
     1024, the update on the assign's labels, one init sweep of 2**23
     points against 2048 candidates) with the counts reset just before and
     read just after, each against its bf16 plain version (near-tie labels
     and departing rows counted), then the same checks on the f32 kernels
     and on blocks of half the rows, which must fail them; each timed
     beside the f32 kernel and its bound at the bf16 tensor-core peak;
 16. [dist]: the distributed pipeline (``repro_torch.distributed``) on 4
     ranks started by ``distributed/world.py`` (NCCL with a card a rank
     where the machine has 4, else gloo on ``cuda:0`` with every
     collective through host memory), at the main size: the flat (4,)
     mesh on ``batched`` (one whole-solve launch a rank, zero collectives
     in S2) bit for bit [main]'s single-process run; the sharded
     k-means|| seeding with [seed]'s seeds; the (2, 2) pod path with
     ``exact`` (SSE within rtol 1e-4 of a single-process
     ``s1="histogram"`` run, equal lane iterations) and ``int8ef`` (about
     a quarter of exact's wire bytes a lane-trip; its lanes against a
     plain version of the reduction on the same pod slices);
     ``pkmeans_sharded`` on ``twopass`` (one all-reduce of K d + K floats
     a trip) against the single-process job, and one trip of it against
     one single-process trip; each rank's stage times, launches,
     collectives and bytes by stage, and peak memory;
 17. a ``{"kernels": [...]}`` line (the six kernels, their bf16
     variants and [tune]'s tile-width variants; ``launches_by_path`` with
     the distributed paths), the
     card's line, and as the last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero and prints no last line.  Without a CUDA
card, or without the repository's ``src/repro_torch`` beside this file, it
exits non-zero at once.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = CSRC + "fused_lloyd.cu"
REPLACES = "src/repro/kernels/fused.py:47"
SOLVE_SOURCE = CSRC + "lloyd_solve.cu"
REPLACES_BATCHED = "src/repro/kernels/batch_resident.py:109"
REPLACES_RESIDENT = "src/repro/kernels/resident.py:151"
SWEEPS_SOURCE = CSRC + "sweeps.cu"
REPLACES_ASSIGN = "src/repro/kernels/assign.py:36"
REPLACES_UPDATE = "src/repro/kernels/centroid_update.py:31"
REPLACES_INIT = "src/repro/kernels/init.py:60"

# H100 SXM data sheet, at its 700 W limit: f32 without tensor cores, dense
# bf16 on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# the main path: one H100's eighth of the production problem of
# src/repro/launch/kmeans_dryrun.py (N = 2**26, K = 1024, M = 4096), with the
# same per-reducer shape (16384 points, d = 64)
N, D, K, M = 1 << 23, 64, 1024, 512
MAX_ITERS, TOL, SEED = 50, 1e-6, 0

# tolerances of the kernel-against-plain check (phase 2).
# Labels: the kernel sums x.c in another order than the plain version's
# matrix product, so f32 scores differ by a few ulps of ||x||^2 + ||c||^2;
# a label may differ only where the two candidates' exact (f64) distances
# are within TIE_REL of that scale.
TIE_REL = 1e-5
# mind carries the same rounding: |kernel - plain| <= MIND_REL * scale
MIND_REL = 1e-5
# sums and sse are f32 sums of the same terms in another order (up to
# 16384 terms a lane): rtol 1e-4 against the plain version given the same
# labels; counts are sums of 0/1 weights, exact in f32, and must be equal.
SUM_RTOL = 1e-4
# whole-solve kernel against its plain version ([solve], [main] slice,
# [resident]): iterations, convergence and skip counters exact; centroids
# rtol/atol 1e-4 and SSE rtol 1e-4 (f32 sums in another order).  Against the
# fused engine's run of the main path: iterations exact, SSE rtol 1e-5 (the
# same labels and sums; only the SSE tree's shape differs).
SOLVE_RTOL = SOLVE_ATOL = 1e-4
MAIN_SSE_RTOL = 1e-5
# lanes of the main path's stack that the plain version is timed on
PLAIN_LANES = 8
# stacks between a lone lane and the whole (the first m lanes), on which
# [main] holds the cluster rule's pick against every R
MID_LANES = (16, 48)
# [assign]'s large lane: the seeding's shape class (one lane, many points, a
# k that is not a multiple of the tile); [init]'s candidates per sweep
# (ell = 2K, the expected draws of one k-means|| round at K = 1024)
ASSIGN_N, ASSIGN_K = 1 << 20, 4100
INIT_C = 2048
# centroid update against its plain version ([update]): counts exact, sums
# within UPDATE_REL of their largest magnitude (f32 sums of the same terms
# in another order)
UPDATE_REL = 1e-5
# [update]'s skewed lane: one warp sums cluster 0's 2**19 rows in point order
# (the fused pass's order, which the bits require), and the rounding of an
# f32 sum grows with its terms.  There each entry is held to the
# probabilistic bound of a sum of n terms (Higham and Mary, 2019):
# |err| <= SEQ_LAMBDA sqrt(n) 2**-24 sum |w x|, for the kernel's and the
# plain version's sums each; at 6 an entry fails by chance with probability
# below 2 exp(-18), about 3e-8
SEQ_LAMBDA = 6.0
# init sweep against its plain version ([init], [seed]): new_mind within
# INIT_REL of ||x||^2 + mind (the score ||c||^2 - 2 x.c + ||x||^2 cancels at
# that scale, so a point that is itself a candidate keeps a rounding residue
# in both), psi within INIT_REL; a draw may differ only where
# |u psi_prev - ell mind| is within INIT_REL of ell mind
INIT_REL = 1e-5
# [pkmeans]: iterations of the twopass-against-fused check; the cut of the
# main input on which twopass is held against the plain eager engine, and
# its tolerance.  The kernel and cuBLAS round the scores otherwise, so a
# label may flip at a near-tie and move a centroid by a point's share; the
# runs must agree in iterations and in SSE within PK_RTOL, and trip by trip
# from the same centroids, labels may differ only at near-ties (TIE_REL)
# and centroids only in the clusters those labels moved (PK_RTOL elsewhere,
# relative to max(|c|, 1): f32 sums in another order)
PK_CHECK_ITERS = 3
PK_SMALL_N = 1 << 18
# trips of the same trip-by-trip check on the whole lane (n = N), the first
# of them also holding one fused step against the eager step
PK_FULL_TRIPS = 2
PK_RTOL = 1e-4
# [merge]: the lanes of [main]'s batched stack whose centroids are merged
MERGE_LANES = 8
# [bf16]: a bf16 kernel and its plain version take the same rounding points
# but sum each dot product, and each block's partial sums, in float32 in
# their own order, so now and then one rounding lands a bfloat16 step
# apart.  A label may differ only where the plain version's two scores lie
# within BF16_TIE_ULPS bf16 ulps of the score's largest term, max(|cn|,
# |2 x.c|) (one rounding of x.c or of cn moves the score by at most that);
# a distance by BF16_MIND_ULPS such ulps plus MIND_REL of ||x||^2; a sum by
# BF16_SUM_REL of its rows' absolute weighted sum (each block partial
# rounded once by each, at most one bf16 step, 2**-7 relative, apart).
# Those bounds also hold for float32 arithmetic, so the rare step is also
# counted: at most BF16_DEPART_SHARE of the rows (plus BF16_DEPART_FLOOR)
# may depart from the plain version, a row by its label or by a distance
# beyond the float32 noise MIND_REL of ||x||^2, a sum entry beyond
# UPDATE_REL of its rows' absolute weighted sum.  The check must tell the
# arithmetic apart: the float32 kernels, and the accumulates over blocks of
# half the rows, fail it on the same inputs, or the phase fails.
# The bf16 carry's whole solve is held against its plain version over one
# trip from the seeds (centroids within one bf16 ulp, SSE within
# BF16_SSE_RTOL: a centroid a bf16 ulp away moves its points' distances),
# and on the main path bit for bit against the fused engine and the
# resident solves of the first BF16_RESIDENT_LANES lanes.
BF16_TIE_ULPS = 1
BF16_MIND_ULPS = 2
BF16_SUM_REL = 2.0 ** -7
BF16_DEPART_SHARE = 2.0 ** -10
BF16_DEPART_FLOOR = 2
BF16_SSE_RTOL = 1e-3
BF16_RESIDENT_LANES = 4
# [serve]: the serving tier over [main]'s batched centroids.  The stream:
# SERVE_REQUESTS requests of sizes uniform over 1..SERVE_MAX_REQUEST, and
# SERVE_BIG requests of SERVE_BIG_ROWS rows (chunked by the server), each
# one dispatch; every SERVE_REFRESH_EVERY dispatches a refresh on the fused
# engine with SERVE_REFRESH_ROWS rows from the main mixture, its centres
# shifted by SERVE_DRIFT more each time.  SERVE_COALESCE requests go through
# submit/step against direct assigns.
SERVE_REQUESTS = 2048
SERVE_MAX_REQUEST = 4096
SERVE_BIG = 4
SERVE_BIG_ROWS = 1 << 16
SERVE_REFRESH_EVERY = 256
SERVE_REFRESH_ROWS = 1 << 16
SERVE_DRIFT = 0.25
SERVE_COALESCE = 64
# [tune]: the score tile widths (KernelSpec.block_k) held bit for bit
# against the default's, 128, and timed beside it; the ragged lane (rows
# and centroid counts not multiples of 64 or 128) cut from [assign]'s
# lane; the lanes a launch at which the whole solve of the main stack is
# held bit for bit against one launch; the sweep's shapes: one main-path
# lane and the serving tier's largest bucket for the fused step, 2**21
# rows against INIT_C candidates for the init sweep, the main stack
# (TUNE_SOLVE_ITERS trips) for the group size; the autotune CLI's shape
TUNE_WIDTHS = (64, 256)
TUNE_RAGGED_ROWS = ASSIGN_N - 37
TUNE_RAGGED_KS = (100, 4100)
TUNE_GROUPS = (16, 64, 512)
TUNE_STEP_SIZES = ((16384, D, K), (4096, D, K))
TUNE_INIT_N = 1 << 21
TUNE_SOLVE_ITERS = 8
TUNE_CLI = ["--sizes", "4096x64x1024", "--repeats", "1", "--group-ts",
            "4,16", "--stack-m", "16", "--init-sweep"]
# [recover]: ipkmeans_recoverable at [main]'s size and configuration on
# ``batched``: RECOVER_WORKERS workers (a stack of M / RECOVER_WORKERS lanes
# each), RECOVER_ITERS Lloyd iterations a round, a snapshot every
# RECOVER_SNAPSHOT rounds.  The crash run silences, at round
# RECOVER_CRASH_ROUND, the worker whose stack runs longest: one round past
# the round-1 snapshot, so the round it advanced since is lost and redone.
# Its lane SSEs come from one fused pass, [main]'s from the whole-solve
# kernel's final pass: bit for bit, or within RECOVER_SSE_RTOL (printed).
RECOVER_WORKERS = 4
RECOVER_ITERS = 2
RECOVER_SNAPSHOT = 2
RECOVER_CRASH_ROUND = 3
RECOVER_SSE_RTOL = 1e-6


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled symbol: the identifier after the
    (anonymous) namespace, with its template arguments, <true>/<false> for
    a bool and the number for an int (the score tile width)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    i = m.end() + int(m.group(1))
    n = re.match(r"\d+", mangled[i:])
    if not n:
        return mangled
    i += n.end()
    ident = mangled[i:i + int(n.group(0))]
    args = re.match(r"I((?:L[bi]\d+E)+)E", mangled[i + int(n.group(0)):])
    if not args:
        return ident
    names = [v if kind == "i" else ("true" if v == "1" else "false")
             for kind, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
    return f"{ident}<{', '.join(names)}>"


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel entry of an nvcc -Xptxas -v log: registers,
    shared memory, spill stores and loads."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {m.group(2)} B "
                       f"static smem, {spill}")
            name, spill = None, ""
        elif m is None and name and re.search(r"Used (\d+) registers", line):
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, 0 B static smem, {spill}")
            name, spill = None, ""
    return out


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float):
    """The least time for work of ``flops`` f32 operations that must move
    ``nbytes``: the larger of the two over the card's peaks -> (ms, what
    bounds it)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def step_bound_ms(n_lanes: int, s: int, d: int, k: int):
    """Least time for one fused step on these shapes: the larger of the f32
    operations (2*S*k*d per lane, the score product) over the f32 peak and
    the bytes (points, centroids and weights read once, sums, counts and
    sse written once) over the memory rate."""
    return bound_ms(2.0 * n_lanes * s * k * d,
                    4.0 * n_lanes * (s * d + k * d + s + k * d + k + 1))


def mixture(gen, n: int, d: int, k: int, device):
    """n points from k isotropic unit Gaussians, centers ~ U[-6, 6]^d (the
    recipe of the reference's data.synthetic.gaussian_mixture)."""
    import torch
    centers = (torch.rand((k, d), generator=gen, device=device) * 12.0
               - 6.0)
    comp = torch.randint(0, k, (n,), generator=gen, device=device)
    return centers[comp] + torch.randn((n, d), generator=gen, device=device)


def library_step(x, c, w, elems: int = 1 << 29):
    """Yardstick for one fused step from PyTorch library calls: matmul
    scores, argmin, index_add_, over chunks of lanes and of rows so that
    the (lanes, rows, k) scores stay near 2 GB (``elems`` f32: 32 lanes of
    the main stack, 2**19 rows of one 2**23-row lane).  Timed here only;
    the port never calls it."""
    import torch
    n_l, s, d = x.shape
    k = c.shape[1]
    lanes_per = max(1, elems // (s * k))
    rows = min(s, max(1, elems // (lanes_per * k)))
    sums = torch.zeros((n_l * k, d), device=x.device)
    counts = torch.zeros(n_l * k, device=x.device)
    sse = torch.zeros(n_l, device=x.device)
    cn = torch.sum(c * c, dim=-1)
    for lo in range(0, n_l, lanes_per):
        hi = min(lo + lanes_per, n_l)
        cs = c[lo:hi]
        base = k * torch.arange(lo, hi, device=x.device).unsqueeze(1)
        for r0 in range(0, s, rows):
            xs, ws = x[lo:hi, r0:r0 + rows], w[lo:hi, r0:r0 + rows]
            scores = cn[lo:hi].unsqueeze(1) - 2.0 * torch.bmm(
                xs, cs.transpose(1, 2))
            best, labels = torch.min(scores, dim=-1)
            mind = torch.clamp(best + torch.sum(xs * xs, dim=-1), min=0.0)
            flat = (labels + base).flatten()
            sums.index_add_(0, flat, (xs * ws.unsqueeze(-1)).reshape(-1, d))
            counts.index_add_(0, flat, ws.flatten())
            sse[lo:hi] += torch.sum(ws * mind, dim=-1)
    return sums.view(n_l, k, d), counts.view(n_l, k), sse


def time_step(tag, x, c, w, reps: int) -> dict:
    """CUDA-event times of one step on (x, c, w): the kernel (both modes),
    its plain version and the library yardstick, beside the bound."""
    from repro_torch.kernels import fused
    n_l, s, d = x.shape
    k = c.shape[1]
    ms = cuda_time_ms(lambda: fused.fused_lloyd(x, c, w), reps=reps)
    assign_ms = cuda_time_ms(
        lambda: fused.fused_lloyd(x, c, assign_only=True), reps=reps)
    plain_ms = cuda_time_ms(lambda: fused.fused_lloyd_plain(x, c, w),
                            reps=2, warmup=1)
    lib_ms = cuda_time_ms(lambda: library_step(x, c, w), reps=2, warmup=1)
    bound, by = step_bound_ms(n_l, s, d, k)
    print(f"[{tag}] step {n_l}x{s}x{d}, k={k}: kernel {ms:.4f} ms "
          f"({2.0 * n_l * s * k * d / (ms * 1e-3) / 1e12:.2f} TFLOP/s), "
          f"assign-only {assign_ms:.4f} ms, plain version {plain_ms:.4f} ms, "
          f"library yardstick {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def label_agreement(name, x, c, ka, pa, torch):
    """Labels and distances of an assign pass (``ka``) against the plain
    version's (``pa``) on x (L,S,d), c (L,k,d): labels may differ only at
    near-ties, mind only within MIND_REL of the scale.  Returns (ok, labels
    that differ, max |mind error| on the rows whose labels agree)."""
    # exact f64 distances to decide near-ties
    x64, c64 = x.double(), c.double()
    x2 = torch.sum(x64 * x64, dim=-1)
    c2 = torch.sum(c64 * c64, dim=-1)

    def dist(labels):
        cl = torch.gather(c64, 1, labels.long().unsqueeze(-1).expand(
            -1, -1, x.shape[2]))
        return torch.sum((x64 - cl) ** 2, dim=-1), torch.gather(
            c2, 1, labels.long())

    dk, ck = dist(ka.labels)
    dp, _ = dist(pa.labels)
    scale = x2 + ck
    diff = ka.labels != pa.labels
    n_diff = int(diff.sum())
    gap = torch.abs(dk - dp)
    n_wide = int((diff & (gap > TIE_REL * scale)).sum())
    mind_err = torch.abs(ka.mind.double() - pa.mind.double())
    n_mind_bad = int((mind_err > MIND_REL * scale + 1e-6).sum())
    max_gap = float((gap / scale)[diff].max()) if n_diff else 0.0
    print(f"[{name}] assign: {x.shape[0]}x{x.shape[1]} points, k={c.shape[1]}"
          f", d={x.shape[2]}: {n_diff} labels differ from the plain version,"
          f" all near-ties (largest f64 distance gap {max_gap:.3g} of "
          f"||x||^2+||c||^2; bound {TIE_REL})" if n_wide == 0 else
          f"[{name}] assign: {n_wide} labels differ beyond the tie bound",
          flush=True)
    if n_wide or n_mind_bad:
        print(f"[{name}] FAIL labels beyond tie bound: {n_wide}, mind beyond"
              f" {MIND_REL}: {n_mind_bad}", flush=True)
        return False, n_diff, float("nan")
    agree = mind_err[~diff]
    return True, n_diff, float(agree.max()) if agree.numel() else 0.0


def check_case(name, x, c, w, torch):
    """Phase 2 on one input: both modes against the plain version, and
    bitwise repeatability.  Returns (ok, max_abs_err of sums)."""
    from repro_torch.kernels import fused
    ka = fused.fused_lloyd(x, c, assign_only=True)
    pa = fused.fused_lloyd_plain(x, c, assign_only=True)
    torch.cuda.synchronize()
    ok, n_diff, _ = label_agreement(name, x, c, ka, pa, torch)
    if not ok:
        return False, float("nan")

    ks = fused.fused_lloyd(x, c, w)
    # the plain version given the kernel's labels (phase 1 is shared by the
    # two modes, so these are the step's labels too)
    onehot = torch.nn.functional.one_hot(ka.labels.long(), c.shape[1]).float()
    onehot = onehot * w.unsqueeze(-1)
    ps_sums = onehot.transpose(1, 2) @ x
    ps_counts = torch.sum(onehot, dim=1)
    ps_sse = torch.sum(w * ka.mind, dim=-1)
    direct = fused.fused_lloyd_plain(x, c, w)
    torch.cuda.synchronize()
    cnt_ok = torch.equal(ks.counts, ps_counts)
    sums_err = float(torch.max(torch.abs(ks.sums - ps_sums)))
    sums_tol = SUM_RTOL * float(torch.max(torch.abs(ps_sums))) + 1e-6
    sse_rel = float(torch.max(torch.abs(ks.sse - ps_sse)
                              / torch.clamp(torch.abs(ps_sse), min=1e-30)))
    direct_err = float(torch.max(torch.abs(ks.sums - direct.sums)))
    sse_direct = float(torch.max(torch.abs(ks.sse - direct.sse)
                                 / torch.clamp(torch.abs(direct.sse),
                                               min=1e-30)))
    print(f"[{name}] step: counts equal={cnt_ok}, sums max|err|={sums_err:.3g}"
          f" (tol {sums_tol:.3g}), sse max rel err={sse_rel:.3g} (tol "
          f"{SUM_RTOL}); against the plain version's own labels: sums "
          f"max|err|={direct_err:.3g}, sse rel={sse_direct:.3g}", flush=True)
    if not cnt_ok or sums_err > sums_tol or sse_rel > SUM_RTOL:
        print(f"[{name}] FAIL step outputs disagree", flush=True)
        return False, float("nan")
    if n_diff == 0 and not torch.equal(ks.counts, direct.counts):
        print(f"[{name}] FAIL counts differ with identical labels", flush=True)
        return False, float("nan")

    ka2 = fused.fused_lloyd(x, c, assign_only=True)
    ks2 = fused.fused_lloyd(x, c, w)
    torch.cuda.synchronize()
    same = (torch.equal(ka.labels, ka2.labels) and torch.equal(ka.mind,
                                                                ka2.mind)
            and all(torch.equal(a, b) for a, b in zip(ks, ks2)))
    print(f"[{name}] repeat launch bit-identical: {same}", flush=True)
    if not same:
        print(f"[{name}] FAIL the kernel is not deterministic", flush=True)
        return False, float("nan")
    return True, direct_err if n_diff == 0 else sums_err


def phase_kernel(torch, report: dict) -> bool:
    from repro_torch.kernels import fused
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    # main-path lane shape: 8 lanes of (S=16384, d=64) against k=1024
    L, S = 8, N // M
    x = mixture(gen, L * S, D, K, dev).view(L, S, D).contiguous()
    seeds = torch.randint(0, S, (L, K), generator=gen, device=dev)
    c = torch.gather(x, 1, seeds.unsqueeze(-1).expand(-1, -1, D)).contiguous()
    w = torch.ones((L, S), device=dev)
    w[1, S - 777:] = 0.0                    # a padded tail, as packs have
    ok, err = check_case("lane", x, c, w, torch)
    if not ok:
        return False

    # ragged: S and k not multiples of any tile, d odd, masked rows, an
    # empty cluster, and duplicate centroids (the lower index must win)
    Lr, Sr, Dr, Kr = 3, 1000, 17, 130
    xr = torch.randn((Lr, Sr, Dr), generator=gen, device=dev) * 3.0
    cr = torch.randn((Lr, Kr, Dr), generator=gen, device=dev) * 3.0
    cr[:, 7] = cr[:, 3]                     # duplicate: 7 must lose to 3
    cr[:, 129] = cr[:, 50]                  # across a 128-wide tile edge
    cr[:, 11] = 1e3                         # nothing maps here
    wr = (torch.rand((Lr, Sr), generator=gen, device=dev) > 0.3).float()
    okr, _ = check_case("ragged", xr, cr.contiguous(), wr, torch)
    if not okr:
        return False
    ks = fused.fused_lloyd(xr, cr.contiguous(), wr)
    lab = fused.fused_lloyd(xr, cr.contiguous(), assign_only=True).labels
    torch.cuda.synchronize()
    if bool((lab == 7).any()) or bool((lab == 129).any()) or bool(
            (ks.counts[:, 11] != 0).any()):
        print("FAIL ragged: a duplicate centroid or the empty cluster took "
              "points", flush=True)
        return False
    print(f"[ragged] duplicates 7/129 took no point; cluster 11 empty; "
          f"cluster 3 took {int((lab == 3).sum())}", flush=True)

    time_step("lane", x, c, w, reps=10)
    report["max_abs_err"] = err
    return True


def solve_bound_ms(s: int, d: int, k: int, n_lanes: int, passes: int,
                   skipped_rows: int, max_iters: int):
    """Least time for a whole-solve launch: the larger of the f32 operations
    of the score passes it actually ran (2*S*k*d for each lane's trips,
    reseed passes and final pass, less the rows of skipped pruning blocks)
    over the f32 peak, and the bytes (points, weights and seeds read once;
    centroids, sse, iters, converged and the skip counters written once)
    over the memory rate."""
    return bound_ms(2.0 * k * d * (s * passes - skipped_rows),
                    4.0 * (n_lanes * (s * d + s + k * d + 3) + k * d
                           + 2 * max(max_iters, 1)))


def compare_solve(tag, got, want, torch) -> tuple[bool, float]:
    """Kernel outputs against the plain version's (SolveOut tuples):
    iterations, convergence, skip counters and score passes (which the
    bounds count) exact, centroids and SSE within SOLVE_RTOL.  Returns (ok,
    max |centroid error|)."""
    same_it = torch.equal(got.iters, want.iters)
    same_conv = torch.equal(got.converged, want.converged)
    same_skips = torch.equal(got.skips, want.skips)
    same_passes = torch.equal(got.passes, want.passes)
    err = float(torch.max(torch.abs(got.centroids - want.centroids)))
    c_ok = bool(torch.allclose(got.centroids, want.centroids,
                               rtol=SOLVE_RTOL, atol=SOLVE_ATOL))
    sse_ok = bool(torch.allclose(got.sse, want.sse, rtol=SOLVE_RTOL, atol=0))
    sse_rel = float(torch.max(torch.abs(got.sse - want.sse)
                              / torch.clamp(torch.abs(want.sse), min=1e-30)))
    ok = (same_it and same_conv and same_skips and same_passes and c_ok
          and sse_ok)
    print(f"[{tag}] kernel vs plain: iters equal={same_it} "
          f"({got.iters.tolist() if got.iters.numel() <= 8 else 'stack'}), "
          f"converged equal={same_conv}, skips equal={same_skips}, "
          f"passes equal={same_passes}, "
          f"centroids max|err|={err:.3g} (rtol/atol {SOLVE_RTOL}), "
          f"sse max rel={sse_rel:.3g}{'' if ok else '  FAIL'}", flush=True)
    return ok, err


def solve_batched(x, c, w, **kw):
    """The batched launch with every output, score passes included."""
    from repro_torch.kernels import batch_resident as br
    return br.solve_stack(x, c, w, **kw)


def resident_out(x, c, w, **kw):
    """The resident launch (one lane, counted as the resident wrapper's)
    with every output, as a one-lane SolveOut."""
    from repro_torch.kernels import batch_resident as br
    return br.solve_stack(x[None], c, w[None], count_as="resident", **kw)


def identical(a, b) -> bool:
    import torch
    return all(torch.equal(p, q) for p, q in zip(a, b))


def solve_stacks(torch, dev):
    """The two stacks of [solve]: a mixture stack at the main path's d, and
    a ragged one (S, d, k off every tile, ragged masks, one all-padding
    lane, duplicated seeds so that reseed fires)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    m, s, d, k = 8, 4096, 64, 256
    x = mixture(gen, m * s, d, k, dev).view(m, s, d).contiguous()
    seeds = x.view(-1, d)[torch.randperm(m * s, generator=gen, device=dev)[:k]]
    w = torch.ones((m, s), device=dev)
    w[3, s - 1000:] = 0.0
    mr, sr, dr, kr = 5, 1000, 17, 130
    xr = mixture(gen, mr * sr, dr, kr, dev).view(mr, sr, dr).contiguous()
    cr = xr[0, :kr].clone()
    cr[7] = cr[3]                           # duplicates: 7 and 129 empty
    cr[129] = cr[50]
    wr = (torch.rand((mr, sr), generator=gen, device=dev) > 0.3).float()
    wr[2] = 0.0                             # all padding
    wr[4, 600:] = 0.0
    return [("solve8", x, seeds.contiguous(), w),
            ("ragged5", xr, cr.contiguous(), wr)]


def cluster_sizes(x, k: int, prune: str) -> list[int]:
    """The cluster sizes to hold against R = 1: 1, 2, 4, 8, and 16 where
    the card takes it."""
    from repro_torch.kernels import batch_resident as br
    plan = br.cluster_plan(x.shape[0], x.shape[1], k, prune,
                           device=x.device)
    return [r for r, n in plan.fits.items() if n >= 1]


def phase_solve(torch, solve_report: dict) -> bool:
    """The whole-solve kernel against its plain version, and its bitwise
    contracts: every cluster size == R = 1, bounds == exact, batched ==
    resident per lane, repeat."""
    from repro_torch.kernels import batch_resident as br
    from repro_torch.kernels import resident
    dev = torch.device("cuda")
    worst = 0.0
    for tag, x, c, w in solve_stacks(torch, dev):
        for reseed in (False, True):
            ref_out = None
            for prune in ("none", "bounds"):
                kw = dict(max_iters=MAX_ITERS, tol=TOL, reseed_empty=reseed,
                          prune=prune)
                name = f"{tag} reseed={reseed} prune={prune}"
                got = solve_batched(x, c, w, **kw)
                plain = br.lloyd_solve_plain(x, c, w, **kw)
                torch.cuda.synchronize()
                ok, err = compare_solve(name, got, plain, torch)
                worst = max(worst, err)
                rs = cluster_sizes(x, c.shape[0], prune)
                one = solve_batched(x, c, w, cluster=1, **kw)
                across = {r: identical(solve_batched(x, c, w, cluster=r,
                                                     **kw), one)
                          for r in rs}
                across["rule"] = identical(got, one)
                again = solve_batched(x, c, w, **kw)
                lanes = [resident.lloyd_solve_resident(
                    x[i], c, w[i], **kw) for i in range(x.shape[0])]
                torch.cuda.synchronize()
                rep = identical(got, again)
                per_lane = identical(
                    got[:4], [torch.stack(p) for p in zip(*lanes)])
                vs_exact = True
                if ref_out is None:
                    ref_out = got
                else:
                    vs_exact = identical(got[:4], ref_out[:4])
                rule_r = br.cluster_plan(x.shape[0], x.shape[1],
                                         c.shape[0], prune, device=dev).r
                print(f"[solve] {name}: R = 1 against R = "
                      f"{[r for r in across if r != 1]} (the rule's R "
                      f"{rule_r}) bit-identical: {all(across.values())}; "
                      f"repeat bit-identical={rep}, batched "
                      f"== resident per lane={per_lane}, bounds == exact="
                      f"{vs_exact}, passes {got.passes.tolist()}, skipped "
                      f"{int(got.skips[:, 0].sum())}/"
                      f"{int(got.skips[:, 1].sum())} lane-blocks",
                      flush=True)
                if not (ok and rep and per_lane and vs_exact
                        and all(across.values())):
                    print(f"[solve] FAIL bit-identical across R: {across}",
                          flush=True)
                    return False
    # one seed block a lane (each a different cut of the data, duplicates
    # kept so that reseed fires): against the plain version, one resident
    # solve a lane from its own seeds, and R = 1; the shared seeds given to
    # every lane are the shared launch bit for bit
    for tag, x, c, w in solve_stacks(torch, dev):
        m, k = x.shape[0], c.shape[0]
        seeds = torch.stack([x[(i + 1) % m, 7 * i:7 * i + k]
                             for i in range(m)])
        seeds[:, 7] = seeds[:, 3]
        seeds = seeds.contiguous()
        every = c.expand(m, *c.shape).contiguous()
        for prune in ("none", "bounds"):
            kw = dict(max_iters=MAX_ITERS, tol=TOL, reseed_empty=True,
                      prune=prune)
            name = f"{tag} per-lane seeds prune={prune}"
            got = solve_batched(x, seeds, w, **kw)
            plain = br.lloyd_solve_plain(x, seeds, w, **kw)
            torch.cuda.synchronize()
            ok, err = compare_solve(name, got, plain, torch)
            worst = max(worst, err)
            lanes = [resident.lloyd_solve_resident(x[i], seeds[i], w[i], **kw)
                     for i in range(m)]
            per_lane = identical(got[:4],
                                 [torch.stack(p) for p in zip(*lanes)])
            r_one = identical(solve_batched(x, seeds, w, cluster=1, **kw),
                              got)
            shared = identical(solve_batched(x, every, w, **kw),
                               solve_batched(x, c, w, **kw))
            differ = not identical(got[:4], solve_batched(x, c, w, **kw)[:4])
            print(f"[solve] {name}: == resident per lane from its own seeds "
                  f"{per_lane}, R = 1 bit-identical {r_one}, shared seeds "
                  f"as (M, k, d) == shared launch {shared}, differs from the "
                  f"shared seeds' solve {differ}, iters "
                  f"{got.iters.tolist()}", flush=True)
            if not (ok and per_lane and r_one and shared and differ):
                print("[solve] FAIL per-lane seeds", flush=True)
                return False
    solve_report["max_abs_err"] = worst
    return True


def phase_small(torch) -> bool:
    """The whole pipeline on a small input, card against CPU (plain
    versions): subset ids and iterations exact, SSE within rtol 1e-4, on
    the fused and the batched engine."""
    import numpy as np
    from repro_torch.core import IPKMeansConfig, KMeansParams, ipkmeans
    from repro_torch.core.ipkmeans import _partition_and_pack
    rng = np.random.default_rng(SEED)
    x = (rng.normal(size=(2048, 8)) * 3.0).astype(np.float32)
    init = x[rng.choice(2048, 16, replace=False)]
    ok = True
    for backend in ("fused", "batched"):
        cfg = IPKMeansConfig(num_clusters=16, num_subsets=8,
                             kmeans=KMeansParams(max_iters=50, tol=TOL,
                                                 backend=backend,
                                                 reseed_empty=True))
        g = ipkmeans(x, init, cfg, device="cuda")
        h = ipkmeans(x, init, cfg, device="cpu")
        ids_g = _partition_and_pack(torch.as_tensor(x, device="cuda"),
                                    cfg)[0]
        ids_h = _partition_and_pack(torch.as_tensor(x), cfg)[0]
        same_ids = torch.equal(ids_g.subset_ids.cpu(), ids_h.subset_ids)
        same_iters = torch.equal(g.subset_iters.cpu(), h.subset_iters)
        rel = abs(float(g.sse) - float(h.sse)) / float(h.sse)
        print(f"[small] {backend}: n=2048 d=8 K=16 M=8: subset ids equal="
              f"{same_ids}, iters equal={same_iters} "
              f"({h.subset_iters.tolist()}), sse card {float(g.sse):.6f} cpu "
              f"{float(h.sse):.6f} rel {rel:.3g}", flush=True)
        ok = ok and same_ids and same_iters and rel <= 1e-4 and bool(
            torch.isfinite(g.centroids).all())
    return ok


def counted_modules() -> dict:
    """Each kernel's name -> the wrapper module that counts its launches."""
    from repro_torch.kernels import (assign, batch_resident, centroid_update,
                                     fused, init, resident)
    return {"fused_lloyd": fused, "lloyd_solve_batched": batch_resident,
            "lloyd_solve_resident": resident, "assign": assign,
            "centroid_update": centroid_update, "init_sweep": init}


def reset_counts():
    for mod in counted_modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in counted_modules().items()}


def counts_of(**nonzero) -> dict:
    """The launch counts of a run that launched only the kernels named."""
    return {**dict.fromkeys(counted_modules(), 0), **nonzero}


def run_path(torch, x, init, cfg, dev, generator=None):
    """One ipkmeans call through the entry point, the counts set to 0 just
    before and read just after: (result, seconds, counts)."""
    from repro_torch.core import ipkmeans
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = ipkmeans(x, init, cfg, generator=generator, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return res, secs, read_counts()


def stage_times(torch, x, init, cfg, dev, generator=None):
    """S1, S2, S3 run one at a time, each timed: (s1, s2, s3, stack, masks,
    S2 result)."""
    from repro_torch.core.ipkmeans import _merge_stage, _partition_and_pack
    from repro_torch.core.kmeans import kmeans_batched
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, subsets, masks = _partition_and_pack(x, cfg, generator=generator)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stage = kmeans_batched(subsets, masks, init, cfg.kmeans, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _merge_stage(x, stage, cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return t1 - t0, t2 - t1, t3 - t2, subsets, masks, stage


def phase_main(torch, report: dict, solve_report: dict):
    """The main path on both engines; returns the main input, its seeds, the
    batched stack and both runs for the later phases, or None when a check
    failed."""
    import numpy as np
    from repro_torch.core import IPKMeansConfig, KMeansParams
    from repro_torch.kernels import batch_resident as br
    from repro_torch.kernels import fused
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    x = mixture(gen, N, D, K, dev)
    init = x[torch.as_tensor(np.random.default_rng(SEED).choice(
        N, K, replace=False), device=dev)]
    torch.cuda.synchronize()
    print(f"[main] data: n={N} d={D} f32 ({x.numel() * 4 / 1e9:.2f} GB) "
          f"from a seeded mixture of {K} Gaussians, {K} seeds from the data,"
          f" in {time.perf_counter() - t0:.3f} s", flush=True)
    one = 0.0
    mean = x.double().mean(0)
    for lo in range(0, N, 1 << 21):
        one += float(torch.sum((x[lo:lo + (1 << 21)].double() - mean) ** 2))

    def config(backend, prune="none"):
        return IPKMeansConfig(num_clusters=K, num_subsets=M,
                              kmeans=KMeansParams(
                                  max_iters=MAX_ITERS, tol=TOL,
                                  backend=backend, reseed_empty=True,
                                  prune=prune))

    def sane(res):
        sse_f = float(res.sse)
        return (np.isfinite(sse_f) and sse_f < one
                and tuple(res.centroids.shape) == (K, D)
                and bool(torch.isfinite(res.centroids).all()))

    def describe(tag, res, secs, counts, stages):
        it = res.subset_iters.float()
        print(f"[main] {tag}: K={K} M={M} depth={res.kd_depth} max_iters="
              f"{MAX_ITERS} tol={TOL} reseed_empty=True: {secs:.3f} s, "
              f"launches {counts}", flush=True)
        print(f"[main] {tag} stages: S1 {stages[0]:.3f} s, S2 "
              f"{stages[1]:.3f} s, S3 {stages[2]:.3f} s", flush=True)
        print(f"[main] {tag} subset_iters min/median/max "
              f"{int(it.min())}/{float(it.median()):.0f}/{int(it.max())}, "
              f"lanes at max_iters "
              f"{int((res.subset_iters >= MAX_ITERS).sum())}; SSE "
              f"{float(res.sse):.6e} (one-centroid SSE {one:.6e}, ratio "
              f"{float(res.sse) / one:.4f})", flush=True)

    # the first slice's path: fused engine, one launch per Lloyd trip
    cfg_f = config("fused")
    res_f, secs_f, counts_f = run_path(torch, x, init, cfg_f, dev)
    st_f = stage_times(torch, x, init, cfg_f, dev)
    describe("fused", res_f, secs_f, counts_f, st_f)
    report["launches"] = counts_f["fused_lloyd"]
    again = torch.equal(st_f[5].iters, res_f.subset_iters)

    # this slice's path: the whole stack in one whole-solve launch
    cfg_b = config("batched")
    res_b, secs_b, counts_b = run_path(torch, x, init, cfg_b, dev)
    st_b = stage_times(torch, x, init, cfg_b, dev)
    describe("batched", res_b, secs_b, counts_b, st_b)
    solve_report["launches"] = counts_b["lloyd_solve_batched"]
    res_p, secs_p, counts_p = run_path(torch, x, init,
                                       config("batched", "bounds"), dev)
    it_p = res_p.subset_iters.float()
    print(f"[main] batched prune=bounds: {secs_p:.3f} s, launches "
          f"{counts_p}, subset_iters min/median/max {int(it_p.min())}/"
          f"{float(it_p.median()):.0f}/{int(it_p.max())}", flush=True)

    n_diff = int((res_b.subset_iters != res_f.subset_iters).sum())
    c_rel = float(torch.max(torch.abs(res_b.intermediate - res_f.intermediate)
                            / torch.clamp(torch.abs(res_f.intermediate),
                                          min=1e-6)))
    sse_rel = abs(float(res_b.sse) - float(res_f.sse)) / float(res_f.sse)
    bounds_same = (torch.equal(res_p.intermediate, res_b.intermediate)
                   and torch.equal(res_p.subset_iters, res_b.subset_iters)
                   and torch.equal(res_p.sse, res_b.sse)
                   and torch.equal(res_p.centroids, res_b.centroids))
    print(f"[main] batched against fused: lanes whose iters differ {n_diff},"
          f" max relative centroid difference {c_rel:.3g}, SSE "
          f"{float(res_b.sse):.6e} vs {float(res_f.sse):.6e} (rel "
          f"{sse_rel:.3g}, rtol {MAIN_SSE_RTOL}); bounds bit-identical to "
          f"exact: {bounds_same}", flush=True)
    ok = (again and sane(res_f) and sane(res_b)
          and counts_f["fused_lloyd"] > 0
          and counts_b == counts_of(lloyd_solve_batched=1)
          and counts_p["lloyd_solve_batched"] == 1
          and n_diff == 0 and sse_rel <= MAIN_SSE_RTOL and bounds_same)
    if not ok:
        print("[main] FAIL", flush=True)
        return None

    # the whole-solve kernel at the whole stack: times, work, bound
    subsets, masks = st_b[3], st_b[4].float()
    kw = dict(max_iters=MAX_ITERS, tol=TOL, reseed_empty=True)
    plan = br.cluster_plan(subsets.shape[0], subsets.shape[1], K, device=dev)
    print(f"[main] cluster rule: R = {plan.r} blocks a lane for M = "
          f"{subsets.shape[0]} lanes of {subsets.shape[1]} rows (clusters "
          f"the card holds at once, by R: {plan.fits}; rows split in units "
          f"of {plan.unit})", flush=True)
    ms = cuda_time_ms(lambda: solve_batched(subsets, init, masks, **kw),
                      reps=2, warmup=1)
    out = solve_batched(subsets, init, masks, **kw)
    ms_b = cuda_time_ms(lambda: solve_batched(subsets, init, masks,
                                               prune="bounds", **kw),
                        reps=2, warmup=1)
    out_b = solve_batched(subsets, init, masks, prune="bounds", **kw)
    m_, s_, d_ = subsets.shape
    passes = int(out.passes.sum())
    bound, by = solve_bound_ms(s_, d_, K, m_, passes, 0, MAX_ITERS)
    bb = br._bound_blocks(s_, "bounds", None)[0]
    skipped = int(out_b.skips[:, 0].sum())
    live = int(out_b.skips[:, 1].sum())
    bound_b, _ = solve_bound_ms(s_, d_, K, m_, int(out_b.passes.sum()),
                                skipped * bb, MAX_ITERS)
    fused_s2_ms = st_f[1] * 1e3
    tflops = 2.0 * K * d_ * s_ * passes / (ms * 1e-3) / 1e12
    print(f"[main] whole-solve kernel, {m_}x{s_}x{d_}, k={K}: {ms:.4f} ms "
          f"({passes} score passes, {tflops:.2f} TFLOP/s), bound "
          f"{bound:.4f} ms ({by}); "
          f"prune=bounds {ms_b:.4f} ms, skipped {skipped}/{live} lane-blocks "
          f"({skipped / max(live, 1):.4f}), bound {bound_b:.4f} ms; the fused"
          f" engine's S2 on the same stack {fused_s2_ms:.4f} ms", flush=True)

    # at every cluster size: the whole solve (bit-identical to the rule's
    # R), and one score pass per lane and nothing else (max_iters=0), of the
    # whole stack and of one lane alone
    x1, w1 = subsets[:1].contiguous(), masks[:1].contiguous()
    flop_pass = 2.0 * K * d_ * s_
    by_r = {}
    for r in cluster_sizes(subsets, K, "none"):
        whole = cuda_time_ms(lambda: solve_batched(
            subsets, init, masks, cluster=r, **kw), reps=2, warmup=1)
        same = identical(solve_batched(subsets, init, masks, cluster=r, **kw),
                         out)
        stack_pass = cuda_time_ms(lambda: solve_batched(
            subsets, init, masks, cluster=r, max_iters=0), reps=3, warmup=1)
        lane_pass = cuda_time_ms(lambda: solve_batched(
            x1, init, w1, cluster=r, max_iters=0), reps=3, warmup=1)
        fit = br.cluster_plan(m_, s_, K, device=dev, cluster=r).clusters
        by_r[r] = dict(whole_ms=whole, stack_pass_ms=stack_pass,
                       lane_pass_ms=lane_pass, clusters_at_once=fit)
        print(f"[main] R = {r} ({fit} clusters at once on the card): "
              f"whole solve {whole:.4f} ms "
              f"({flop_pass * passes / (whole * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{bound / whole:.1%} of the bound), bit-identical to the "
              f"rule's R: {same}; one score pass (max_iters=0) of the stack "
              f"{stack_pass:.4f} ms ({flop_pass * m_ / (stack_pass * 1e-3) / 1e12:.2f} "
              f"TFLOP/s), of one lane alone {lane_pass:.4f} ms "
              f"({flop_pass / (lane_pass * 1e-3) / 1e12:.3f} TFLOP/s)",
              flush=True)
        if not same:
            print(f"[main] FAIL R = {r} differs from the rule's R",
                  flush=True)
            return None
    one_pass = by_r[plan.r]["stack_pass_ms"]
    lane_pass = min(v["lane_pass_ms"] for v in by_r.values())

    # stacks between a lone lane and the whole: the first m lanes, whole
    # solves at every R, bit-identical to the rule's R
    by_lanes = {}
    for m in MID_LANES:
        xm, wm = subsets[:m].contiguous(), masks[:m].contiguous()
        rule_r = br.cluster_plan(m, s_, K, device=dev).r
        want = solve_batched(xm, init, wm, **kw)
        times = {}
        for r in cluster_sizes(xm, K, "none"):
            times[r] = cuda_time_ms(lambda: solve_batched(
                xm, init, wm, cluster=r, **kw), reps=2, warmup=1)
            if not identical(solve_batched(xm, init, wm, cluster=r, **kw),
                             want):
                print(f"[main] FAIL {m} lanes: R = {r} differs from the "
                      f"rule's R", flush=True)
                return None
        by_lanes[m] = dict(rule_r=rule_r, whole_ms=times,
                           passes=int(want.passes.sum()))
        print(f"[main] the first {m} lanes ({int(want.passes.sum())} score "
              f"passes): the rule picks R = {rule_r}; whole solve "
              + ", ".join(f"R = {r} {t:.4f} ms" for r, t in times.items())
              + "; every R bit-identical", flush=True)

    # an 8-lane slice: kernel against its plain version, and their times
    xs, ws = subsets[:PLAIN_LANES].contiguous(), masks[:PLAIN_LANES]
    got = solve_batched(xs, init, ws, **kw)
    plain = br.lloyd_solve_plain(xs, init, ws, **kw)
    torch.cuda.synchronize()
    ok, err = compare_solve(f"main {PLAIN_LANES}-lane slice", got, plain,
                            torch)
    ms8 = cuda_time_ms(lambda: solve_batched(xs, init, ws, **kw), reps=2,
                       warmup=1)
    plain_ms = cuda_time_ms(lambda: br.lloyd_solve_plain(xs, init, ws, **kw),
                            reps=2, warmup=1)
    bound8, _ = solve_bound_ms(s_, d_, K, PLAIN_LANES, int(got.passes.sum()),
                               0, MAX_ITERS)
    print(f"[main] {PLAIN_LANES}-lane slice: kernel {ms8:.4f} ms, plain "
          f"version {plain_ms:.4f} ms, bound {bound8:.4f} ms", flush=True)
    solve_report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, library_ms=None,
                        max_abs_err=max(err, solve_report["max_abs_err"]),
                        ms_bounds=ms_b, bound_ms_bounds=bound_b,
                        skip_fraction=skipped / max(live, 1),
                        plain_lanes=PLAIN_LANES, ms_plain_lanes=ms8,
                        bound_ms_plain_lanes=bound8,
                        fused_s2_ms=fused_s2_ms, one_pass_ms=one_pass,
                        one_lane_pass_ms=lane_pass, cluster_r=plan.r,
                        by_cluster=by_r, by_lanes=by_lanes)
    if not ok:
        return None

    # one step of the fused pass over the whole stack at its converged
    # centroids: the shape of the first slice's launches, and each pass's
    # device time
    cents = res_f.intermediate.contiguous()
    report.update(time_step("stack", subsets, cents, masks, reps=3))
    report["stack_passes"] = pass_times(
        torch, lambda: fused.fused_lloyd(subsets, cents, masks))
    print(f"[stack] device ms a call by kernel (torch.profiler): "
          f"{json.dumps(report['stack_passes'])}", flush=True)
    return dict(x=x, init=init, subsets=subsets, masks=masks, res_f=res_f,
                res_b=res_b, counts_f=counts_f, s2_fused=st_f[1],
                secs_b=secs_b, stages_b=st_b[:3], one=one, config=config,
                sane=sane, describe=describe)


def phase_resident(torch, report: dict, main: dict) -> bool:
    """One full-width solve (lane 0 of the main path's stack) through
    ``kmeans(..., backend="resident")``, then the wrapper's times."""
    from repro_torch.core import KMeansParams
    from repro_torch.core.kmeans import kmeans
    from repro_torch.kernels import batch_resident as br
    from repro_torch.kernels import resident
    subsets, masks, init = main["subsets"], main["masks"], main["init"]
    x0, w0 = subsets[0], masks[0]
    params = KMeansParams(max_iters=MAX_ITERS, tol=TOL, backend="resident",
                          reseed_empty=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = kmeans(x0, init, w0.bool(), params, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    report["launches"] = counts["lloyd_solve_resident"]
    kw = dict(max_iters=MAX_ITERS, tol=TOL, reseed_empty=True)
    ms = cuda_time_ms(lambda: resident.lloyd_solve_resident(x0, init, w0,
                                                            **kw),
                      reps=3, warmup=1)
    plain_ms = cuda_time_ms(lambda: br.lloyd_solve_plain(
        x0[None], init, w0[None], **kw), reps=3, warmup=1)
    got = resident_out(x0, init, w0, **kw)
    plain = br.lloyd_solve_plain(x0[None], init, w0[None], **kw)
    torch.cuda.synchronize()
    ok, err = compare_solve("resident", got, plain, torch)
    s_, d_ = x0.shape
    bound, by = solve_bound_ms(s_, d_, K, 1, int(got.passes.sum()), 0,
                               MAX_ITERS)
    # the same solve at every cluster size, bit-identical to the rule's
    plan = br.cluster_plan(1, s_, K, device=x0.device)
    by_r = {}
    for r in cluster_sizes(x0[None], K, "none"):
        by_r[r] = cuda_time_ms(lambda: resident_out(x0, init, w0, cluster=r,
                                                    **kw), reps=3, warmup=1)
        ok = ok and identical(resident_out(x0, init, w0, cluster=r, **kw),
                              got)
    # the same solve on the fused engine (one launch per trip), beside it
    # (host clock, a host loop: the median of 5 runs after one warm-up)
    fused_params = params._replace(backend="fused")
    kmeans(x0, init, w0.bool(), fused_params, device="cuda")
    fused_runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_f = kmeans(x0, init, w0.bool(), fused_params, device="cuda")
        torch.cuda.synchronize()
        fused_runs.append((time.perf_counter() - t0) * 1e3)
    fused_ms = sorted(fused_runs)[2]
    print(f"[resident] kmeans(backend='resident') on lane 0 "
          f"({s_}x{d_}, k={K}): {secs:.3f} s, iters {int(res.iters)} "
          f"({int(got.passes[0])} score passes), launches {counts}; kernel "
          f"{ms:.4f} ms, plain version {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), R = {plan.r} blocks (the rule for a "
          f"lone lane); the fused engine's solve {fused_ms:.4f} "
          f"ms (median of {len(fused_runs)}, range {min(fused_runs):.4f}-"
          f"{max(fused_runs):.4f}), iters {int(res_f.iters)}", flush=True)
    print(f"[resident] the same solve at each R, bit-identical to the "
          f"rule's R: {ok}: " + ", ".join(f"R = {r} {t:.4f} ms"
                                          for r, t in by_r.items()),
          flush=True)
    report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=None, max_abs_err=err, cluster_r=plan.r,
                  fused_solve_ms=fused_ms, by_cluster=by_r)
    return ok and counts == counts_of(lloyd_solve_resident=1) and bool(
        torch.equal(res.iters.reshape(1), got.iters)) and int(
        res_f.iters) == int(res.iters)


def recover_run(torch, main: dict, fail_at):
    """One ``ipkmeans_recoverable`` call at [main]'s size on ``batched``,
    the counts set to 0 just before and read just after; the lanes of each
    whole-solve call and the S2 wall time (the recovery loop, the card
    synchronised at both ends) are recorded by wrappers that only watch."""
    from repro_torch.core import ipkmeans_recoverable
    from repro_torch.distributed import runtime
    from repro_torch.kernels import engine
    lanes, s2 = [], {}
    solve = engine.BatchedEngine.solve_batched
    loop = runtime.solve_stacks_with_recovery

    def counted(self, subsets, *args, **kw):
        lanes.append(int(subsets.shape[0]))
        return solve(self, subsets, *args, **kw)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loop(*args, **kw)
        torch.cuda.synchronize()
        s2["s"] = time.perf_counter() - t0
        return out

    with mock.patch.object(engine.BatchedEngine, "solve_batched", counted), \
            mock.patch.object(runtime, "solve_stacks_with_recovery", timed):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res, log, work = ipkmeans_recoverable(
            main["x"], main["init"], main["config"]("batched"),
            num_workers=RECOVER_WORKERS, iters_per_round=RECOVER_ITERS,
            snapshot_every=RECOVER_SNAPSHOT, fail_at=fail_at,
            device=main["x"].device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
    by_stack = [sum(1 for *_, st in work if st == s)
                for s in range(RECOVER_WORKERS)]
    return dict(res=res, log=log, work=work, secs=secs, counts=counts,
                s2=s2["s"], lanes=lanes, by_stack=by_stack,
                rounds=1 + max(rnd for rnd, _, _ in work))


def phase_recover(torch, solve_report: dict, fused_report: dict,
                  main: dict) -> bool:
    """[recover]: IPKMeans with S2 under the fault-tolerance runtime at
    [main]'s size, crash-free and with one crash: each bit for bit [main]'s
    ``batched`` run (centroids, intermediate centroids, iterations; the
    lane and total SSEs bit for bit or within RECOVER_SSE_RTOL), one
    whole-solve launch a stack a round on its unconverged lanes and one
    fused launch for the lane SSEs, and only the crashed stack advanced
    more often than in the crash-free run."""
    res_b = main["res_b"]
    per = M // RECOVER_WORKERS
    stack_max = res_b.subset_iters.view(RECOVER_WORKERS, per).amax(dim=1)
    victim = int(torch.argmax(stack_max))
    if int(stack_max[victim]) <= RECOVER_ITERS * RECOVER_CRASH_ROUND:
        print(f"[recover] FAIL no stack is unconverged at round "
              f"{RECOVER_CRASH_ROUND} (stacks' largest iterations "
              f"{stack_max.tolist()})", flush=True)
        return False
    runs = {"crash-free": recover_run(torch, main, None),
            "one crash": recover_run(torch, main,
                                     {RECOVER_CRASH_ROUND: victim})}
    ok = True
    for tag, run in runs.items():
        res = run["res"]
        bits = {f: torch.equal(getattr(res, f), getattr(res_b, f))
                for f in ("centroids", "intermediate", "subset_iters",
                          "asses", "sse")}
        rel = {f: float(torch.max(torch.abs(getattr(res, f).double()
                                            - getattr(res_b, f).double())
                                  / torch.clamp(torch.abs(
                                      getattr(res_b, f).double()),
                                      min=1e-30)))
               for f in ("asses", "sse")}
        want_counts = counts_of(lloyd_solve_batched=len(run["work"]),
                                fused_lloyd=1)
        good = (bits["centroids"] and bits["intermediate"]
                and bits["subset_iters"]
                and all(v <= RECOVER_SSE_RTOL for v in rel.values())
                and run["counts"] == want_counts
                and len(run["lanes"]) == len(run["work"]))
        print(f"[recover] {tag}: {RECOVER_WORKERS} workers x {per} lanes, "
              f"{RECOVER_ITERS} iterations a round, a snapshot every "
              f"{RECOVER_SNAPSHOT} rounds: {run['secs']:.3f} s, S2 "
              f"{run['s2']:.3f} s ([main]'s batched S2 "
              f"{main['stages_b'][1]:.3f} s, one whole-solve launch); "
              f"{run['rounds']} rounds, {len(run['work'])} whole-solve "
              f"launches (stacks x rounds, active lanes only: "
              f"{sum(run['lanes'])} lane-rounds, by launch {run['lanes']}), "
              f"advances by stack {run['by_stack']}; launches "
              f"{run['counts']}; bit for bit [main]'s batched run: {bits}; "
              f"largest relative difference of the lane SSEs "
              f"{rel['asses']:.3g} and the SSE {rel['sse']:.3g} (rtol "
              f"{RECOVER_SSE_RTOL})", flush=True)
        ok = ok and good
    free, crash = runs["crash-free"], runs["one crash"]
    rec = [e for e in crash["log"] if e[0] == "recover"]
    others = [s for s in range(RECOVER_WORKERS) if s != victim]
    only = (bool(rec) and rec[0][2] == (victim,)
            and crash["by_stack"][victim] > free["by_stack"][victim]
            and all(crash["by_stack"][s] == free["by_stack"][s]
                    for s in others))
    redone = sum(crash["lanes"]) - sum(free["lanes"])
    print(f"[recover] crash of worker {victim} (its stack's lanes take up to "
          f"{int(stack_max[victim])} iterations) at round "
          f"{RECOVER_CRASH_ROUND}: {rec[0] if rec else 'no recovery'}; its "
          f"stack advanced {crash['by_stack'][victim]} times against "
          f"{free['by_stack'][victim]}, the others as often as crash-free: "
          f"{only}; recomputed {redone} lane-rounds "
          f"({crash['by_stack'][victim] - free['by_stack'][victim]} "
          f"launches); S2 {crash['s2']:.3f} s against {free['s2']:.3f} s "
          f"crash-free; {nvidia_smi_line()}", flush=True)
    solve_report.setdefault("launches_by_path", {}).update({
        "recover crash-free": free["counts"]["lloyd_solve_batched"],
        "recover one crash": crash["counts"]["lloyd_solve_batched"]})
    fused_report.setdefault("launches_by_path", {})[
        "recover lane SSEs"] = free["counts"]["fused_lloyd"]
    print(json.dumps({"recover": {
        tag: dict(secs=r["secs"], s2_s=r["s2"], rounds=r["rounds"],
                  launches=len(r["work"]), lane_rounds=sum(r["lanes"]),
                  by_stack=r["by_stack"])
        for tag, r in runs.items()} | {
            "main_s2_s": main["stages_b"][1], "victim": victim,
            "recomputed_lane_rounds": redone}}), flush=True)
    if not (ok and only and redone > 0):
        print("[recover] FAIL", flush=True)
        return False
    return True


def phase_ckpt(torch, main: dict) -> bool:
    """[ckpt]: an ``AsyncCheckpointer`` round trip of [main]'s batched
    centroids on the card, float32 and bfloat16, restored to the card bit
    for bit."""
    import tempfile
    from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
    res = main["res_b"]
    tree = {"intermediate": res.intermediate, "final": res.centroids,
            "bf16": [res.intermediate.to(torch.bfloat16),
                     res.centroids.to(torch.bfloat16)],
            "iters": res.subset_iters}
    nbytes = sum(t.numel() * t.element_size() for t in (
        tree["intermediate"], tree["final"], *tree["bf16"], tree["iters"]))
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d, keep=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, tree)
        t_copy = time.perf_counter() - t0
        ck.wait()
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, got = restore_latest(d, tree)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    pairs = [(got["intermediate"], tree["intermediate"]),
             (got["final"], tree["final"]), (got["iters"], tree["iters"]),
             *zip(got["bf16"], tree["bf16"])]
    ok = step == 1 and all(
        a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
        for a, b in pairs)
    print(f"[ckpt] AsyncCheckpointer: {nbytes / 1e6:.1f} MB of [main]'s "
          f"batched centroids (f32 and bf16) and iterations: host copy "
          f"{t_copy:.3f} s, written {t_save:.3f} s, restored to the card "
          f"{t_load:.3f} s; bit for bit on the card: {ok}", flush=True)
    return ok


def serve_rows(torch, gen, centers, n: int, drift: float = 0.0):
    """n rows of the main mixture (centres ``centers``), shifted by
    ``drift``."""
    comp = torch.randint(0, K, (n,), generator=gen, device=centers.device)
    return centers[comp] + drift + torch.randn(
        (n, D), generator=gen, device=centers.device)


def fifo_steps(sizes, top: int) -> list[list[int]]:
    """The reference's coalescing rule: each step takes queued requests
    first in first out while they fit the top bucket together, the first
    one always -> the ticket lists of the steps."""
    steps, i = [], 0
    while i < len(sizes):
        take, rows = [i], sizes[i]
        i += 1
        while i < len(sizes) and rows + sizes[i] <= top:
            take.append(i)
            rows += sizes[i]
            i += 1
        steps.append(take)
    return steps


def use_cache(path: str):
    """The tuning cache at ``path`` for the duration of a ``with``."""
    import os
    from repro_torch.kernels import tuning
    patch = mock.patch.dict(os.environ, {tuning.ENV_CACHE_PATH: path})
    patch.start()
    tuning.reload_cache()
    return patch


def phase_serve(torch, report: dict, main: dict) -> bool:
    """[serve]: ``NearestCentroidServer`` over [main]'s batched centroids
    (K = 1024, d = 64, f32, counts the main input's cluster sizes),
    ``BucketPolicy()``, an empty tuning cache.  A stream of SERVE_REQUESTS
    requests and SERVE_BIG chunked ones, one dispatch each, with a refresh on
    ``fused`` every SERVE_REFRESH_EVERY dispatches, the counts set to 0
    just before and read just after and the plain versions watched; then the
    checks: the served rows against the unpadded launch (each epoch between
    refreshes, and each bucket), coalesced dispatch against direct assigns
    and the FIFO rule, one build a bucket, the plain version (near-tie rule),
    each refresh against ``twopass`` and the plain oracle, the drift,
    ``tuned`` against ``resident`` on the main stack's first 4 lanes, and a
    cached bf16 spec reaching bucket 4096."""
    import tempfile

    import numpy as np
    from repro_torch.core.kmeans import KMeansParams, update_minibatch
    from repro_torch.core.serve import BucketPolicy, NearestCentroidServer
    from repro_torch.kernels import engine, fused, ops, ref, specs, tuning
    from repro_torch.kernels.fused import AssignOut
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    cents = main["res_b"].centroids.contiguous()
    policy = BucketPolicy()
    top = policy.top
    tmp = tempfile.TemporaryDirectory()
    cache = use_cache(f"{tmp.name}/empty.json")
    try:
        counts = torch.bincount(ops.lloyd_assign_fused(main["x"], cents)[0]
                                .long(), minlength=K).float()
        # the main mixture's centres are mixture()'s first draw
        centers = (torch.rand((K, D), generator=torch.Generator(device=dev)
                              .manual_seed(SEED), device=dev) * 12.0 - 6.0)
        gen = torch.Generator(device=dev).manual_seed(0)
        sizes = torch.randint(1, SERVE_MAX_REQUEST + 1, (SERVE_REQUESTS,),
                              generator=gen, device=dev).tolist()
        every = SERVE_REQUESTS // SERVE_BIG
        stream = []
        for b in range(SERVE_BIG):
            stream += sizes[b * every:(b + 1) * every] + [SERVE_BIG_ROWS]
        rows = serve_rows(torch, gen, centers, sum(stream))
        n_ref = len(stream) // SERVE_REFRESH_EVERY
        batches = [serve_rows(torch, gen, centers, SERVE_REFRESH_ROWS,
                              SERVE_DRIFT * (r + 1)) for r in range(n_ref)]
        drifted = serve_rows(torch, gen, centers, SERVE_REFRESH_ROWS,
                             SERVE_DRIFT * n_ref)
        torch.cuda.synchronize()
        print(f"[serve] K={K} d={D} f32, [main]'s batched centroids, counts "
              f"from the main input's {N} rows; {len(stream)} requests "
              f"({SERVE_REQUESTS} of 1..{SERVE_MAX_REQUEST} rows, {SERVE_BIG}"
              f" of {SERVE_BIG_ROWS}), {sum(stream)} rows; a refresh of "
              f"{SERVE_REFRESH_ROWS} rows every {SERVE_REFRESH_EVERY} "
              f"dispatches, drift {SERVE_DRIFT} a refresh; buckets "
              f"{policy.buckets()}; {smi}", flush=True)

        # the stream, counted, with every plain version watched
        server = NearestCentroidServer(cents, counts, policy=policy,
                                       refresh_backend="fused", device=dev)
        plains = [(fused, "fused_lloyd_plain"), (fused, "plain_assign"),
                  (ref, "assign_ref"), (ref, "centroid_update_ref"),
                  (ref, "lloyd_step_ref"), (ref, "minibatch_update_ref")]
        spies = [mock.patch.object(mod, name, wraps=getattr(mod, name))
                 for mod, name in plains]
        watched = [p.start() for p in spies]
        lat, served, epochs, refreshes = [], [], [], []
        done_ok, off = True, 0
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        try:
            for i, n in enumerate(stream):
                q = rows[off:off + n]
                off += n
                t = server.submit(q)
                ts = time.perf_counter()
                done = server.step()
                out = server.result(t)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - ts)
                served.append(out)
                done_ok = done_ok and done == [t]
                if (i + 1) % SERVE_REFRESH_EVERY == 0:
                    r = len(refreshes)
                    c0, n0 = server.centroids, server.counts
                    epochs.append((off, c0))
                    ts = time.perf_counter()
                    sse = server.refresh(batches[r])
                    torch.cuda.synchronize()
                    refreshes.append((c0, n0, server.centroids,
                                      server.counts, sse,
                                      (time.perf_counter() - ts) * 1e3))
        finally:
            calls = {name: spy.call_count
                     for (_, name), spy in zip(plains, watched)}
            for p in spies:
                p.stop()
        wall = time.perf_counter() - t0
        stream_counts = read_counts()
        epochs.append((off, server.centroids))
        chunks = sum(-(-n // top) for n in stream)
        want_counts = counts_of(fused_lloyd=chunks + len(refreshes))
        ok = (done_ok and stream_counts == want_counts
              and not any(calls.values()))
        report.setdefault("launches_by_path", {}).update({
            "serve dispatches (one a chunk)": chunks,
            "serve refreshes": len(refreshes)})
        print(f"[serve] stream: {len(stream)} dispatches in {wall:.3f} s "
              f"with {len(refreshes)} refreshes, {sum(stream) / wall:.0f} "
              f"rows/s ({sum(stream) / sum(lat):.0f} rows/s over the "
              f"dispatches alone); launches {stream_counts} (want "
              f"{want_counts}: one a chunk, one a refresh); plain-version "
              f"calls {calls}; each step completed its own ticket "
              f"{done_ok}; {smi}", flush=True)

        # latency by bucket (the chunked requests apart)
        by = {}
        for n, t in zip(stream, lat):
            key = policy.bucket_for(n) if n <= top else f"{n} rows chunked"
            by.setdefault(key, []).append(t * 1e3)
        lat_rep = {}
        for key, ts in by.items():
            p50, p99 = np.percentile(ts, 50), np.percentile(ts, 99)
            lat_rep[str(key)] = dict(n=len(ts), p50_ms=p50, p99_ms=p99)
            print(f"[serve] bucket {key}: {len(ts)} dispatches, latency p50 "
                  f"{p50:.4f} ms p99 {p99:.4f} ms; {smi}", flush=True)
        used = {policy.bucket_for(min(top, n - a)) for n in stream
                for a in range(0, n, top)}
        built = dict(server.trace_counts)
        once = (built == dict.fromkeys(used, 1)
                and len(built) <= len(policy.buckets()))
        print(f"[serve] builds per bucket {dict(sorted(built.items()))}: one"
              f" for each bucket used, at most {len(policy.buckets())}: "
              f"{once}", flush=True)
        ok = ok and once

        # the served rows, epoch by epoch, against the unpadded launch and
        # the plain version (the centroids of each epoch)
        labels = torch.cat([o[0] for o in served])
        mind = torch.cat([o[1] for o in served])
        lo, same, n_tie = 0, True, 0
        for e, (hi, c_e) in enumerate(epochs):
            if hi == lo:
                continue
            q = rows[lo:hi]
            whole = ops.lloyd_assign_fused(q, c_e)
            same = (same and torch.equal(whole[0], labels[lo:hi])
                    and torch.equal(whole[1], mind[lo:hi]))
            pa = fused.fused_lloyd_plain(q[None], c_e[None], assign_only=True)
            agree, diff, _ = label_agreement(
                f"serve epoch {e}", q[None], c_e[None],
                AssignOut(labels[None, lo:hi], mind[None, lo:hi]), pa, torch)
            ok = ok and agree
            n_tie += diff
            lo = hi
        # each bucket, at its smallest and largest request, on a fresh
        # server: the bucketed result is the unpadded launch's bit for bit
        fresh = NearestCentroidServer(cents, counts, policy=policy,
                                      device=dev)
        per_bucket = True
        for b in policy.buckets():
            for n in sorted({b // 2 + 1, b}):
                got = fresh.assign(rows[:n])
                want = ops.lloyd_assign_fused(rows[:n], cents)
                per_bucket = (per_bucket and torch.equal(got[0], want[0])
                              and torch.equal(got[1], want[1]))
        print(f"[serve] served rows bit for bit the unpadded launch over "
              f"each epoch: {same}; at each bucket (n = b/2 + 1 and b): "
              f"{per_bucket}; labels differing from the plain version "
              f"{n_tie}, all near-ties", flush=True)
        ok = ok and same and per_bucket
        # where a dispatch's time goes: its device time at each bucket's
        # largest request (torch.profiler) beside the bucket's p50 latency
        dev_rep = {}
        for b in policy.buckets():
            dev_rep[b] = pass_times(torch, lambda: fresh.assign(rows[:b]),
                                    reps=5)
            p50 = lat_rep.get(str(b), {}).get("p50_ms", float("nan"))
            print(f"[serve] bucket {b}: device time a dispatch "
                  f"{sum(dev_rep[b].values()):.4f} ms by kernel {dev_rep[b]}"
                  f", p50 latency {p50:.4f} ms; {smi}", flush=True)
        # the library yardstick of an assign-only dispatch (matmul scores
        # and the row min/argmin) at the smallest and largest bucket
        lib_rep = {b: cuda_time_ms(lambda: library_scores(rows[:b], cents),
                                   reps=20)
                   for b in (policy.buckets()[0], top)}
        print(f"[serve] library yardstick of a dispatch by rows "
              f"(CUDA events): {lib_rep}; {smi}", flush=True)

        # coalesced submit/step against direct assigns and the FIFO rule
        co = stream[:SERVE_COALESCE - 1] + [SERVE_BIG_ROWS]
        starts = np.concatenate([[0], np.cumsum(co)[:-1]]).tolist()
        tickets = [fresh.submit(rows[a:a + n]) for a, n in zip(starts, co)]
        steps = []
        while fresh.pending:
            steps.append(fresh.step())
        want_steps = [[tickets[j] for j in s] for s in fifo_steps(co, top)]
        direct = True
        for t, a, n in zip(tickets, starts, co):
            got, want = fresh.result(t), fresh.assign(rows[a:a + n])
            direct = (direct and torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1]))
        print(f"[serve] coalesced: {len(co)} requests in {len(steps)} "
              f"steps, the reference's FIFO steps {steps == want_steps}, "
              f"each ticket bit for bit its direct assign {direct}",
              flush=True)
        ok = ok and steps == want_steps and direct

        # each refresh: fused against twopass, and against the plain oracle
        fused_p, two_p = (KMeansParams(backend="fused"),
                          KMeansParams(backend="twopass"))
        ref_rep, ref_ok = [], True
        for r, (c0, n0, c1, n1, sse, host_ms) in enumerate(refreshes):
            batch = batches[r]
            two = update_minibatch(batch, c0, n0, params=two_p, device=dev)
            bits = torch.equal(two[0], c1) and torch.equal(two[1], n1)
            sse_rel = abs(float(two[2]) - float(sse)) / float(sse)
            step = fused.fused_lloyd(batch[None], c0[None], return_labels=True)
            lab = step.labels[0]
            ones = torch.ones(batch.shape[0], device=dev)
            sums_p, bc_p = ref.centroid_update_ref(batch, lab, ones, K)
            mag, _ = ref.centroid_update_ref(batch.abs(), lab, ones, K)
            sums_err = float(torch.max((step.sums[0] - sums_p).abs()
                                       / (mag + 1e-6)))
            c_p, n_p = ref.minibatch_merge(c0, n0, sums_p, bc_p)
            tol = (UPDATE_REL * (n0[:, None] * c0.abs() + mag)
                   / torch.clamp(n1[:, None], min=1.0) + 1e-6)
            c_ok = bool(torch.all((c1 - c_p).abs() <= tol))
            plain = ref.minibatch_update_ref(batch, c0, n0)
            pa = AssignOut(*ref.assign_ref(batch, c0))
            agree, diff, _ = label_agreement(
                f"serve refresh {r}", batch[None], c0[None],
                AssignOut(lab[None], step.mind), AssignOut(
                    pa.labels[None], pa.mind[None]), torch)
            sse_plain = abs(float(plain[2]) - float(sse)) / float(plain[2])
            good = (bits and sse_rel <= MAIN_SSE_RTOL
                    and sums_err <= UPDATE_REL
                    and torch.equal(n_p, n1) and c_ok and agree
                    and sse_plain <= SUM_RTOL
                    and (diff > 0 or torch.equal(plain[1], n1)))
            ref_ok = ref_ok and good
            dev_ms = cuda_time_ms(lambda: update_minibatch(
                batch, c0, n0, params=fused_p, device=dev), reps=5)
            step_ms = cuda_time_ms(lambda: fused.fused_lloyd(
                batch[None], c0[None], ones[None]), reps=5)
            lib_ms = cuda_time_ms(lambda: library_step(
                batch[None], c0[None], ones[None]), reps=5)
            bound, by_what = step_bound_ms(1, SERVE_REFRESH_ROWS, D, K)
            ref_rep.append(dict(host_ms=host_ms, device_ms=dev_ms,
                                step_ms=step_ms, library_ms=lib_ms,
                                bound_ms=bound, sse=float(sse)))
            print(f"[serve] refresh {r}: {host_ms:.4f} ms host clock "
                  f"(merge and SSE read included), {dev_ms:.4f} ms a "
                  f"refresh by CUDA events (its fused step {step_ms:.4f} "
                  f"ms, the library yardstick {lib_ms:.4f} ms), bound "
                  f"{bound:.4f} ms "
                  f"({by_what}); twopass: centroids and counts bit for bit "
                  f"{bits}, SSE rel {sse_rel:.3g} (rtol {MAIN_SSE_RTOL}); "
                  f"plain: sums worst {sums_err:.3g} of their magnitude "
                  f"(tol {UPDATE_REL}), merged centroids within tolerance "
                  f"{c_ok}, counts equal {torch.equal(n_p, n1)}, SSE rel "
                  f"{sse_plain:.3g}: passes {good}; {smi}", flush=True)
        stale = float(torch.sum(ops.lloyd_assign_fused(drifted, cents)[1]))
        fresh_sse = float(torch.sum(ops.lloyd_assign_fused(
            drifted, server.centroids)[1]))
        drift_ok = fresh_sse < stale
        print(f"[serve] refresh SSE series {[r['sse'] for r in ref_rep]}; "
              f"a batch drifted by {SERVE_DRIFT * n_ref}: SSE against the "
              f"refreshed centroids {fresh_sse:.6e}, against the stale "
              f"ones {stale:.6e}: refreshed lower {drift_ok}", flush=True)
        ok = ok and ref_ok and drift_ok

        # tuned with the empty cache: resident, on the main stack's first
        # lanes
        xs = main["subsets"][:BF16_RESIDENT_LANES].contiguous()
        ws = main["masks"][:BF16_RESIDENT_LANES].contiguous()
        kw = dict(max_iters=MAX_ITERS, tol=TOL, reseed_empty=True)
        tuned = engine.get_engine("tuned").solve_batched(xs, main["init"],
                                                         ws, **kw)
        res = engine.get_engine("resident").solve_batched(xs, main["init"],
                                                          ws, **kw)
        tuned_ok = identical(tuned, res)
        print(f"[serve] tuned with an empty cache on the main stack's first "
              f"{BF16_RESIDENT_LANES} lanes: bit for bit resident "
              f"{tuned_ok}", flush=True)
        ok = ok and tuned_ok
    finally:
        cache.stop()

    # a cached bf16 spec for bucket 4096 under the card's name
    kind = torch.cuda.get_device_name(0)
    bf16 = specs.KernelSpec(acc_dtype="bfloat16")
    key = tuning.cache_key(kind, torch.float32, top, D, K)
    store = tuning.TuningCache.load(f"{tmp.name}/bf16.json")
    store.put(key, bf16)
    cache = use_cache(str(store.save()))
    try:
        bserver = NearestCentroidServer(cents, counts, policy=policy,
                                        device=dev)
        q = rows[:3000]
        got = bserver.assign(q)
        small = bserver.assign(q[:2000])
        plain = fused.fused_lloyd_plain(q[None], cents[None],
                                        assign_only=True, spec=bf16)
        ok_b = bf16_assign_check("serve bf16 bucket 4096", torch, q[None],
                                 cents[None], (got[0][None], got[1][None]),
                                 (plain.labels, plain.mind))[0]
        f32 = fresh.assign(q)
        control = bf16_assign_check("serve bf16 control: f32 bucket", torch,
                                    q[None], cents[None],
                                    (f32[0][None], f32[1][None]),
                                    (plain.labels, plain.mind))[0]
        f32_small = fresh.assign(q[:2000])
        small_ok = (torch.equal(small[0], f32_small[0])
                    and torch.equal(small[1], f32_small[1]))
        print(f"[serve] cache entry {key!r} = {bf16}: bucket {top} passes "
              f"the bf16 checks {ok_b}, the f32 control fails them "
              f"{not control}; bucket 2048 (no "
              f"entry) bit for bit f32 {small_ok}; builds "
              f"{bserver.trace_counts}", flush=True)
        ok = ok and ok_b and not control and small_ok
    finally:
        cache.stop()
        tuning.reload_cache()
        tmp.cleanup()
    print(json.dumps({"serve": dict(
        device=smi, dispatches=len(stream), rows=sum(stream),
        wall_s=wall, rows_per_s=sum(stream) / wall, latency=lat_rep,
        device_ms=dev_rep, library_ms=lib_rep, refreshes=ref_rep,
        launches=stream_counts)}),
        flush=True)
    print(f"[serve] the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not ok:
        print("[serve] FAIL", flush=True)
    return ok


def library_scores(x, c, rows: int = 1 << 14):
    """Yardstick for the assign and init-sweep kernels from PyTorch library
    calls: matmul scores and the row min/argmin, over row chunks.  Timed
    here only; the port never calls it."""
    import torch
    cn = torch.sum(c * c, dim=1)
    return [torch.min(cn - 2.0 * (x[lo:lo + rows] @ c.T), dim=1)
            for lo in range(0, x.shape[0], rows)]


def phase_assign(torch, report: dict):
    """The assign kernel against its plain version on one large ragged lane
    (n = 2**20, k = 4100) and on a ragged 8-lane stack listed out of order,
    with an exact tie and an empty cluster; bit for bit the fused pass's
    assign mode, and a repeat.  Returns the large lane and its labels for
    [update], or None when a check failed."""
    from repro_torch.kernels import assign, fused
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n1, k1 = ASSIGN_N, ASSIGN_K
    x1 = mixture(gen, n1, D, K, dev).unsqueeze(0)
    c1 = x1[:, torch.randperm(n1, generator=gen, device=dev)[:k1]].contiguous()
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    got = assign.assign(x1, c1)
    plain = assign.assign_plain(x1, c1, one)
    torch.cuda.synchronize()
    ok, n_diff, err = label_agreement("assign", x1, c1, got, plain, torch)

    xr = torch.randn((8, 1000, 17), generator=gen, device=dev) * 3.0
    cr = torch.randn((8, 130, 17), generator=gen, device=dev) * 3.0
    cr[:, 7] = cr[:, 3]                     # duplicates: 7 and 129 must lose
    cr[:, 129] = cr[:, 50]
    cr[:, 11] = 1e3                         # nothing maps here
    lanes = torch.tensor([7, 0, 5, 2, 6, 1, 4, 3], dtype=torch.int32,
                         device=dev)
    gr = assign.assign(xr, cr, lanes)
    pr = assign.assign_plain(xr, cr, lanes)
    torch.cuda.synchronize()
    sel = lanes.long()
    ok_r, n_diff_r, err_r = label_agreement("assign ragged", xr[sel],
                                            cr[sel], gr, pr, torch)
    ties = not bool(((gr.labels == 7) | (gr.labels == 129)
                     | (gr.labels == 11)).any())
    fused_same = (identical(got, fused.fused_lloyd(x1, c1, assign_only=True))
                  and identical(gr, fused.fused_lloyd(xr, cr, lanes=lanes,
                                                      assign_only=True)))
    repeat = (identical(got, assign.assign(x1, c1))
              and identical(gr, assign.assign(xr, cr, lanes)))
    torch.cuda.synchronize()
    print(f"[assign] ragged stack: duplicates 7/129 and far cluster 11 took "
          f"no point: {ties}; both inputs bit-identical to the fused pass's "
          f"assign mode: {fused_same}; repeat bit-identical: {repeat}",
          flush=True)
    if not (ok and ok_r and ties and fused_same and repeat):
        print("[assign] FAIL", flush=True)
        return None

    ms = cuda_time_ms(lambda: assign.assign(x1, c1), reps=5)
    plain_ms = cuda_time_ms(lambda: assign.assign_plain(x1, c1, one), reps=2,
                            warmup=1)
    lib_ms = cuda_time_ms(lambda: library_scores(x1[0], c1[0]), reps=2,
                          warmup=1)
    bound, by = bound_ms(2.0 * n1 * k1 * D,
                              4.0 * (n1 * D + k1 * D) + 8.0 * n1)
    print(f"[assign] one lane {n1}x{D}, k={k1}: kernel {ms:.4f} ms "
          f"({2.0 * n1 * k1 * D / (ms * 1e-3) / 1e12:.2f} TFLOP/s), plain "
          f"version {plain_ms:.4f} ms, library yardstick {lib_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by}); labels that differ from the plain "
          f"version (near-ties): {n_diff} of {n1} and {n_diff_r} of "
          f"{gr.labels.numel()}", flush=True)
    report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=lib_ms, max_abs_err=max(err, err_r))
    return x1, c1, got.labels, k1


def library_update(x, lab, w, k):
    """Yardstick for the centroid update from PyTorch library calls:
    ``index_add_`` of the weighted points and ``bincount`` of the weights by
    label.  Timed here only."""
    import torch
    n_l, s, d = x.shape
    flat = (lab.long() + k * torch.arange(n_l, device=x.device).unsqueeze(1)
            ).flatten()
    sums = torch.zeros((n_l * k, d), device=x.device).index_add_(
        0, flat, (x * w.unsqueeze(-1)).reshape(-1, d))
    counts = torch.bincount(flat, weights=w.flatten(), minlength=n_l * k)
    return sums, counts


def pass_times(torch, fn, reps: int = 3) -> dict:
    """Device time of each kernel that ``fn`` launches, from torch.profiler
    over ``reps`` calls after a warm-up -> {kernel: ms a call}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = e.cuda_time_total if t is None else t
        if t > 0:
            name = re.findall(r"(\w+)\(", e.key)
            out[name[0] if name else e.key] = round(t / reps / 1e3, 4)
    return out


def update_checks(torch, tag, x, c, lab, w, k, w_fused=None,
                  long_sums=False):
    """The centroid-update kernel on (x, lab, w) against its plain version
    (counts exact, sums within UPDATE_REL of their largest magnitude, or
    with ``long_sums`` within SEQ_LAMBDA's bound per entry), bit for bit
    against the fused pass's step of x against c (whose labels are lab
    where ``w_fused`` > 0; zero-weight rows add exactly 0) and a repeat ->
    (ok, max abs error, the kernel's output)."""
    from repro_torch.kernels import centroid_update, fused
    lanes = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    got = centroid_update.centroid_update(x, lab, w, k)
    plain = centroid_update.centroid_update_plain(x, lab, w, k, lanes)
    step = fused.fused_lloyd(x, c, w if w_fused is None else w_fused)
    again = centroid_update.centroid_update(x, lab, w, k)
    torch.cuda.synchronize()
    cnt_ok = torch.equal(got[1], plain[1])
    err = float(torch.max(torch.abs(got[0] - plain[0])))
    scale = float(torch.max(torch.abs(plain[0])))
    fused_same = torch.equal(got[0], step.sums) and torch.equal(got[1],
                                                               step.counts)
    repeat = identical(got, again)
    if long_sums:
        terms = centroid_update.centroid_update_plain(
            x, lab, torch.ones_like(w), k, lanes)[1].unsqueeze(-1)
        mag = centroid_update.centroid_update_plain(x.abs(), lab, w.abs(),
                                                    k, lanes)[0]
        tol = 2.0 * SEQ_LAMBDA * torch.sqrt(terms) * 2.0 ** -24 * mag
        ratio = float(torch.max(torch.abs(got[0] - plain[0])
                                / torch.clamp(tol, min=1e-30)))
        sums_ok = ratio <= 1.0
        how = (f"largest |err| / (2 x {SEQ_LAMBDA} sqrt(n) 2^-24 sum|w x|) "
               f"{ratio:.3g}, relative {err / scale:.3g}")
    else:
        sums_ok = err <= UPDATE_REL * scale
        how = f"tol {UPDATE_REL} x {scale:.3g}"
    ok = cnt_ok and sums_ok and fused_same and repeat
    print(f"[update] {tag}: counts equal={cnt_ok}, sums max|err| {err:.3g} "
          f"({how}); bit-identical to the fused pass's sums: {fused_same}; "
          f"repeat bit-identical: {repeat}", flush=True)
    return ok, err, got


def phase_update(torch, report: dict, main: dict, big) -> bool:
    """The assign kernel on the main stack against the fused run's
    converged centroids, held against its plain version; then the
    centroid-update kernel on those labels (the packed masks as weights),
    on [assign]'s one large lane, on that lane skewed (half its rows in
    cluster 0, 10% labelled -1 or k) and on a small case with an empty
    cluster and labels of -1 and k: each against its plain version, bit
    for bit the fused pass's sums on the same labels, and a repeat; then
    its times beside the library yardstick's, and its chunk plans."""
    from repro_torch.kernels import assign, centroid_update
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    subsets, masks = main["subsets"], main["masks"]
    cents = main["res_f"].intermediate.contiguous()
    m, s, d = subsets.shape
    lanes = torch.arange(m, dtype=torch.int32, device=dev)
    ka = assign.assign(subsets, cents)
    pa = assign.assign_plain(subsets, cents, lanes)
    torch.cuda.synchronize()
    lab_ok, n_ties, _ = label_agreement("update", subsets, cents, ka, pa,
                                        torch)
    del pa
    lab = ka.labels
    plan = centroid_update.chunk_plan(m, s, sms)
    print(f"[update] main stack {m}x{s}x{d}, k={K}: the assign kernel's "
          f"labels differ from the plain version's at {n_ties} near-ties; "
          f"chunk plan on {sms} SMs: {plan.chunks} chunk(s) of {plan.rows} "
          f"rows a lane, {m * plan.chunks} blocks", flush=True)
    ok_main, err, _ = update_checks(torch, "main stack", subsets, cents,
                                    lab, masks, K)

    x1, c1, lab1, k1 = big
    n1 = x1.shape[1]
    w1 = torch.ones(x1.shape[:2], device=dev)
    plan1 = centroid_update.chunk_plan(1, n1, sms)
    print(f"[update] one lane {n1}x{D}, k={k1}: chunk plan {plan1.chunks} "
          f"chunks of {plan1.rows} rows, {plan1.segs} prefix segments",
          flush=True)
    ok_big, err_big, _ = update_checks(torch, "one lane", x1, c1, lab1, w1,
                                       k1)
    # the skewed lane: half the rows moved next to centroid 0, which the
    # assign kernel labels 0, and 10% of the rest labelled -1 or k (zero
    # weight in the fused pass's step)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    perm = torch.randperm(n1, generator=gen, device=dev)
    half, bad = perm[:n1 // 2], perm[n1 // 2:n1 // 2 + n1 // 10]
    xs1 = x1.clone()
    xs1[0, half] = c1[0, 0] + 0.3 * torch.randn((half.numel(), D),
                                                generator=gen, device=dev)
    labs = assign.assign(xs1, c1).labels
    labs[0, bad[::2]] = -1
    labs[0, bad[1::2]] = k1
    wf = w1.clone()
    wf[0, bad] = 0.0
    share0 = float((labs == 0).float().mean())
    ok_skew, err_skew, _ = update_checks(
        torch, f"skewed lane ({share0:.3f} of rows in cluster 0)", xs1, c1,
        labs, w1, k1, w_fused=wf, long_sums=True)

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    xs = torch.randn((3, 1000, 17), generator=gen, device=dev) * 3.0
    ws = (torch.rand((3, 1000), generator=gen, device=dev) > 0.3).float()
    ls = torch.randint(0, 130, (3, 1000), generator=gen, device=dev,
                       dtype=torch.int32)
    ls[ls == 11] = 12                       # cluster 11 stays empty
    ls[:, :40] = -1
    ls[:, 40:70] = 130
    gs = centroid_update.centroid_update(xs, ls, ws, 130)
    ps = centroid_update.centroid_update_plain(
        xs, ls, ws, 130, torch.arange(3, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    small_ok = (torch.equal(gs[1], ps[1])
                and bool(torch.allclose(gs[0], ps[0], rtol=UPDATE_REL,
                                        atol=1e-4))
                and float(gs[1].sum()) == float(ws[:, 70:].sum())
                and not bool(gs[1][:, 11].any()))
    print(f"[update] small case with labels -1 and k and an empty cluster "
          f"agrees: {small_ok}", flush=True)
    if not (lab_ok and ok_main and ok_big and ok_skew and share0 > 0.45
            and small_ok):
        print("[update] FAIL", flush=True)
        return False

    ms = cuda_time_ms(lambda: centroid_update.centroid_update(
        subsets, lab, masks, K), reps=20)
    plain_ms = cuda_time_ms(lambda: centroid_update.centroid_update_plain(
        subsets, lab, masks, K, lanes), reps=2, warmup=1)
    lib_ms = cuda_time_ms(lambda: library_update(subsets, lab, masks, K),
                          reps=5, warmup=1)
    bound, by = bound_ms(2.0 * m * s * d,
                         4.0 * (m * s * d + 2 * m * s + m * K * d + m * K))
    big_ms = cuda_time_ms(lambda: centroid_update.centroid_update(
        x1, lab1, w1, k1), reps=20)
    big_lib_ms = cuda_time_ms(lambda: library_update(x1, lab1, w1, k1),
                              reps=5, warmup=1)
    big_bound, _ = bound_ms(2.0 * n1 * D,
                            4.0 * (n1 * (D + 2) + k1 * (D + 1)))
    skew_ms = cuda_time_ms(lambda: centroid_update.centroid_update(
        xs1, labs, w1, k1), reps=3, warmup=1)
    valid = (labs >= 0) & (labs < k1)
    n_valid = int(valid.sum())
    # the yardstick takes in-range labels only: the rows labelled -1 or k
    # carry weight 0
    skew_lib_ms = cuda_time_ms(lambda: library_update(
        xs1, labs.clamp(0, k1 - 1), w1 * valid, k1), reps=3, warmup=1)
    skew_bound, _ = bound_ms(2.0 * n_valid * D,
                             4.0 * (n_valid * D + 2 * n1 + k1 * (D + 1)))
    passes = {tag: pass_times(torch, fn) for tag, fn in (
        ("main stack", lambda: centroid_update.centroid_update(
            subsets, lab, masks, K)),
        ("one lane", lambda: centroid_update.centroid_update(
            x1, lab1, w1, k1)),
        ("skewed lane", lambda: centroid_update.centroid_update(
            xs1, labs, w1, k1)))}
    for tag, times in passes.items():
        print(f"[update] {tag}: device ms a call by pass (torch.profiler): "
              f"{json.dumps(times)}", flush=True)
    print(f"[update] main stack: kernel {ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms, library yardstick {lib_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}); one lane of {n1} points, k={k1}: kernel "
          f"{big_ms:.4f} ms, library yardstick {big_lib_ms:.4f} ms, bound "
          f"{big_bound:.4f} ms; the skewed lane: kernel {skew_ms:.4f} ms, "
          f"library yardstick {skew_lib_ms:.4f} ms, bound "
          f"{skew_bound:.4f} ms", flush=True)
    report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=lib_ms,
                  max_abs_err=max(err, err_big, err_skew),
                  chunk_plan=[plan.rows, plan.chunks], one_lane_ms=big_ms,
                  one_lane_library_ms=big_lib_ms,
                  one_lane_bound_ms=big_bound,
                  one_lane_chunk_plan=[plan1.rows, plan1.chunks],
                  skewed_ms=skew_ms, skewed_bound_ms=skew_bound,
                  skewed_library_ms=skew_lib_ms,
                  passes=passes)
    return True


def sweep_agreement(tag, got, plain, x, u, psi_prev, ell, torch):
    """An init sweep (``got``) against its plain version on the same inputs:
    mind within INIT_REL of ||x||^2 + mind, psi within INIT_REL, and draws
    equal except where |u psi_prev - ell mind| is within INIT_REL of ell
    mind.  Returns (ok, draws that differ, max |mind error|)."""
    x2 = torch.sum(x * x, dim=1)
    pm = plain[0]
    err = torch.abs(got[0] - pm)
    fin = torch.isfinite(pm)
    mind_ok = bool((err[fin] <= INIT_REL * (x2[fin] + pm[fin])).all()) and \
        torch.equal(got[0][~fin], pm[~fin])
    psi_rel = abs(float(got[2]) - float(plain[2])) / max(abs(float(plain[2])),
                                                         1e-30)
    diff = got[1] != plain[1]
    margin = torch.abs(u * psi_prev - ell * pm) / (ell * pm)
    n_diff = int(diff.sum())
    n_wide = int((diff & ~(margin <= INIT_REL)).sum())
    worst = float(margin[diff].max()) if n_diff else 0.0
    max_err = float(err[fin].max()) if bool(fin.any()) else 0.0
    ok = mind_ok and psi_rel <= INIT_REL and n_wide == 0
    print(f"[{tag}] against the plain version: mind within {INIT_REL} of "
          f"||x||^2+mind: {mind_ok} (max|err| {max_err:.3g}), psi rel "
          f"{psi_rel:.3g}, draws that differ {n_diff} (all within the margin"
          f": {n_wide == 0}; largest margin {worst:.3g}), {int(got[1].sum())}"
          f" drawn{'' if ok else '  FAIL'}", flush=True)
    return ok, n_diff, max_err


def phase_init(torch, report: dict, main: dict) -> bool:
    """One init sweep at the main input's size (n = 2**23, d = 64) against
    INIT_C = 2048 candidates, with psi_prev from a preceding round-0 sweep,
    against its plain version; round 0 draws nothing, a round with no
    candidate leaves mind as it was, a repeat is bit-identical."""
    from repro_torch.kernels import init, ref
    dev = torch.device("cuda")
    x = main["x"]
    n = x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    ell = 2.0 * K
    w = torch.ones(n, device=dev)
    first = x[torch.randint(0, n, (1,), generator=gen, device=dev)]
    inf = torch.full((n,), torch.inf, device=dev)
    m0, s0, psi0 = init.init_sweep(x, first, inf, torch.rand(
        n, generator=gen, device=dev), 0.0, ell=ell, weights=w)
    cands = x[torch.randperm(n, generator=gen, device=dev)[:INIT_C]]
    u = torch.rand(n, generator=gen, device=dev)
    got = init.init_sweep(x, cands, m0, u, psi0, ell=ell, weights=w)
    plain = ref.init_sweep_ref(x, cands, m0, u, psi0, ell=ell, weights=w)
    again = init.init_sweep(x, cands, m0, u, psi0, ell=ell, weights=w)
    none = init.init_sweep(x, cands[:0], got[0], u, got[2], ell=ell,
                           weights=w)
    torch.cuda.synchronize()
    ok, n_diff, err = sweep_agreement("init", got, plain, x, u, psi0, ell,
                                      torch)
    round0 = not bool(s0.any())
    repeat = identical(got, again)
    unchanged = torch.equal(none[0], got[0]) and bool(none[1].any())
    print(f"[init] round 0 (psi_prev = 0) drew nothing: {round0}; no "
          f"candidate leaves mind unchanged and still draws: {unchanged}; "
          f"repeat bit-identical: {repeat}", flush=True)
    if not (ok and round0 and repeat and unchanged):
        print("[init] FAIL", flush=True)
        return False
    nc = cands.shape[0]
    ms = cuda_time_ms(lambda: init.init_sweep(x, cands, m0, u, psi0, ell=ell,
                                              weights=w), reps=5)
    plain_ms = cuda_time_ms(lambda: ref.init_sweep_ref(
        x, cands, m0, u, psi0, ell=ell, weights=w), reps=2, warmup=1)
    lib_ms = cuda_time_ms(lambda: library_scores(x, cands), reps=2, warmup=1)
    bound, by = bound_ms(2.0 * n * nc * D,
                              4.0 * (n * D + nc * D + 3 * n + n + 1) + n)
    print(f"[init] sweep {n}x{D} against {nc} candidates: kernel {ms:.4f} ms "
          f"({2.0 * n * nc * D / (ms * 1e-3) / 1e12:.2f} TFLOP/s), plain "
          f"version {plain_ms:.4f} ms, library yardstick (scores and row "
          f"min/argmin) {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})",
          flush=True)
    report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=lib_ms, max_abs_err=err)
    return True



def tune_sums_check(tag, torch, x, c, w, step, spec):
    """A fused step's sums, counts and SSE against the plain versions on
    the step's own labels (float32: counts equal, sums within SUM_RTOL of
    their largest magnitude, SSE within SUM_RTOL; bfloat16:
    bf16_sums_check) -> (ok, max |sum error|)."""
    from repro_torch.kernels import centroid_update, ref
    lanes = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    k = c.shape[1]
    ps = centroid_update.centroid_update_plain(x, step.labels, w, k, lanes,
                                               spec)
    wr = ref.round_bf16(w) if spec.bf16 else w
    sse_want = torch.sum(wr * step.mind, dim=1)
    sse_ok = bool(torch.allclose(step.sse, sse_want, rtol=SUM_RTOL, atol=0))
    if spec.bf16:
        ok, err, _ = bf16_sums_check(tag, torch, x, step.labels, w, k,
                                     (step.sums, step.counts), ps, lanes)
        return ok and sse_ok, err
    err = float(torch.max(torch.abs(step.sums - ps[0])))
    tol = SUM_RTOL * float(torch.max(torch.abs(ps[0]))) + 1e-6
    cnt_ok = torch.equal(step.counts, ps[1])
    ok = cnt_ok and err <= tol and sse_ok
    print(f"[{tag}] sums vs plain (same labels): counts equal {cnt_ok}, "
          f"max|err| {err:.3g} (tol {tol:.3g}), sse rtol {SUM_RTOL}: "
          f"{sse_ok}: passes {ok}", flush=True)
    return ok, err


def tune_labels_check(tag, torch, x, c, got, spec, x2_rows=None):
    """Labels and distances (an assign pass, ``got``) against the plain
    score in row chunks (``fused.plain_assign``; ``||x||^2`` of
    ``x2_rows`` where given, as the assign kernel's bf16 mode adds it):
    ``label_agreement`` in float32, ``bf16_assign_check`` in bfloat16 ->
    (ok, max |mind error|)."""
    from repro_torch.kernels import fused, ref

    def block(xs, xn):
        labels, mind, _ = fused.plain_assign(xs, c, spec.bf16, x2_rows=xn)
        return labels, mind

    if x2_rows is None:
        want = ref.by_row_chunks(lambda xs: block(xs, None), x, c.shape[1])
    else:
        rows = max(1, ref.PLAIN_SCORE_ELEMS // (x.shape[0] * c.shape[1]))
        parts = [block(x[:, lo:lo + rows], x2_rows[:, lo:lo + rows])
                 for lo in range(0, x.shape[1], rows)]
        want = tuple(torch.cat(t, dim=-1) for t in zip(*parts))
    if spec.bf16:
        ok, _, _, err = bf16_assign_check(tag, torch, x, c, got, want,
                                          x2_rows=x2_rows)
        return ok, err
    from repro_torch.kernels.fused import AssignOut
    ok, _, err = label_agreement(tag, x, c, AssignOut(*got),
                                 AssignOut(*want), torch)
    return ok, err


def phase_tune(torch, reports: dict, main: dict, big):
    """[tune]: (a) every score tile width of TUNE_WIDTHS in the assign,
    fused (accumulate and assign-only) and init-sweep kernels, float32 and
    bfloat16, bit for bit the default width's launch on the main stack, on
    a ragged lane at each of TUNE_RAGGED_KS centroids and on an init sweep
    of 2**23 rows against INIT_C candidates; the default's outputs against
    the plain versions (so every width's); each width timed beside the
    default in this phase, the default row's bound and library call.
    (b) The whole solve of the main stack at each of TUNE_GROUPS lanes a
    launch, bit for bit one launch, ceil(M / t) launches, each launch's R,
    and times.  (c) The sweep into a fresh tuning cache: ``autotune_step``
    at TUNE_STEP_SIZES, ``autotune_init_sweep`` at TUNE_INIT_N x D x INIT_C,
    ``autotune_batched`` on the main stack's shape (reseed on), then the
    autotune CLI on TUNE_CLI.  (d) With that cache, [main]'s configuration
    on ``batched``: bit for bit [main]'s run in ceil(M / t*) launches, its
    S2 time beside [main]'s.  Returns the width variants' report rows, or
    None when a check failed."""
    import os
    import shutil
    import tempfile
    from repro_torch.kernels import assign, fused, init, specs, tuning
    from repro_torch.kernels import batch_resident as br
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    subsets, w, x = main["subsets"], main["masks"], main["x"]
    cents = main["res_f"].intermediate.contiguous()
    m, s, d = subsets.shape
    n = x.shape[0]
    x1, c1, _, k1 = big
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    ragged = x1[:, :TUNE_RAGGED_ROWS].contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    ell = 2.0 * K
    cands = x[torch.randperm(n, generator=gen, device=dev)[:INIT_C]]
    m0 = init.init_sweep(x, cands[:1], torch.full((n,), torch.inf,
                                                  device=dev),
                         torch.rand(n, generator=gen, device=dev), 0.0,
                         ell=ell)[0]
    psi0 = torch.sum(m0)
    u = torch.rand(n, generator=gen, device=dev)
    inputs = [("main stack", subsets, cents, w)] + [
        (f"ragged lane {TUNE_RAGGED_ROWS} rows, k={k}", ragged,
         c1[:, :k].contiguous(), torch.ones(ragged.shape[:2], device=dev))
        for k in TUNE_RAGGED_KS]

    # (a) every width against the default, bit for bit; the default
    # against the plain versions
    ok = True
    errs, launched = {}, {}
    for acc in ("float32", "bfloat16"):
        base = specs.KernelSpec(acc_dtype=acc)
        tag = "tune" if acc == "float32" else "tune bf16"
        for what, xs, cs, ws in inputs:
            def calls(sp):
                return {"fused_lloyd": (
                            *fused.fused_lloyd(xs, cs, ws, spec=sp,
                                               return_labels=True),
                            *fused.fused_lloyd(xs, cs, spec=sp,
                                               assign_only=True)),
                        "assign": tuple(assign.assign(xs, cs, spec=sp))}
            want = calls(base)
            same = {}
            for bk in TUNE_WIDTHS:
                reset_counts()
                got = calls(base.replace(block_k=bk))
                torch.cuda.synchronize()
                if what == "main stack":
                    counts = read_counts()
                    for name in got:
                        launched[(name, acc, bk)] = counts[name]
                same[bk] = {name: identical(got[name], want[name])
                            for name in got}
            step = fused.StepLabelsOut(*want["fused_lloyd"][:5])
            ok_l, err_l = tune_labels_check(
                f"{tag} {what}", torch, xs, cs,
                want["fused_lloyd"][5:], base)
            ok_a, err_a = tune_labels_check(
                f"{tag} {what} assign", torch, xs, cs, want["assign"],
                base, x2_rows=xs if base.bf16 else None)
            ok_s, err_s = tune_sums_check(f"{tag} {what}", torch, xs, cs,
                                          ws, step, base)
            modes = identical(want["fused_lloyd"][3:5],
                              want["fused_lloyd"][5:])
            print(f"[{tag}] {what}, k={cs.shape[1]}: block_k "
                  f"{TUNE_WIDTHS} bit for bit block_k 128 (fused step, "
                  f"its assign-only mode, assign): {same}; the step's "
                  f"labels are the assign-only mode's: {modes}", flush=True)
            ok = ok and ok_l and ok_a and ok_s and modes and all(
                all(v.values()) for v in same.values())
            if what == "main stack":
                errs[("fused_lloyd", acc)] = err_s
                errs[("assign", acc)] = err_a
        got0 = init.init_sweep(x, cands, m0, u, psi0, ell=ell, spec=base)
        same = {}
        for bk in TUNE_WIDTHS:
            reset_counts()
            got = init.init_sweep(x, cands, m0, u, psi0, ell=ell,
                                  spec=base.replace(block_k=bk))
            torch.cuda.synchronize()
            launched[("init_sweep", acc, bk)] = read_counts()["init_sweep"]
            same[bk] = identical(got, got0)
        if base.bf16:
            plain = init.init_sweep_plain(x, cands, m0, u, psi0, ell=ell,
                                          spec=base)
            ok_i, err_i, _ = bf16_init_check(f"{tag} init", torch, x, cands,
                                             u, psi0, got0, plain)
        else:
            plain = init.init_sweep_plain(x, cands, m0, u, psi0, ell=ell)
            ok_i, _, err_i = sweep_agreement(f"{tag} init", got0, plain, x,
                                             u, psi0, ell, torch)
        errs[("init_sweep", acc)] = err_i
        print(f"[{tag}] init sweep {n}x{D} against {INIT_C} candidates: "
              f"block_k {TUNE_WIDTHS} bit for bit block_k 128: {same}",
              flush=True)
        ok = ok and ok_i and all(same.values())
    if not ok:
        print("[tune] FAIL a tile width against the default or the plain "
              "version", flush=True)
        return None

    # the widths' times, each beside the default's in this phase, the
    # default row's bound and library call
    variants = []
    n1 = x1.shape[1]
    jobs = {
        "fused_lloyd": (lambda sp: fused.fused_lloyd(subsets, cents, w,
                                                     spec=sp),
                        lambda sp: fused.fused_lloyd_plain(subsets, cents, w,
                                                           spec=sp),
                        2.0 * m * s * K * d,
                        4.0 * m * (s * d + K * d + s + K * d + K + 1)),
        "assign": (lambda sp: assign.assign(x1, c1, spec=sp),
                   lambda sp: assign.assign_plain(x1, c1, one, sp),
                   2.0 * n1 * k1 * D, 4.0 * (n1 * D + k1 * D) + 8.0 * n1),
        "init_sweep": (lambda sp: init.init_sweep(x, cands, m0, u, psi0,
                                                  ell=ell, spec=sp),
                       lambda sp: init.init_sweep_plain(x, cands, m0, u,
                                                        psi0, ell=ell,
                                                        spec=sp),
                       2.0 * n * INIT_C * D,
                       4.0 * (n * D + INIT_C * D + 3 * n + n + 1) + n),
    }
    for acc in ("float32", "bfloat16"):
        base = specs.KernelSpec(acc_dtype=acc)
        for name, (run, plain_run, fl, nb) in jobs.items():
            times = {bk: cuda_time_ms(lambda: run(base.replace(block_k=bk)),
                                      reps=3, warmup=1)
                     for bk in (128, *TUNE_WIDTHS)}
            plain_ms = cuda_time_ms(lambda: plain_run(base), reps=1,
                                    warmup=1)
            bound, by = (bf16_bound_ms if base.bf16 else bound_ms)(fl, nb)
            lib = None if base.bf16 else reports[name]["library_ms"]
            print(f"[tune{' bf16' if base.bf16 else ''} {name}] by block_k "
                  f"{ {bk: round(t, 4) for bk, t in times.items()} } ms, "
                  f"plain version {plain_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({by}), library call {lib}", flush=True)
            for bk in TUNE_WIDTHS:
                label = f"bf16,block_k={bk}" if base.bf16 else f"block_k={bk}"
                variants.append({
                    "name": f"{name}[{label}]", "route": "cuda",
                    "source": reports[name]["source"],
                    "replaces": reports[name]["replaces"],
                    "launches": launched[(name, acc, bk)],
                    "max_abs_err": errs[(name, acc)], "ms": times[bk],
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "library_ms": lib, "ms_block_k_128": times[128]})

    # the serving tier's smallest and largest buckets: one assign-only
    # launch of the fused pass against [main]'s batched centroids, its
    # device time (torch.profiler, the norms and the score kernel; at
    # these sizes CUDA events over back-to-back calls time the host)
    served = main["res_b"].centroids.unsqueeze(0).contiguous()
    serve_ms = {}
    for rows in (8, SERVE_MAX_REQUEST):
        q = x[:rows].unsqueeze(0).contiguous()
        outs = {bk: fused.fused_lloyd(q, served, assign_only=True,
                                      spec=specs.KernelSpec(block_k=bk))
                for bk in (128, *TUNE_WIDTHS)}
        same = all(identical(o, outs[128]) for o in outs.values())
        serve_ms[rows] = {bk: round(sum(pass_times(
            torch, lambda: fused.fused_lloyd(
                q, served, assign_only=True,
                spec=specs.KernelSpec(block_k=bk)), reps=20).values()), 4)
            for bk in outs}
        print(f"[tune] serving bucket {rows} rows, k={K}: device time of an "
              f"assign-only launch by block_k {serve_ms[rows]} ms; bit for "
              f"bit block_k 128: {same}", flush=True)
        if not same:
            print("[tune] FAIL a tile width at a serving bucket", flush=True)
            return None
    reports["fused_lloyd"]["serve_ms_by_block_k"] = serve_ms

    # (b) the whole solve at each group size, bit for bit one launch
    init_c = main["init"]
    kw = dict(max_iters=MAX_ITERS, tol=TOL, reseed_empty=True)
    reset_counts()
    whole = solve_batched(subsets, init_c, w, **kw)
    torch.cuda.synchronize()
    ok = read_counts() == counts_of(lloyd_solve_batched=1)
    ms_one = cuda_time_ms(lambda: solve_batched(subsets, init_c, w, **kw),
                          reps=2, warmup=1)
    by_group = {}
    for t in TUNE_GROUPS:
        reset_counts()
        got = solve_batched(subsets, init_c, w, group_t=t, **kw)
        torch.cuda.synchronize()
        n_launch = read_counts()["lloyd_solve_batched"]
        groups = br.lane_groups(m, t)
        rs = [br.cluster_plan(hi - lo, s, K, device=dev).r
              for lo, hi in groups]
        ms_t = cuda_time_ms(lambda: solve_batched(subsets, init_c, w,
                                                  group_t=t, **kw),
                            reps=2, warmup=1)
        same = identical(got, whole)
        by_group[t] = dict(ms=ms_t, launches=n_launch, r=sorted(set(rs)))
        print(f"[tune] whole solve of the main stack at group_t={t}: "
              f"{n_launch} launches (want {-(-m // t)}), R by launch "
              f"{rs if len(rs) <= 8 else f'{rs[:4]} ... {rs[-2:]}'}, "
              f"{ms_t:.4f} ms (one launch {ms_one:.4f} ms); bit for bit one"
              f" launch: {same}", flush=True)
        ok = ok and same and n_launch == -(-m // t)
    if not ok:
        print("[tune] FAIL the whole solve at a group size", flush=True)
        return None

    # (c) the sweep into a fresh cache
    tmp = Path(tempfile.mkdtemp(prefix="tune-"))
    cache = tuning.TuningCache.load(tmp / "kernel_specs.json")
    t0 = time.perf_counter()
    for ns, ds, ks in TUNE_STEP_SIZES:
        best, rows = tuning.autotune_step(ns, ds, ks, cache=cache, device=dev)
        print(f"[tune] autotune_step {ns}x{ds}x{ks}: "
              + ", ".join(f"block_k={r['spec'].block_k} "
                          f"{r['time_us']:.1f} us" for r in rows)
              + f" -> block_k={best.block_k}", flush=True)
    best_i, rows = tuning.autotune_init_sweep(TUNE_INIT_N, D, INIT_C,
                                              cache=cache, device=dev)
    print(f"[tune] autotune_init_sweep {TUNE_INIT_N}x{D}x{INIT_C}: "
          + ", ".join(f"block_k={r['spec'].block_k} {r['time_us']:.1f} us"
                      for r in rows) + f" -> block_k={best_i.block_k}",
          flush=True)
    best_b, rows = tuning.autotune_batched(
        m, s, d, K, cache=cache, device=dev, reseed_empty=True,
        solve_iters=TUNE_SOLVE_ITERS, repeats=1)
    curve = {r["group_t"]: r["time_us"] for r in rows}
    print(f"[tune] autotune_batched {m}x{s}x{d}, k={K}, reseed on, "
          f"{TUNE_SOLVE_ITERS} trips, the default group sizes "
          f"{tuning.GROUP_TS} and the cap (one run a size after a warm-up):"
          f" " + ", ".join(f"t={t} {curve[t] / 1e3:.2f} ms"
                           for t in sorted(curve))
          + f" -> group_t={best_b.group_t}", flush=True)
    path = cache.save()
    sweep_s = time.perf_counter() - t0
    cli_cache = tmp / "cli.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.autotune",
                           *TUNE_CLI, "--cache", str(cli_cache)],
                          capture_output=True, text=True, env=env, cwd=ROOT)
    cli_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"[tune] autotune CLI: {line}", flush=True)
    cli_ok = proc.returncode == 0 and "cache round-trip OK" in proc.stdout
    print(f"[tune] the sweep {sweep_s:.1f} s, the CLI {cli_s:.1f} s (exit "
          f"{proc.returncode}){'' if cli_ok else ': ' + proc.stderr[-2000:]}",
          flush=True)
    if not cli_ok:
        print("[tune] FAIL the autotune CLI", flush=True)
        return None

    # (d) [main]'s configuration on batched with the swept cache
    patch = use_cache(str(path))
    try:
        t_star = tuning.lookup_group_t(s, d, K, m, device=dev)
        cfg_b = main["config"]("batched")
        res, secs, counts = run_path(torch, x, init_c, cfg_b, dev)
        s2 = stage_times(torch, x, init_c, cfg_b, dev)[1]
    finally:
        patch.stop()
        tuning.reload_cache()
    ref_b = main["res_b"]
    same = (torch.equal(res.centroids, ref_b.centroids)
            and torch.equal(res.intermediate, ref_b.intermediate)
            and torch.equal(res.subset_iters, ref_b.subset_iters)
            and torch.equal(res.sse, ref_b.sse))
    want_launch = -(-m // t_star) if t_star else 0
    print(f"[tune] [main] on batched with the swept cache (group_t={t_star}):"
          f" {secs:.3f} s, launches {counts}, want {want_launch} whole-solve "
          f"launches; S2 {s2:.3f} s against [main]'s {main['stages_b'][1]:.3f}"
          f" s; centroids, intermediate centroids, iterations and SSE bit for"
          f" bit [main]'s: {same}", flush=True)
    ok = (same and t_star is not None
          and counts == counts_of(lloyd_solve_batched=want_launch))
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[tune] the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not ok:
        print("[tune] FAIL [main] with the swept cache", flush=True)
        return None
    reports["lloyd_solve_batched"]["by_group_t"] = by_group
    reports["lloyd_solve_batched"]["tuned_group_t"] = t_star
    return variants

def phase_seed(torch, init_rep: dict, assign_rep: dict, main: dict) -> bool:
    """k-means|| seeding on the main input: through ``resolve_init`` on the
    kernels (launch counts), stage by stage (times), each kernel stage
    against its plain version on the same inputs, the kernel seeding
    against the plain oracles' with the same draws, then the whole job
    ``ipkmeans(cfg.with_init("kmeans||"))`` on ``backend="batched"``."""
    from repro_torch.core import init as seeding
    from repro_torch.core.ipkmeans import _resolve_init_stage, ipkmeans
    from repro_torch.kernels import assign, ref
    from repro_torch.kernels.fused import AssignOut
    dev = torch.device("cuda")
    x = main["x"]
    n = x.shape[0]
    rounds = seeding.default_rounds(n, K)
    ell = 2.0 * K
    w = torch.ones(n, device=dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    seeds = seeding.resolve_init(x, K, "kmeans||", backend="kernel",
                                 generator=gen())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()

    draws = seeding.parallel_draws(n, K, rounds, gen(), dev)
    stages = {}

    def staged(backend):
        """One seeding, timed stage by stage; each sweep's inputs and
        outputs are kept."""
        sweeps = []
        inner = seeding._sweep(backend)

        def sweep(*args, **kw):
            out = inner(*args, **kw)
            sweeps.append((args, kw, out))
            return out

        t = time.perf_counter()
        with mock.patch.object(seeding, "_sweep", lambda *_: sweep):
            out = seeding.oversample(x, draws, ell=ell, weights=w,
                                     backend=backend)
        torch.cuda.synchronize()
        stages[backend] = [time.perf_counter() - t]
        t = time.perf_counter()
        cands = x[out[0]]
        cw = seeding.candidate_weights(x, cands, w, backend)
        torch.cuda.synchronize()
        stages[backend].append(time.perf_counter() - t)
        t = time.perf_counter()
        chosen = seeding.kmeans_plus_plus(cands, K, weights=cw,
                                          uniforms=draws.recluster)
        torch.cuda.synchronize()
        stages[backend].append(time.perf_counter() - t)
        return out, cands, chosen, sweeps

    kern, k_cands, k_seeds, k_sweeps = staged("kernel")
    plain, _, p_seeds, p_sweeps = staged("plain")
    same_draws = torch.equal(k_seeds, seeds)
    kt, pt = stages["kernel"], stages["plain"]
    print(f"[seed] resolve_init(kmeans||) on the kernels: {secs:.3f} s, "
          f"launches {counts}; stage by stage: sweeps {kt[0]:.3f} s, "
          f"weighting assign {kt[1]:.3f} s, recluster {kt[2]:.3f} s (plain "
          f"oracles: {pt[0]:.3f} / {pt[1]:.3f} / {pt[2]:.3f} s); staged seeds"
          f" bit-identical to resolve_init's: {same_draws}", flush=True)
    print(f"[seed] rounds {rounds}, ell {ell:.0f}, candidates "
          f"{kern[0].numel()} (plain {plain[0].numel()}), psi "
          f"{[f'{v:.6e}' for v in kern[2]]}", flush=True)
    # the candidates each sweep scored; the weighting assign scores the pool
    scored = sum(int(args[1].shape[0]) for args, _, _ in k_sweeps)
    sweep_bound, sweep_by = bound_ms(2.0 * n * D * scored,
                                     4.0 * (rounds + 1) * n * (D + 3))
    assign_bound, assign_by = bound_ms(2.0 * n * D * kern[0].numel(),
                                       4.0 * n * (D + 2))
    print(f"[seed] score work: the sweeps {2.0 * n * D * scored / 1e12:.3f} "
          f"TFLOP against {scored} candidates in all, bound "
          f"{sweep_bound:.4f} ms ({sweep_by}); the weighting assign "
          f"{2.0 * n * D * kern[0].numel() / 1e12:.3f} TFLOP, bound "
          f"{assign_bound:.4f} ms ({assign_by})", flush=True)
    # each stage of the kernel run against its plain version on the same
    # inputs: every sweep, then the weighting assign over the pool
    stages_ok = True
    for r, (args, kw, got) in enumerate(k_sweeps):
        want = ref.init_sweep_ref(*args, **kw)
        stages_ok &= sweep_agreement(f"seed sweep {r}", got, want, x,
                                     args[3], args[4], ell, torch)[0]
    ka = assign.assign(x, k_cands)
    pa = ref.assign_ref(x, k_cands)
    torch.cuda.synchronize()
    lab_ok, n_ties, _ = label_agreement(
        "seed", x[None], k_cands[None], AssignOut(*(t[None] for t in ka)),
        AssignOut(*(t[None] for t in pa)), torch)
    del ka, pa
    agree = kern[0].numel() == plain[0].numel() and torch.equal(k_seeds,
                                                                p_seeds)
    if agree:
        print(f"[seed] kernel and plain seedings: the same "
              f"{kern[0].numel()} candidates and the same {K} chosen rows",
              flush=True)
    else:
        # where the two runs part: the first sweep whose draws differ (its
        # candidates are the same in both runs), else the weighting labels
        n_rows = int((~torch.all(k_seeds == p_seeds, dim=1)).sum())
        r = next((r for r, (kr, pr) in enumerate(zip(k_sweeps, p_sweeps))
                  if not torch.equal(kr[2][1], pr[2][1])), None)
        if r is None:
            agree = n_ties > 0
            where = (f"the weighting assign: every sweep drew the same "
                     f"rows, and the {n_ties} near-tie weighting labels "
                     f"above move mass between candidates, which the "
                     f"recluster's draws then follow")
        else:
            args, _, want = p_sweeps[r]
            diff = k_sweeps[r][2][1] != want[1]
            margin = (torch.abs(args[3] * args[4] - ell * want[0])
                      / (ell * want[0]))[diff]
            agree = bool((margin <= INIT_REL).all())
            where = (f"sweep {r}, whose draws differ at "
                     f"{int(diff.sum())} rows, margins "
                     f"{[f'{v:.3g}' for v in margin.tolist()[:8]]} (bound "
                     f"{INIT_REL})")
        print(f"[seed] kernel and plain seedings differ at {n_rows} of {K} "
              f"chosen rows; they part at {where}: "
              f"{'boundary effects' if agree else 'FAIL'}", flush=True)
    ok = (same_draws and stages_ok and lab_ok and agree
          and counts == counts_of(init_sweep=rounds + 1, assign=1)
          and tuple(seeds.shape) == (K, D)
          and bool(torch.isfinite(seeds).all()))
    if not ok:
        print("[seed] FAIL", flush=True)
        return False

    # the whole job: seeds drawn inside ipkmeans, then S1-S3
    cfg = main["config"]("batched").with_init("kmeans||")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = ipkmeans(x, None, cfg, generator=gen(), device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    job_seeds, cfg_given = _resolve_init_stage(x, None, cfg, generator=gen())
    torch.cuda.synchronize()
    t_seed = time.perf_counter() - t0
    st = stage_times(torch, x, job_seeds, cfg_given, dev)
    main["describe"]("batched kmeans||", res, secs, counts, st)
    res_b = main["res_b"]
    print(f"[seed] whole job: seeding {t_seed:.3f} s, S1 {st[0]:.3f} s, S2 "
          f"{st[1]:.3f} s, S3 {st[2]:.3f} s; SSE {float(res.sse):.6e} "
          f"against {float(res_b.sse):.6e} from the given seeds (ratio "
          f"{float(res.sse) / float(res_b.sse):.4f})", flush=True)
    init_rep["launches"] = counts["init_sweep"]
    # the seeding path's count; the twopass path's stands beside it
    assign_rep["launches"] = counts["assign"]
    assign_rep["launches_by_path"] = {"kmeans|| seeding": counts["assign"]}
    main["kpar_seeds"] = seeds
    ok = (main["sane"](res) and torch.equal(job_seeds, seeds)
          and torch.equal(st[5].iters, res.subset_iters)
          and counts == counts_of(init_sweep=rounds + 1, assign=1,
                                  lloyd_solve_batched=1))
    if not ok:
        print("[seed] FAIL whole job", flush=True)
    return ok


def phase_twopass(torch, update_rep: dict, assign_rep: dict,
                  main: dict) -> bool:
    """The main path on ``backend="twopass"``: its lanes and SSE against the
    fused engine's run of the same input and seeds."""
    x, init = main["x"], main["init"]
    dev = torch.device("cuda")
    cfg = main["config"]("twopass")
    res, secs, counts = run_path(torch, x, init, cfg, dev)
    st = stage_times(torch, x, init, cfg, dev)
    main["describe"]("twopass", res, secs, counts, st)
    res_f, counts_f = main["res_f"], main["counts_f"]
    n_diff = int((res.subset_iters != res_f.subset_iters).sum())
    sse_rel = abs(float(res.sse) - float(res_f.sse)) / float(res_f.sse)
    print(f"[twopass] S2 {st[1]:.3f} s (fused engine {main['s2_fused']:.3f} "
          f"s); launches: assign {counts['assign']} (the fused engine's "
          f"{counts_f['fused_lloyd']}: one a trip, one a reseed pass, one "
          f"final scoring pass), centroid update {counts['centroid_update']} "
          f"(one a trip); lanes whose iterations differ from fused's "
          f"{n_diff}; SSE rel {sse_rel:.3g} (rtol {MAIN_SSE_RTOL})",
          flush=True)
    update_rep["launches"] = counts["centroid_update"]
    assign_rep["launches_by_path"]["twopass"] = counts["assign"]
    ok = (main["sane"](res) and n_diff == 0 and sse_rel <= MAIN_SSE_RTOL
          and counts == counts_of(assign=counts_f["fused_lloyd"],
                                  centroid_update=counts["centroid_update"])
          and 0 < counts["centroid_update"] < counts["assign"])
    if not ok:
        print("[twopass] FAIL", flush=True)
    return ok



def pkmeans_job(torch, x, init, params, dev, mask=None):
    """One pkmeans call through the entry point, the counts set to 0 just
    before and read just after: (result, seconds, counts)."""
    from repro_torch.core import pkmeans
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = pkmeans(x, init, mask, params, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return res, secs, read_counts()


def phase_pkmeans(torch, report: dict, assign_rep: dict, update_rep: dict,
                  main: dict) -> bool:
    """The PKMeans baseline on [main]'s input and seeds: the full job on
    ``twopass`` (assign kernel, then centroid-update kernel, every trip),
    the paper's IPKMeans/PKMeans ratios against [main]'s ``batched`` job,
    one trip's time beside its bound, one fused one-lane step's time
    beside its bound and the library yardstick (and its passes' device
    times), ``twopass`` against ``fused`` for PK_CHECK_ITERS iterations bit
    for bit, ``twopass`` against the plain ``eager`` engine on the first
    PK_SMALL_N points (whole runs and trip by trip), trip by trip on the
    whole lane for PK_FULL_TRIPS trips, with one fused step, and whole
    jobs on ``fused`` and ``batched`` bit for bit the ``twopass`` job."""
    from repro_torch.core import KMeansParams
    from repro_torch.kernels import engine as engines
    dev = torch.device("cuda")
    x, init = main["x"], main["init"]
    params = KMeansParams(max_iters=MAX_ITERS, tol=TOL, backend="twopass",
                          reseed_empty=True)
    res, secs, counts = pkmeans_job(torch, x, init, params, dev)
    iters = int(res.iters)
    res_b = main["res_b"]
    sse_ratio = float(res_b.sse) / float(res.sse)
    time_ratio = main["secs_b"] / secs
    print(f"[pkmeans] twopass: n={N} d={D} K={K} max_iters={MAX_ITERS} "
          f"tol={TOL} reseed_empty=True: {secs:.3f} s, iterations {iters} "
          f"(converged {bool(res.converged)}), launches {counts}; SSE "
          f"{float(res.sse):.6e} (one-centroid SSE {main['one']:.6e})",
          flush=True)
    print(f"[pkmeans] IPKMeans (batched, {main['secs_b']:.3f} s, SSE "
          f"{float(res_b.sse):.6e}) against PKMeans (twopass, {secs:.3f} s, "
          f"SSE {float(res.sse):.6e}): SSE ratio {sse_ratio:.4f}, time "
          f"ratio {time_ratio:.4f}", flush=True)

    # one trip at the converged centroids, and its bound: the assign
    # kernel's score product and the update's bytes
    x1, c1 = x.unsqueeze(0), res.centroids.unsqueeze(0).contiguous()
    twopass, fused_engine = (engines.get_engine(b) for b in
                             ("twopass", "fused"))
    trip_ms = cuda_time_ms(lambda: twopass.step(x1, c1), reps=3, warmup=1)
    a_bound, a_by = bound_ms(2.0 * N * K * D, 4.0 * (N * D + K * D + 2 * N))
    u_bound, u_by = bound_ms(0.0, 4.0 * (N * D + 2 * N + K * D + K))
    print(f"[pkmeans] one twopass trip {N}x{D}, k={K}: {trip_ms:.4f} ms "
          f"against a bound of {a_bound:.4f} ms ({a_by}) + {u_bound:.4f} ms "
          f"({u_by}); the job's {secs * 1e3 / max(iters, 1):.4f} ms a trip "
          f"on the host clock (reseed passes and the final SSE included)",
          flush=True)

    # one fused step on the one lane: its time beside its bound and the
    # library yardstick, and each pass's device time
    w1 = torch.ones((1, N), device=dev)
    fused_ms = cuda_time_ms(lambda: fused_engine.step(x1, c1), reps=5,
                            warmup=1)
    lane_lib_ms = cuda_time_ms(lambda: library_step(x1, c1, w1), reps=2,
                               warmup=1)
    lane_bound, lane_by = step_bound_ms(1, N, D, K)
    lane_passes = pass_times(torch, lambda: fused_engine.step(x1, c1))
    print(f"[pkmeans] one fused one-lane step {N}x{D}, k={K}: "
          f"{fused_ms:.4f} ms, library yardstick {lane_lib_ms:.4f} ms, bound "
          f"{lane_bound:.4f} ms ({lane_by}); device ms a call by kernel "
          f"(torch.profiler): {json.dumps(lane_passes)}", flush=True)
    del w1

    # twopass against fused: the same labels and sums, the same bits
    short = params._replace(max_iters=PK_CHECK_ITERS)
    res_t, _, counts_t = pkmeans_job(torch, x, init, short, dev)
    res_f, secs_f, counts_f = pkmeans_job(
        torch, x, init, short._replace(backend="fused"), dev)
    same = (torch.equal(res_t.centroids, res_f.centroids)
            and int(res_t.iters) == int(res_f.iters) == PK_CHECK_ITERS)
    print(f"[pkmeans] {PK_CHECK_ITERS} iterations, twopass against fused "
          f"({secs_f:.3f} s, launches {counts_f}): centroids bit-identical "
          f"{same}", flush=True)

    # twopass against the plain eager engine on a cut of the input: the
    # whole runs, then trip by trip from the eager run's centroids
    xs = x[:PK_SMALL_N].contiguous()
    got, _, _ = pkmeans_job(torch, xs, init, params, dev)
    want, _, _ = pkmeans_job(torch, xs, init,
                             params._replace(backend="eager"), dev)
    c_rel = float(torch.max(torch.abs(got.centroids - want.centroids)
                            / torch.clamp(torch.abs(want.centroids),
                                          min=1.0)))
    s_rel = abs(float(got.sse) - float(want.sse)) / float(want.sse)
    step_ok, parted = pkmeans_lockstep(torch, xs, init, int(want.iters))
    small_ok = (int(got.iters) == int(want.iters) and s_rel <= PK_RTOL
                and step_ok)
    print(f"[pkmeans] n={PK_SMALL_N}: twopass against eager: iterations "
          f"{int(got.iters)} and {int(want.iters)}, SSE rel {s_rel:.3g} "
          f"(rtol {PK_RTOL}), centroids max rel {c_rel:.3g} after the "
          f"runs part; trip by trip from the same centroids: {parted}",
          flush=True)
    # the kernels at the shape the path gives them: the whole lane, from
    # the job's seeds, against the plain engine
    del xs
    full_ok, full = pkmeans_lockstep(torch, x, init, PK_FULL_TRIPS,
                                     fused=True)
    print(f"[pkmeans] n={N}: twopass against eager, trip by trip from the "
          f"seeds: {full}", flush=True)

    # whole jobs on the fused kernel, with the twopass job's settings: the
    # same labels and sums every trip, so the same centroids, iterations
    # and SSE bit for bit
    jobs_ok = True
    paths = report.setdefault("launches_by_path", {})
    for backend in ("fused", "batched"):
        res_j, secs_j, counts_j = pkmeans_job(
            torch, x, init, params._replace(backend=backend), dev)
        same_j = (torch.equal(res_j.centroids, res.centroids)
                  and int(res_j.iters) == iters
                  and torch.equal(res_j.sse, res.sse))
        print(f"[pkmeans] whole job on {backend}: {secs_j:.3f} s (twopass "
              f"{secs:.3f} s), iterations {int(res_j.iters)}, launches "
              f"{counts_j}; centroids, iterations and SSE bit-identical to "
              f"the twopass job's: {same_j}", flush=True)
        jobs_ok = (jobs_ok and same_j
                   and counts_j == counts_of(fused_lloyd=counts["assign"]))
        paths[f"pkmeans {backend}"] = counts_j["fused_lloyd"]
        report[f"pkmeans_{backend}_job_s"] = secs_j

    paths[f"pkmeans fused, {PK_CHECK_ITERS} iterations"] = \
        counts_f["fused_lloyd"]
    assign_rep["launches_by_path"]["pkmeans twopass"] = counts["assign"]
    update_rep["launches_by_path"] = {
        "ipkmeans twopass": update_rep["launches"],
        "pkmeans twopass": counts["centroid_update"]}
    report.update(pkmeans_fused_step_ms=fused_ms,
                  one_lane_library_ms=lane_lib_ms,
                  one_lane_bound_ms=lane_bound, one_lane_passes=lane_passes)
    ok = (main["sane"](res) and same and small_ok and full_ok and jobs_ok
          and counts == counts_of(assign=counts["assign"],
                                  centroid_update=iters)
          and counts["assign"] >= iters > 0
          and counts_t == counts_of(assign=counts_t["assign"],
                                    centroid_update=PK_CHECK_ITERS)
          and counts_f == counts_of(fused_lloyd=counts_t["assign"]))
    if not ok:
        print("[pkmeans] FAIL", flush=True)
    return ok


def near_ties(torch, x64, c, got, want, moved):
    """Where two label vectors from the same centroids ``c`` differ, each
    point must be a near-tie: its two distances (exact, in f64) within
    TIE_REL of ||x||^2 + ||c||^2.  Marks the clusters such a label left or
    joined in ``moved``; returns (ok, labels that differ, largest gap)."""
    diff = got != want
    if not bool(diff.any()):
        return True, 0, 0.0
    c64 = c.double()
    xd, lg, lw = x64[diff], got[diff].long(), want[diff].long()
    dg = torch.sum((xd - c64[lg]) ** 2, dim=-1)
    dw = torch.sum((xd - c64[lw]) ** 2, dim=-1)
    gap = torch.abs(dg - dw) / (torch.sum(xd * xd, dim=-1)
                                + torch.sum(c64[lg] ** 2, dim=-1))
    moved[lg] = True
    moved[lw] = True
    return bool((gap <= TIE_REL).all()), int(diff.sum()), float(gap.max())


def rows_beyond(torch, got, want, moved):
    """Centroid rows of ``got`` beyond PK_RTOL of ``want`` (relative to
    max(|c|, 1)): (ok, their number); ok when each lies in a cluster that
    ``moved`` marks."""
    beyond = torch.any(torch.abs(got - want) > PK_RTOL * torch.clamp(
        torch.abs(want), min=1.0), dim=-1)
    return not bool((beyond & ~moved).any()), int(beyond.sum())


def pkmeans_lockstep(torch, x, c, trips: int, fused: bool = False):
    """``twopass`` against ``eager`` trip by trip on one lane, each trip
    from the eager run's centroids (with its reseed): labels may differ
    only at near-ties (``near_ties``), and the new centroids agree within
    PK_RTOL except in the clusters such a label left or joined.  With
    ``fused``, the first trip also holds one fused step (its labels, its
    centroids after ``divide_or_keep``, its SSE within PK_RTOL) against
    the eager step by the same rules.  Returns (ok, a summary)."""
    from repro_torch.kernels import engine as engines
    from repro_torch.kernels import ref
    twopass, eager, fused_engine = (engines.get_engine(b) for b in
                                    ("twopass", "eager", "fused"))
    x1 = x.unsqueeze(0)
    x64 = x.double()
    kw = dict(max_iters=1, tol=TOL, reseed_empty=True)
    ok, n_lab, n_trips, n_rows, worst = True, 0, 0, 0, 0.0
    fused_note = ""
    for trip in range(trips):
        c1 = c.unsqueeze(0).contiguous()
        lab_e = eager.assign(x1, c1)[0][0]
        new_e = eager.lloyd_loop(x1, c, **kw)[0][0]
        moved = torch.zeros(c.shape[0], dtype=torch.bool, device=c.device)
        lab_ok, n, gap = near_ties(torch, x64, c,
                                   twopass.assign(x1, c1)[0][0], lab_e,
                                   moved)
        rows_ok, beyond = rows_beyond(
            torch, twopass.lloyd_loop(x1, c, **kw)[0][0], new_e, moved)
        ok = ok and lab_ok and rows_ok
        n_trips += n > 0
        n_lab += n
        n_rows += beyond
        worst = max(worst, gap)
        if fused and trip == 0:
            sums_f, counts_f, sse_f = fused_engine.step(x1, c1)
            sums_e, counts_e, sse_e = eager.step(x1, c1)
            moved_f = torch.zeros_like(moved)
            lab_ok, n_f, gap_f = near_ties(
                torch, x64, c, fused_engine.assign(x1, c1)[0][0], lab_e,
                moved_f)
            rows_ok, beyond_f = rows_beyond(
                torch, ref.divide_or_keep(sums_f, counts_f, c1)[0],
                ref.divide_or_keep(sums_e, counts_e, c1)[0], moved_f)
            sse_rel = abs(float(sse_f[0]) - float(sse_e[0])) / float(
                sse_e[0])
            f_ok = lab_ok and rows_ok and sse_rel <= PK_RTOL
            ok = ok and f_ok
            fused_note = (f"; one fused step against the eager step: "
                          f"{n_f} labels differ (largest gap {gap_f:.3g}), "
                          f"{beyond_f} centroid rows beyond rtol {PK_RTOL},"
                          f" SSE rel {sse_rel:.3g}: {f_ok}")
        c = new_e
    return ok, (f"{n_trips} of {trips} trips see labels differ, {n_lab} "
                f"labels in all, each a near-tie (largest gap {worst:.3g}, "
                f"margin {TIE_REL}): {ok}; {n_rows} centroid rows beyond "
                f"rtol {PK_RTOL}, all in clusters those labels moved"
                f"{fused_note}")


def timed(torch, fn):
    """(result, seconds) of one synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_s1(torch, main: dict) -> bool:
    """The S1 variants at the main input: the histogram builder against the
    sort builder (the same region ids), the bucketed labeler, the sorted
    pack against the scatter pack (bit for bit; n = M * capacity here), the
    times of each, then ``ipkmeans`` on ``batched`` end to end with
    ``s1="histogram", pack="sorted"``, ``partition="kd_random"`` and
    ``partition="random"`` (draws from a seeded torch.Generator)."""
    import dataclasses
    from repro_torch.core import kdtree
    dev = torch.device("cuda")
    x, init = main["x"], main["init"]
    cfg = main["config"]("batched")
    depth = kdtree.required_depth(N, M)
    cap = cfg.subset_capacity(N)
    reg_s, t_sort = timed(torch, lambda: kdtree.build_kdtree(x, depth))
    reg_h, t_hist = timed(torch,
                          lambda: kdtree.build_kdtree_histogram(x, depth))
    same_regions = torch.equal(reg_s, reg_h)
    ids, t_lab = timed(torch, lambda: kdtree.label_regions(
        x, reg_s, 2 ** depth, M))
    ids_h, t_lab_h = timed(torch, lambda: kdtree.label_regions_histogram(
        x, reg_s, 2 ** depth, M))
    (sub_s, msk_s), t_scatter = timed(torch, lambda: kdtree.pack_subsets(
        x, ids, M, cap))
    (sub_o, msk_o), t_sorted = timed(
        torch, lambda: kdtree.pack_subsets_sorted(x, ids, M, cap))
    same_pack = torch.equal(sub_s, sub_o) and torch.equal(msk_s, msk_o)
    balanced = torch.equal(torch.bincount(ids_h.long(), minlength=M),
                           torch.full((M,), cap, device=dev))
    del sub_s, msk_s, sub_o, msk_o
    print(f"[s1] n={N} = M x capacity = {M} x {cap}, depth {depth}: sort "
          f"builder {t_sort:.4f} s, histogram builder {t_hist:.4f} s, region"
          f" ids equal {same_regions}; sort labeler {t_lab:.4f} s, bucketed "
          f"labeler {t_lab_h:.4f} s (subsets of {cap} each: {balanced}); "
          f"scatter pack {t_scatter:.4f} s, sorted pack {t_sorted:.4f} s, "
          f"bit-identical {same_pack}", flush=True)
    ok = same_regions and same_pack and balanced
    for tag, change in (("histogram+sorted", dict(s1="histogram",
                                                  pack="sorted")),
                        ("kd_random", dict(partition="kd_random")),
                        ("random", dict(partition="random"))):
        cfg_v = dataclasses.replace(cfg, **change)

        def gen():
            return torch.Generator(device=dev).manual_seed(SEED)

        res, secs, counts = run_path(torch, x, init, cfg_v, dev, gen())
        st = stage_times(torch, x, init, cfg_v, dev, gen())
        main["describe"](f"batched {tag}", res, secs, counts, st)
        print(f"[s1] {tag}: SSE {float(res.sse):.6e}, "
              f"{float(res.sse) / float(main['res_b'].sse):.4f} x the "
              f"kd_axis/sort/scatter job's; S1 {st[0]:.4f} s against its "
              f"{main['stages_b'][0]:.4f} s", flush=True)
        ok = (ok and main["sane"](res)
              and counts == counts_of(lloyd_solve_batched=1)
              and torch.equal(st[5].iters, res.subset_iters))
    if not ok:
        print("[s1] FAIL", flush=True)
    return ok


def merge_sse_ratio(torch, x, final, best):
    from repro_torch.core import metrics
    return float(metrics.sse(x, final)) / float(metrics.sse(x, best))


def phase_merge(torch, main: dict) -> bool:
    """``hierarchical_merge`` of the first MERGE_LANES lanes' intermediate
    centroids from [main]'s batched run, on the card (timed) and on the
    CPU: the survivors bit for bit (the distances are summed in one fixed
    order on every device), then the merged centroids' SSE on the main
    input against min-ASSE's pick.  The port searches for the closest pair
    by row minima; the reference's flat argmin is timed beside it on the
    card, the two alternating, and must give the same bits."""
    from repro_torch.core import merge
    x, res_b = main["x"], main["res_b"]
    inter = res_b.intermediate[:MERGE_LANES].reshape(-1, D).contiguous()
    n = inter.shape[0]
    got, t_card = timed(torch, lambda: merge.hierarchical_merge(inter, K))
    t_rows, t_flat, same = [t_card], [], True
    for _ in range(2):
        flat, t = timed(torch, lambda: merge._merge(inter, K,
                                                    merge._closest_flat))
        t_flat.append(t)
        same = same and torch.equal(got, flat)
        if len(t_rows) < 2:
            t_rows.append(timed(torch, lambda: merge.hierarchical_merge(
                inter, K))[1])
    t0 = time.perf_counter()
    want = merge.hierarchical_merge(inter.cpu(), K)
    t_cpu = time.perf_counter() - t0
    same = same and torch.equal(got.cpu(), want)
    best = merge.min_asse_merge(res_b.intermediate[:MERGE_LANES],
                                res_b.asses[:MERGE_LANES])
    ratio = merge_sse_ratio(torch, x, got, best)
    ratio_all = merge_sse_ratio(torch, x, got, res_b.centroids)
    print(f"[merge] hierarchical_merge of {MERGE_LANES} lanes' centroids, "
          f"N={n} d={D} -> K={K} ({n - K} steps, a {n * n * 4 / 1e6:.0f} MB "
          f"matrix): card {t_card:.4f} s by row minima; alternating, "
          f"row minima {', '.join(f'{t:.4f}' for t in t_rows)} s, flat "
          f"argmin {', '.join(f'{t:.4f}' for t in t_flat)} s; CPU "
          f"{t_cpu:.3f} s (the check's own cost); survivors bit-identical "
          f"{same}; SSE on the main input {ratio:.4f} x "
          f"min-ASSE's pick among the same lanes, {ratio_all:.4f} x the "
          f"main job's", flush=True)
    ok = same and bool(torch.isfinite(got).all()) and tuple(got.shape) == (
        K, D)
    if not ok:
        print("[merge] FAIL", flush=True)
    return ok


def bf16_score(torch, xr, cc):
    """The plain bf16 score of rows ``xr (R,d)`` against ``cc (R,d)``, and
    one bf16 ulp of its largest term max(|cn|, |2 x.c|), the most one
    rounding of x.c can move it -> two (R,) tensors."""
    from repro_torch.kernels import ref
    cn = ref.round_bf16(torch.sum(cc.float() * cc.float(), dim=-1))
    dot = ref.round_bf16(torch.sum(ref.round_bf16(xr) * ref.round_bf16(cc),
                                   dim=-1))
    term = torch.clamp(torch.maximum(cn.abs(), 2.0 * dot.abs()),
                       min=torch.finfo(torch.float32).tiny)
    return (ref.round_bf16(cn - 2.0 * dot),
            torch.exp2(torch.floor(torch.log2(term)) - 7))


def bf16_departures_ok(n_dep: int, n: int) -> bool:
    """At most BF16_DEPART_SHARE of ``n`` rows or entries, plus
    BF16_DEPART_FLOOR, depart from the plain version."""
    return n_dep <= BF16_DEPART_SHARE * n + BF16_DEPART_FLOOR


def bf16_assign_check(tag, torch, x, c, got, want, x2_rows=None):
    """A bf16 kernel's labels and distances (L,S) against its plain
    version's: a label may differ only where the plain version's two bf16
    scores lie within BF16_TIE_ULPS ulps of the score's largest term; a
    distance within BF16_MIND_ULPS such ulps plus MIND_REL of ||x||^2; rows
    that depart (a label, or a distance beyond MIND_REL of ||x||^2) within
    bf16_departures_ok.  Prints one line and returns (ok, differing labels,
    departing rows, max |mind error|)."""
    from repro_torch.kernels import ref
    diff = got[0] != want[0]
    lane, row = torch.nonzero(diff, as_tuple=True)
    ties_ok = True
    if row.numel():
        xr = x[lane, row]
        sk, uk = bf16_score(torch, xr, c[lane, got[0][lane, row].long()])
        sp, up = bf16_score(torch, xr, c[lane, want[0][lane, row].long()])
        ties_ok = bool(torch.all((sk - sp).abs()
                                 <= BF16_TIE_ULPS * torch.maximum(uk, up)))
    worst, err, n_dep = 0.0, 0.0, int(diff.sum())
    for g in range(x.shape[0]):
        xn = (ref.round_bf16(x[g]) if x2_rows is None
              else x2_rows[g].float())
        _, ulp = bf16_score(torch, x[g], c[g][want[0][g].long()])
        noise = MIND_REL * torch.sum(xn * xn, dim=-1) + 1e-6
        e = (got[1][g] - want[1][g]).abs()
        worst = max(worst, float(torch.max(e / (BF16_MIND_ULPS * ulp
                                                 + noise))))
        n_dep += int(((e > noise) & ~diff[g]).sum())
        err = max(err, float(torch.max(e)))
    dep_ok = bf16_departures_ok(n_dep, diff.numel())
    ok = ties_ok and worst <= 1.0 and dep_ok
    print(f"[{tag}] kernel vs plain (bf16): {int(diff.sum())} of "
          f"{diff.numel()} labels differ, all at bf16 near-ties "
          f"(within {BF16_TIE_ULPS} ulp of the score's largest term): "
          f"{ties_ok}; mind max|err| {err:.4g}, worst / tolerance "
          f"{worst:.3g}; rows departing {n_dep} (allowed "
          f"{BF16_DEPART_SHARE * diff.numel() + BF16_DEPART_FLOOR:.0f}): "
          f"passes {ok}", flush=True)
    return ok, int(diff.sum()), n_dep, err


def bf16_sums_check(tag, torch, x, lab, w, k, got, want, lanes):
    """A bf16 accumulate (sums, counts) against its plain version's on the
    same labels: counts equal; each sum within BF16_SUM_REL of its rows'
    absolute weighted sum (each block partial is rounded once by each, at
    most one bf16 step apart); entries departing beyond UPDATE_REL of it
    within bf16_departures_ok.  Prints one line and returns (ok, max |sum
    error|, departing entries)."""
    from repro_torch.kernels import centroid_update
    mag, _ = centroid_update.centroid_update_plain(x.float().abs(), lab,
                                                   w.abs(), k, lanes)
    e = (got[0] - want[0]).abs()
    worst = float(torch.max(e / (BF16_SUM_REL * mag + 1e-6)))
    n_dep = int((e > UPDATE_REL * mag + 1e-6).sum())
    same_counts = torch.equal(got[1], want[1])
    ok = worst <= 1.0 and same_counts and bf16_departures_ok(n_dep, e.numel())
    print(f"[{tag}] sums vs plain (bf16, same labels): max|err| "
          f"{float(e.max()):.4g}, worst / tolerance {worst:.3g}; entries "
          f"departing {n_dep} of {e.numel()}; counts equal {same_counts}: "
          f"passes {ok}", flush=True)
    return ok, float(e.max()), n_dep


def bf16_init_check(tag, torch, x, cands, u, psi0, got, want):
    """A bf16 init sweep (new_mind, sampled, psi) against its plain
    version's: new_mind within BF16_MIND_ULPS ulps of the best score's
    largest term plus MIND_REL of ||x||^2, rows departing beyond that noise
    within bf16_departures_ok; a draw may differ only where u psi_prev is
    that close to ell mind; psi within 10 INIT_REL.  Prints one line and
    returns (ok, max |new_mind error|, differing draws)."""
    from repro_torch.kernels import ref
    n = x.shape[0]
    ell = 2.0 * K
    best = torch.cat([torch.argmin(ref.bf16_scores(x[lo:lo + (1 << 15)],
                                                   cands), dim=1)
                      for lo in range(0, n, 1 << 15)])
    _, ulp = bf16_score(torch, x, cands[best])
    xr = ref.round_bf16(x)
    noise = MIND_REL * torch.sum(xr * xr, dim=-1) + 1e-6
    tol = BF16_MIND_ULPS * ulp + noise
    e = (got[0] - want[0]).abs()
    n_dep = int((e > noise).sum())
    differ = got[1] != want[1]
    draws_ok = bool(torch.all((u * psi0 - ell * want[0]).abs()[differ]
                              <= ell * tol[differ]))
    psi_ok = bool(torch.allclose(got[2], want[2], rtol=INIT_REL * 10,
                                 atol=0))
    mind_ok = bool(torch.all(e <= tol)) and bf16_departures_ok(n_dep, n)
    ok = mind_ok and draws_ok and psi_ok
    print(f"[{tag}] kernel vs plain (bf16): new_mind max|err| "
          f"{float(e.max()):.4g} within tolerance, rows departing {n_dep} "
          f"of {n}: {mind_ok}; draws differ at {int(differ.sum())} rows, all "
          f"at the boundary {draws_ok}; psi {float(got[2]):.6e} vs "
          f"{float(want[2]):.6e} (rtol {INIT_REL * 10}) {psi_ok}: passes "
          f"{ok}", flush=True)
    return ok, float(e.max()), int(differ.sum())


def bf16_bound_ms(flops: float, nbytes: float):
    """The least time for bf16 work of ``flops`` operations that must move
    ``nbytes``: the operations at the bf16 tensor-core peak, the bytes at
    the memory rate -> (ms, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_bf16(torch, main: dict):
    """[bf16]: the main path on the main input in bfloat16 (points and
    seeds), on ``batched`` and ``fused``: bf16 results, equal lane
    iterations, centroids bit for bit between the engines and the resident
    solve of the first lanes; the bf16 carry's whole-solve time beside the
    f32 one.  Then one step of each bf16-accumulate kernel (``spec=
    KernelSpec(acc_dtype="bfloat16")``) at the main stack's shape, the
    update on the assign's labels, one init sweep of 2**23 points against
    2048 candidates, each through its public wrapper with the counts reset
    just before and read just after, each against its bf16 plain version
    (the f32 kernels and blocks of half the rows must fail those checks),
    timed beside the f32 kernel.  Returns the reports of the bf16 variants,
    or None when a check failed."""
    from repro_torch.core.ipkmeans import _partition_and_pack
    from repro_torch.kernels import (assign, centroid_update, fused, init,
                                     ops, ref, specs)
    from repro_torch.kernels import batch_resident as br
    dev = torch.device("cuda")
    spec = specs.KernelSpec(acc_dtype="bfloat16")
    upd_spec = specs.UPDATE_DEFAULT_SPEC.replace(acc_dtype="bfloat16")
    xb = main["x"].to(torch.bfloat16)
    initb = main["init"].to(torch.bfloat16)
    print(f"[bf16] data: the main input in bfloat16 "
          f"({xb.numel() * 2 / 1e9:.2f} GB), its seeds in bfloat16",
          flush=True)

    # the main path, bf16 points and seeds, on batched then fused
    cfg_b, cfg_f = main["config"]("batched"), main["config"]("fused")
    res_b, secs_b, counts_b = run_path(torch, xb, initb, cfg_b, dev)
    res_f, secs_f, counts_f = run_path(torch, xb, initb, cfg_f, dev)
    for tag, res, secs, counts in (("batched", res_b, secs_b, counts_b),
                                   ("fused", res_f, secs_f, counts_f)):
        it = res.subset_iters.float()
        print(f"[bf16] main path on {tag}: {secs:.3f} s (f32 batched "
              f"{main['secs_b']:.3f} s), launches {counts}, subset_iters "
              f"min/median/max {int(it.min())}/{float(it.median()):.0f}/"
              f"{int(it.max())}; SSE {float(res.sse):.6e} ({res.sse.dtype}; "
              f"f32 run {float(main['res_b'].sse):.6e})", flush=True)
    _, subsets_b, masks = _partition_and_pack(xb, cfg_b)
    masks = masks.float()
    lanes_same = [identical(resident_out(subsets_b[i], initb, masks[i],
                                         max_iters=MAX_ITERS, tol=TOL,
                                         reseed_empty=True)[:1],
                            (res_b.intermediate[i:i + 1],))
                  for i in range(BF16_RESIDENT_LANES)]
    n_diff = int((res_b.subset_iters != res_f.subset_iters).sum())
    same_c = torch.equal(res_b.intermediate, res_f.intermediate)
    dtypes = {str(t.dtype) for t in (res_b.centroids, res_b.intermediate,
                                     res_f.centroids, res_b.sse)}
    print(f"[bf16] batched against fused: lanes whose iters differ "
          f"{n_diff}, intermediate centroids bit for bit {same_c}, SSE "
          f"equal {torch.equal(res_b.sse, res_f.sse)}; the first "
          f"{BF16_RESIDENT_LANES} lanes' resident solves bit for bit "
          f"{lanes_same}; result dtypes {sorted(dtypes)}", flush=True)
    ok = (main["sane"](res_b) and main["sane"](res_f)
          and dtypes == {"torch.bfloat16"} and n_diff == 0 and same_c
          and torch.equal(res_b.sse, res_f.sse) and all(lanes_same)
          and counts_b == counts_of(lloyd_solve_batched=1)
          and counts_f["fused_lloyd"] > 0)
    if not ok:
        print("[bf16] FAIL main path", flush=True)
        return None

    # the bf16 carry's whole solve beside the f32 one, on the same stack
    kw = dict(max_iters=MAX_ITERS, tol=TOL, reseed_empty=True)
    m_, s_, d_ = subsets_b.shape
    carry = solve_batched(subsets_b, initb, masks, **kw)
    ms_c = cuda_time_ms(lambda: solve_batched(subsets_b, initb, masks, **kw),
                        reps=2, warmup=1)
    sub32 = subsets_b.float()
    ms_32 = cuda_time_ms(lambda: solve_batched(sub32, initb.float(), masks,
                                               **kw), reps=2, warmup=1)
    # an 8-lane slice, one trip from the seeds, against the plain version:
    # the division of sums taken in another f32 order rounds to bf16
    # within one ulp (later trips could part at a near-tie)
    xs, ws = subsets_b[:PLAIN_LANES].contiguous(), masks[:PLAIN_LANES]
    kw1 = dict(kw, max_iters=1)
    plain8 = br.lloyd_solve_plain(xs, initb, ws, **kw1)
    got8 = solve_batched(xs, initb, ws, **kw1)
    plain_ms = cuda_time_ms(lambda: br.lloyd_solve_plain(xs, initb, ws, **kw),
                            reps=1, warmup=1)
    c_err = (got8.centroids.float() - plain8.centroids.float()).abs()
    c_ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(
        plain8.centroids.float().abs(), min=1e-30))) - 7)
    slice_ok = (torch.equal(got8.iters, plain8.iters)
                and bool(torch.all(c_err <= c_ulp))
                and bool(torch.allclose(got8.sse, plain8.sse,
                                        rtol=BF16_SSE_RTOL, atol=0)))
    passes = int(carry.passes.sum())
    bound, by = solve_bound_ms(s_, d_, K, m_, passes, 0, MAX_ITERS)
    print(f"[bf16] whole-solve kernel, bf16 carry, {m_}x{s_}x{d_}, k={K}: "
          f"{ms_c:.4f} ms ({passes} score passes), the f32 kernel on the "
          f"same (widened) points and seeds {ms_32:.4f} ms, bound "
          f"{bound:.4f} ms ({by}); {PLAIN_LANES}-lane slice, one trip, "
          f"against the plain version: iters equal, centroids within one "
          f"bf16 ulp (max|err| {float(c_err.max()):.4g}), SSE rtol "
          f"{BF16_SSE_RTOL}: {slice_ok} (plain, whole solve of the slice: "
          f"{plain_ms:.4f} ms)",
          flush=True)
    if not slice_ok:
        print("[bf16] FAIL whole-solve kernel against its plain version",
              flush=True)
        return None
    out = {"lloyd_solve_batched": dict(
        ms=ms_c, ms_f32=ms_32, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, max_abs_err=float(c_err.max()),
        launches=counts_b["lloyd_solve_batched"])}

    # one step of each bf16-accumulate kernel, counted
    subsets, w = main["subsets"], main["masks"]
    cents = main["res_f"].intermediate.contiguous()
    lanes = torch.arange(M, dtype=torch.int32, device=dev)
    x = main["x"]
    n = x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    cands = x[torch.randperm(n, generator=gen, device=dev)[:INIT_C]]
    old = torch.full((n,), torch.inf, device=dev)
    old = init.init_sweep(x, cands[:1], old, torch.rand(
        n, generator=gen, device=dev), 0.0, ell=2.0 * K)[0]
    psi0 = torch.sum(old)
    u = torch.rand(n, generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    step = fused.StepLabelsOut(*ops.lloyd_step_fused(
        subsets, cents, w, spec=spec, return_labels=True))
    asg = ops.assign(subsets, cents, spec=spec)
    upd = ops.centroid_update(subsets, asg[0], w, K, spec=upd_spec)
    swp = ops.init_sweep(x, cands, old, u, psi0, ell=2.0 * K, spec=spec)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[bf16] one call of each bf16-accumulate wrapper: launches "
          f"{counts}", flush=True)
    ok = counts == counts_of(fused_lloyd=1, assign=1, centroid_update=1,
                             init_sweep=1)

    # against the plain versions
    plain = fused.fused_lloyd_plain(subsets, cents, w, spec=spec,
                                    return_labels=True)
    ok_f, diff_f, _, err_f = bf16_assign_check(
        "bf16 fused", torch, subsets, cents, (step.labels, step.mind),
        (plain.labels, plain.mind))
    step_plain = centroid_update.centroid_update_plain(
        subsets, step.labels, w, K, lanes, spec)
    ok_s, err_s, _ = bf16_sums_check(
        "bf16 fused", torch, subsets, step.labels, w, K, (step.sums,
                                                          step.counts),
        step_plain, lanes)
    sse_want = torch.sum(ref.round_bf16(w) * step.mind, dim=1)
    sse_ok = bool(torch.allclose(step.sse, sse_want, rtol=SUM_RTOL, atol=0))
    asg_plain = assign.assign_plain(subsets, cents, lanes, spec)
    ok_a, diff_a, _, err_a = bf16_assign_check(
        "bf16 assign", torch, subsets, cents, asg, asg_plain,
        x2_rows=subsets)
    upd_plain = centroid_update.centroid_update_plain(subsets, asg[0], w, K,
                                                      lanes, upd_spec)
    ok_u, err_u, _ = bf16_sums_check("bf16 update", torch, subsets, asg[0],
                                     w, K, upd, upd_plain, lanes)
    pl_i = init.init_sweep_plain(x, cands, old, u, psi0, ell=2.0 * K,
                                 spec=spec)
    ok_i, err_i, diff_i = bf16_init_check("bf16 init", torch, x, cands, u,
                                          psi0, swp, pl_i)
    ok = ok and ok_f and ok_s and sse_ok and ok_a and ok_u and ok_i

    # controls, after the counts were read: the same checks on the float32
    # kernels and on accumulates over blocks of half the rows must fail
    step32 = fused.fused_lloyd(subsets, cents, w, return_labels=True)
    half = spec.replace(block_n=spec.block_n // 2)
    step_half = fused.fused_lloyd(subsets, cents, w, spec=half)
    controls = {
        "fused f32": bf16_assign_check(
            "bf16 control: fused f32", torch, subsets, cents,
            (step32.labels, step32.mind), (plain.labels, plain.mind))[0],
        "fused half blocks": bf16_sums_check(
            "bf16 control: fused, blocks of half the rows", torch, subsets,
            step.labels, w, K, (step_half.sums, step_half.counts),
            step_plain, lanes)[0],
        "assign f32": bf16_assign_check(
            "bf16 control: assign f32", torch, subsets, cents,
            assign.assign(subsets, cents), asg_plain, x2_rows=subsets)[0],
        "update f32": bf16_sums_check(
            "bf16 control: update f32", torch, subsets, asg[0], w, K,
            centroid_update.centroid_update(subsets, asg[0], w, K),
            upd_plain, lanes)[0],
        "update half blocks": bf16_sums_check(
            "bf16 control: update, blocks of half the rows", torch, subsets,
            asg[0], w, K, centroid_update.centroid_update(
                subsets, asg[0], w, K, spec=upd_spec.replace(
                    block_n=upd_spec.block_n // 2)), upd_plain, lanes)[0],
        "init f32": bf16_init_check(
            "bf16 control: init f32", torch, x, cands, u, psi0,
            init.init_sweep(x, cands, old, u, psi0, ell=2.0 * K), pl_i)[0],
    }
    caught = not any(controls.values())
    print(f"[bf16] controls fail the bf16 checks as they must: {caught} "
          f"(passed: {[n for n, v in controls.items() if v]})", flush=True)
    ok = ok and caught
    if not ok:
        print("[bf16] FAIL bf16 kernels against their plain versions",
              flush=True)
        return None

    # times: each bf16 kernel beside the f32 kernel on the same inputs
    n_l, s, d = subsets.shape
    flops = 2.0 * n_l * s * K * d
    step_bytes = 4.0 * n_l * (s * d + K * d + s + K * d + K + 1)
    jobs = {
        "fused_lloyd": (lambda sp: fused.fused_lloyd(subsets, cents, w,
                                                     spec=sp),
                        lambda: fused.fused_lloyd_plain(subsets, cents, w,
                                                        spec=spec),
                        flops, step_bytes, err_s, diff_f),
        "assign": (lambda sp: assign.assign(subsets, cents, spec=sp),
                   lambda: assign.assign_plain(subsets, cents, lanes, spec),
                   flops, 4.0 * n_l * (s * d + K * d + 2 * s), err_a,
                   diff_a),
        "centroid_update": (
            lambda sp: centroid_update.centroid_update(
                subsets, asg[0], w, K, spec=None if sp is None else
                upd_spec),
            lambda: centroid_update.centroid_update_plain(
                subsets, asg[0], w, K, lanes, upd_spec),
            2.0 * n_l * s * d, 4.0 * n_l * (s * d + 2 * s + K * d + K),
            err_u, 0),
        "init_sweep": (
            lambda sp: init.init_sweep(x, cands, old, u, psi0, ell=2.0 * K,
                                       spec=sp),
            lambda: init.init_sweep_plain(x, cands, old, u, psi0,
                                          ell=2.0 * K, spec=spec),
            2.0 * n * INIT_C * d, 4.0 * (n * d + INIT_C * d + 3 * n + n + 1)
            + n, err_i, diff_i),
    }
    launched = {"fused_lloyd": counts["fused_lloyd"],
                "assign": counts["assign"],
                "centroid_update": counts["centroid_update"],
                "init_sweep": counts["init_sweep"]}
    for name, (run, plain_run, fl, nb, err, ties) in jobs.items():
        ms = cuda_time_ms(lambda: run(spec), reps=3)
        ms_32 = cuda_time_ms(lambda: run(None), reps=3)
        plain_ms = cuda_time_ms(plain_run, reps=1, warmup=1)
        bound, by = bf16_bound_ms(fl, nb)
        print(f"[bf16 {name}] kernel {ms:.4f} ms (f32 kernel {ms_32:.4f} "
              f"ms), plain version {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}, bf16 tensor-core peak; at the f32 CUDA-core peak the "
              f"product alone takes {fl / PEAK_F32_FLOPS * 1e3:.4f} ms)",
              flush=True)
        out[name] = dict(ms=ms, ms_f32=ms_32, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None,
                         max_abs_err=err, launches=launched[name],
                         near_tie_labels=ties)
    return out


# [dist]: ranks of the distributed pipeline (distributed/world.py), the
# seconds before their world is killed, and the int8 error-feedback bars:
# its wire bytes a lane-trip against exact's (int8 values plus f32 scales:
# 0.265 at d = 64), and its lanes against a plain version of the reduction
# run in this process on the same pod slices and the same fused steps
# (iterations exact, centroids within INT8EF_RTOL of max(|c|, 1): the same
# operations in the same order).  Its SSE against exact's is printed, not
# gated: the reference's bar there (1e-3) fails for the reference itself
# (tests/test_torch_distributed.py holds the port's int8ef to the
# reference's on a small input)
DIST_RANKS = 4
DIST_DEADLINE = 300.0
INT8EF_BYTES = 0.3
INT8EF_RTOL = 1e-6


def dist_rank(rank, world_size, device, paths, n, k, m):
    """[dist] on one rank (``distributed/world.py`` calls it in each rank's
    process): the main input (``n`` points, ``k`` seeds, ``m`` subsets)
    made from the seed on the rank's device and kept on the host, then
    each path through its entry point, the kernel launch counts and the
    collective counts set to 0 just before and read just after, with the
    stage times, the wall time and the peak device memory.  Returns each
    path's numbers and results (rank 0 also the flat run's intermediate
    centroids)."""
    import numpy as np
    import torch
    from repro_torch.core import IPKMeansConfig, KMeansParams
    from repro_torch.core.init import kmeans_parallel_init
    from repro_torch.core.ipkmeans import ipkmeans_distributed
    from repro_torch.core.pkmeans import pkmeans_sharded
    from repro_torch.distributed import comm, sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    x = mixture(torch.Generator(device=device).manual_seed(SEED), n, D, k,
                device)
    init = x[torch.as_tensor(np.random.default_rng(SEED).choice(
        n, k, replace=False), device=device)]
    host = x.cpu()
    del x
    if cuda:
        torch.cuda.empty_cache()
    flat = sharding.kmeans_data_mesh(world_size)
    pod = sharding.kmeans_pod_mesh(2, world_size // 2)
    data = (sharding.KMEANS_DATA_AXIS,)

    def params(backend, reseed, max_iters=MAX_ITERS):
        return KMeansParams(max_iters=max_iters, tol=TOL, backend=backend,
                            reseed_empty=reseed)

    def cfg(reseed, reduce="exact"):
        return IPKMeansConfig(num_clusters=k, num_subsets=m, reduce=reduce,
                              kmeans=params("batched", reseed))

    runs = {
        "flat": lambda: ipkmeans_distributed(host, init, cfg(True), flat,
                                             data, device=device),
        "kmeans||": lambda: kmeans_parallel_init(
            host, k, generator=torch.Generator(device=device).manual_seed(
                SEED), return_stats=True, mesh=flat, axis_names=data,
            device=device),
        "pod exact": lambda: ipkmeans_distributed(
            host, init, cfg(False), pod, data, sharding.KMEANS_POD_AXIS,
            device=device),
        "pod int8ef": lambda: ipkmeans_distributed(
            host, init, cfg(False, "int8ef"), pod, data,
            sharding.KMEANS_POD_AXIS, device=device),
        "pkmeans": lambda: pkmeans_sharded(flat, data, params(
            "twopass", False))(host, init, device=device),
        "pkmeans 1 trip": lambda: pkmeans_sharded(flat, data, params(
            "twopass", False, 1))(host, init, device=device),
    }
    out = {}
    for name in paths:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        comm.reset(timed=True)
        t0 = time.perf_counter()
        res = runs[name]()
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec = dict(secs=secs, launches=read_counts(), comm=comm.read(),
                   stage_s=dict(comm.seconds),
                   peak_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                            if cuda else 0.0))
        if name == "kmeans||":
            rec.update(seeds=res[0].cpu(), psi=res[1]["psi"],
                       candidates=res[1]["candidates"])
        elif name.startswith("pkmeans"):
            rec.update(centroids=res.centroids.cpu(), sse=float(res.sse),
                       iters=int(res.iters))
        else:
            rec.update(centroids=res.centroids.cpu(), sse=float(res.sse),
                       subset_iters=res.subset_iters.cpu())
            if name in ("flat", "pod int8ef") and rank == 0:
                rec["intermediate"] = res.intermediate.cpu()
        out[name] = rec
    return out


def plain_int8ef(torch, slices, masks, init, max_iters: int, tol: float):
    """The cross-pod S2 with ``reduce="int8ef"`` for one column of lanes,
    in plain PyTorch in one process: ``slices[p] (L, S_p, d)`` and
    ``masks[p]`` are pod ``p``'s points of the column's lanes.  Each trip,
    each pod's (sums, counts) of the active lanes come from the fused step
    (the kernel [fused] holds against its plain version), then the
    reduction written out here apart from ``distributed/compress.py``: per
    row, ``v = stats + residual``, scale ``amax * f32(1/127)`` (1 where
    ``amax`` is 0), ``q = clamp(round(v / scale), +-127)``, the residual ``v
    - q scale`` kept for the next trip, the pods' ``q scale`` summed in pod
    order (each after the first in one rounding); the divide keeps an
    empty cluster's centroid; the lane's stop threshold widens to the
    noise floor ``sqrt(d) max_k (e_s + max|c| e_n) / max(n - e_n, 1)``
    with ``e`` half the pods' scales summed.  -> ``(centroids (L, k, d),
    iters (L,))``."""
    from repro_torch.kernels import engine as engines
    step = engines.get_engine("batched").step
    pods = len(slices)
    lanes_n, (k, d) = slices[0].shape[0], init.shape
    dev = slices[0].device
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
    c = init.float().expand(lanes_n, k, d).clone()
    iters = torch.zeros(lanes_n, dtype=torch.int32, device=dev)
    shift = torch.full((lanes_n,), torch.inf, device=dev)
    stop = torch.full((lanes_n,), tol, device=dev)
    res = [[torch.zeros((lanes_n, k, d), device=dev),
            torch.zeros((lanes_n, k), device=dev)] for _ in range(pods)]

    def quantize(v):
        amax = torch.amax(torch.abs(v), dim=-1, keepdim=True)
        scale = torch.where(amax > 0.0, amax, 127.0) * inv127
        return torch.clamp(torch.round(v / scale), -127.0, 127.0), scale

    while True:
        act = (iters < max_iters) & (shift > stop)
        lanes = torch.nonzero(act).flatten().to(torch.int32)
        if lanes.numel() == 0:
            break
        sel = lanes.long()
        acc = [None, None]
        half = [None, None]
        for p in range(pods):
            sums, counts, _ = step(slices[p], c, masks[p], lanes)
            for j, stat in enumerate((sums, counts)):
                v = stat + res[p][j][sel]
                q, scale = quantize(v)
                res[p][j][sel] = (v.double() - q.double()
                                  * scale.double()).float()
                if p == 0:
                    acc[j], half[j] = q * scale, scale
                else:
                    acc[j] = (acc[j].double()
                              + q.double() * scale.double()).float()
                    half[j] = half[j] + scale
        e_s, e_n = 0.5 * half[0][..., 0], 0.5 * half[1]
        cnt = torch.clamp(acc[1], min=0.0)
        old = c[sel]
        upd = torch.where(cnt.unsqueeze(-1) > 0.0,
                          acc[0] / torch.clamp(cnt, min=1.0).unsqueeze(-1),
                          old)
        noise = torch.where(
            cnt > 0.0, (e_s + torch.amax(torch.abs(upd), dim=-1) * e_n)
            / torch.clamp(cnt - e_n, min=1.0), 0.0)
        stop[sel] = torch.clamp(
            torch.sqrt(torch.tensor(float(d), device=dev))
            * torch.amax(noise, dim=-1), min=tol)
        c[sel] = upd
        shift[sel] = torch.amax(torch.sqrt(torch.sum((upd - old) ** 2,
                                                     dim=-1)), dim=-1)
        iters[sel] += 1
    return c, iters


def phase_dist(torch, reports: dict, main: dict) -> bool:
    """[dist]: the distributed pipeline on DIST_RANKS ranks (NCCL with a
    card a rank where the machine has that many, else gloo on cuda:0,
    every collective through host memory), at the main path's size: the
    flat (4,) mesh on ``batched`` (one whole-solve launch a rank, no
    collective in S2), intermediate centroids and lane iterations bit for
    bit [main]'s single-process run; the sharded k-means|| seeding against
    [seed]'s seeds (same draws; every row equal); the (2, 2) pod path with
    ``exact`` (SSE within rtol 1e-4 of a single-process
    ``s1="histogram"`` run, lane iterations equal) and ``int8ef`` (its
    wire bytes a lane-trip against exact's; its lanes against
    ``plain_int8ef``, iterations exact and centroids within INT8EF_RTOL;
    its SSE against exact's printed); ``pkmeans_sharded`` on ``twopass``
    (one all-reduce of K d + K floats a trip) against the single-process
    job with the same settings, and one trip of it against one
    single-process trip (centroids within PK_RTOL of max(|c|, 1)).  Per
    rank: stage times, launches, collectives and bytes by stage, peak
    memory."""
    from repro_torch.core import IPKMeansConfig, KMeansParams, ipkmeans
    from repro_torch.core import init as seeding
    from repro_torch.core import pkmeans
    from repro_torch.core.ipkmeans import _partition_and_pack
    from repro_torch.distributed import world
    dev = main["x"].device
    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    backend = world.pick_backend(dev.type, DIST_RANKS)
    cards = min(torch.cuda.device_count(), DIST_RANKS)
    # the ranks share the card with this process: hand its cached blocks
    # back first
    torch.cuda.empty_cache()
    how = ("a card a rank" if backend == "nccl" else
           "ranks share cuda:0, collectives through host memory")
    print(f"[dist] {DIST_RANKS} ranks on {backend} over {cards} card(s) "
          f"({how}); n={N} d={D} K={K} M={M}; this process holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; {smi}", flush=True)
    paths = ("flat", "kmeans||", "pod exact", "pod int8ef", "pkmeans",
             "pkmeans 1 trip")
    t0 = time.perf_counter()
    outs = world.run(dist_rank, DIST_RANKS, args=(paths, N, K, M),
                     device=dev.type, deadline=DIST_DEADLINE)
    wall = time.perf_counter() - t0
    for r, o in enumerate(outs):
        for name in paths:
            rec = o[name]
            print(f"[dist] rank {r} {name}: {rec['secs']:.3f} s, stages "
                  + json.dumps({k: round(v, 4)
                                for k, v in rec["stage_s"].items()})
                  + f", launches {rec['launches']}, collectives "
                  f"{json.dumps(rec['comm'])}, peak memory "
                  f"{rec['peak_gb']:.2f} GB", flush=True)

    # the single-process runs to hold them against
    x, init = main["x"], main["init"]
    hist_cfg = IPKMeansConfig(num_clusters=K, num_subsets=M, s1="histogram",
                              kmeans=KMeansParams(max_iters=MAX_ITERS,
                                                  tol=TOL, backend="batched"))
    single_hist = ipkmeans(x, init, hist_cfg, device=dev)
    pk_params = KMeansParams(max_iters=MAX_ITERS, tol=TOL, backend="twopass")
    single_pk = pkmeans(x, init, None, pk_params, device=dev)
    single_pk1 = pkmeans(x, init, None, pk_params._replace(max_iters=1),
                         device=dev)
    _, kpar_stats = seeding.kmeans_parallel_init(
        x, K, generator=torch.Generator(device=dev).manual_seed(SEED),
        return_stats=True)
    res_b = main["res_b"]

    flat = [o["flat"] for o in outs]
    bits = (torch.equal(flat[0]["intermediate"], res_b.intermediate.cpu())
            and all(torch.equal(f["subset_iters"], res_b.subset_iters.cpu())
                    for f in flat)
            and all(torch.equal(f["centroids"], res_b.centroids.cpu())
                    for f in flat))
    s2_calls = [f["comm"].get("s2", {}).get("calls", 0) for f in flat]
    one_launch = all(f["launches"] == counts_of(lloyd_solve_batched=1)
                     for f in flat)
    print(f"[dist] flat: intermediate centroids, lane iterations and final "
          f"centroids bit for bit [main]'s single-process run {bits}; S2 "
          f"collectives by rank {s2_calls}; one whole-solve launch a rank "
          f"and no other {one_launch}; SSE {flat[0]['sse']:.6e} "
          f"(single-process {float(res_b.sse):.6e})", flush=True)
    ok = bits and s2_calls == [0] * DIST_RANKS and one_launch

    kp = [o["kmeans||"] for o in outs]
    psi_rel = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(kp[0]["psi"], kpar_stats["psi"]))
    seed_rows = int((kp[0]["seeds"] != main["kpar_seeds"].cpu())
                    .any(dim=1).sum())
    same_ranks = all(torch.equal(k["seeds"], kp[0]["seeds"]) for k in kp)
    rounds = len(kpar_stats["psi"])
    kp_counts = all(k["launches"] == counts_of(init_sweep=rounds, assign=1)
                    for k in kp)
    print(f"[dist] kmeans||: potentials within {psi_rel:.3g} (rel) of the "
          f"single-process seeding's, candidates {kp[0]['candidates']} "
          f"against {kpar_stats['candidates']}; seed rows differing from "
          f"[seed]'s {seed_rows} of {K}; every rank the same seeds "
          f"{same_ranks}; {rounds} sweeps and 1 assign a rank "
          f"{kp_counts}", flush=True)
    ok = (ok and same_ranks and kp_counts and psi_rel <= INIT_REL
          and seed_rows == 0)

    ex = [o["pod exact"] for o in outs]
    q8 = [o["pod int8ef"] for o in outs]
    ex_rel = abs(ex[0]["sse"] - float(single_hist.sse)) / float(
        single_hist.sse)
    q_rel = abs(q8[0]["sse"] - ex[0]["sse"]) / ex[0]["sse"]
    # rank 0 is pod 0, data column 0: it solves the first M / 2 lanes
    mine = slice(0, M // (DIST_RANKS // 2))
    lane_trips = [int(e["subset_iters"][mine].sum()) for e in (ex[0], q8[0])]
    per_trip = [e["comm"]["s2"]["bytes"] / t
                for e, t in zip((ex[0], q8[0]), lane_trips)]
    ratio = per_trip[1] / per_trip[0]
    replicated = all(e["sse"] == ex[0]["sse"] for e in ex) and all(
        e["sse"] == q8[0]["sse"] for e in q8)
    same_iters = torch.equal(ex[0]["subset_iters"],
                             single_hist.subset_iters.cpu())
    print(f"[dist] pod exact: SSE {ex[0]['sse']:.6e} against the "
          f"single-process s1=histogram run's {float(single_hist.sse):.6e} "
          f"(rel {ex_rel:.3g}, rtol {PK_RTOL}); lane iterations equal "
          f"{same_iters}; pod int8ef: SSE {q8[0]['sse']:.6e}, rel "
          f"{q_rel:.3g} of exact's; S2 bytes a lane-trip "
          f"{per_trip[1]:.0f} against exact's {per_trip[0]:.0f} "
          f"(ratio {ratio:.4f}, bar {INT8EF_BYTES}); every rank the same "
          f"SSE {replicated}", flush=True)
    ok = (ok and ex_rel <= PK_RTOL and same_iters and ratio <= INT8EF_BYTES
          and replicated and 0.0 < q8[0]["sse"] < main["one"])

    # int8ef against its plain version: the pods' slices of each data
    # column from the single-process histogram S1 and scatter pack (the
    # sharded S1's ids bit for bit), the capacity padded to a multiple of
    # the pods
    pods, cols = 2, DIST_RANKS // 2
    _, pack, pmask = _partition_and_pack(x, hist_cfg)
    pad = -pack.shape[1] % pods
    pack = torch.nn.functional.pad(pack, (0, 0, 0, pad))
    pmask = torch.nn.functional.pad(pmask, (0, pad)).float()
    half, per_col = pack.shape[1] // pods, M // cols
    plain_c, plain_it = [], []
    for j in range(cols):
        lanes = slice(j * per_col, (j + 1) * per_col)
        c_j, it_j = plain_int8ef(
            torch, [pack[lanes, p * half:(p + 1) * half].contiguous()
                    for p in range(pods)],
            [pmask[lanes, p * half:(p + 1) * half].contiguous()
             for p in range(pods)], init, MAX_ITERS, TOL)
        plain_c.append(c_j.cpu())
        plain_it.append(it_j.cpu())
    del pack, pmask
    plain_c, plain_it = torch.cat(plain_c), torch.cat(plain_it)
    q8_c = q8[0]["intermediate"]
    q8_err = float(torch.max(torch.abs(q8_c - plain_c)
                             / torch.clamp(torch.abs(plain_c), min=1.0)))
    q8_iters = torch.equal(q8[0]["subset_iters"], plain_it.int())
    print(f"[dist] pod int8ef against its plain version (the reduction in "
          f"plain PyTorch on the same pod slices and fused steps): lane "
          f"iterations equal {q8_iters} (min/median/max "
          f"{int(plain_it.min())}/{int(plain_it.median())}/"
          f"{int(plain_it.max())}), intermediate centroids within "
          f"{q8_err:.3g} of max(|c|, 1) (bar {INT8EF_RTOL})", flush=True)
    ok = ok and q8_iters and q8_err <= INT8EF_RTOL

    pk = [o["pkmeans"] for o in outs]
    trips = pk[0]["iters"]
    per = 4 * (K * D + K)
    pk_comm = all(p["comm"]["pkmeans"] == {"calls": trips,
                                            "bytes": trips * per}
                  for p in pk)
    pk_rel = abs(pk[0]["sse"] - float(single_pk.sse)) / float(single_pk.sse)
    c_diff = float(torch.max(torch.abs(pk[0]["centroids"]
                                       - single_pk.centroids.cpu())))
    # one trip from the seeds: the same labels (a point's scores do not
    # depend on its row block), the sums in another order
    pk1 = [o["pkmeans 1 trip"] for o in outs]
    c1 = single_pk1.centroids.cpu()
    pk1_err = max(float(torch.max(torch.abs(p["centroids"] - c1)
                                  / torch.clamp(torch.abs(c1), min=1.0)))
                  for p in pk1)
    pk_ok = (trips == int(single_pk.iters) and pk_rel <= PK_RTOL and pk_comm
             and all(p["launches"] == counts_of(
                 assign=trips + 1, centroid_update=trips) for p in pk)
             and all(p["iters"] == 1 for p in pk1) and pk1_err <= PK_RTOL)
    red_ms = pk[0]["stage_s"]["pkmeans"] / trips * 1e3
    trip_ms = (pk[0]["secs"] - pk[0]["stage_s"]["sse"]) / trips * 1e3
    print(f"[dist] pkmeans_sharded on twopass: {trips} trips (single "
          f"process {int(single_pk.iters)}), one all-reduce of {per} bytes "
          f"a trip {pk_comm}, {red_ms:.3f} ms of a {trip_ms:.3f} ms trip on "
          f"rank 0 ({red_ms / trip_ms:.3f}); SSE {pk[0]['sse']:.6e} against "
          f"{float(single_pk.sse):.6e} (rel {pk_rel:.3g}, rtol {PK_RTOL}); "
          f"largest centroid difference {c_diff:.3g} after {trips} trips, "
          f"{pk1_err:.3g} of max(|c|, 1) after one (rtol {PK_RTOL}); passes "
          f"{pk_ok}", flush=True)
    ok = ok and pk_ok

    a_rank = "dist, a rank"
    reports["lloyd_solve_batched"].setdefault("launches_by_path", {})[
        f"{a_rank}: flat ipkmeans"] = flat[0]["launches"][
            "lloyd_solve_batched"]
    fused_paths = reports["fused_lloyd"].setdefault("launches_by_path", {})
    fused_paths[f"{a_rank}: pod exact"] = ex[0]["launches"]["fused_lloyd"]
    fused_paths[f"{a_rank}: pod int8ef"] = q8[0]["launches"]["fused_lloyd"]
    reports["assign"]["launches_by_path"].update({
        f"{a_rank}: kmeans||": kp[0]["launches"]["assign"],
        f"{a_rank}: pkmeans twopass": pk[0]["launches"]["assign"]})
    reports["centroid_update"]["launches_by_path"][
        f"{a_rank}: pkmeans twopass"] = pk[0]["launches"]["centroid_update"]
    reports["init_sweep"].setdefault("launches_by_path", {})[
        f"{a_rank}: kmeans||"] = kp[0]["launches"]["init_sweep"]
    print(json.dumps({"dist": dict(
        device=smi, backend=backend, ranks=DIST_RANKS, world_s=wall,
        by_rank=[{name: {k: v for k, v in o[name].items()
                         if not isinstance(v, torch.Tensor)}
                  for name in paths} for o in outs],
        pod_exact_rel=ex_rel, int8ef_rel=q_rel, int8ef_bytes_ratio=ratio,
        pkmeans_rel=pk_rel, pkmeans_one_trip_rel=pk1_err,
        int8ef_plain_rel=q8_err, pkmeans_reduce_ms=red_ms,
        pkmeans_trip_ms=trip_ms, kpar_psi_rel=psi_rel,
        kpar_seed_rows=seed_rows)}), flush=True)
    print(f"[dist] the phase took {time.perf_counter() - t_phase:.1f} s (the "
          f"world {wall:.1f} s)", flush=True)
    if not ok:
        print("[dist] FAIL", flush=True)
    return ok


KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("src/repro_torch is not beside chip_smoke.py: run it "
                    "from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE f32 everywhere
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    smi = nvidia_smi_line()
    print(smi, flush=True)

    from repro_torch.kernels import _build, assign, batch_resident, fused
    sources = [fused.SOURCE, batch_resident.SOURCE, assign.SOURCE]
    t0 = time.perf_counter()
    # one nvcc for each source, all started together
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    for src in sources:
        _build.load(src)
    print(f"build: {', '.join(sources)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc " + ", ".join(f"{_build.build_seconds.get(src, 0.0):.2f} s"
                                for src in sources) + ")", flush=True)
    for src in sources:
        lines = ptxas_summary(_build.build_log.get(src, ""))
        for line in lines or ["(an earlier build: no ptxas report)"]:
            print(f"build: {src}: {line}", flush=True)

    def rep(name, source, replaces):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces}

    report = rep("fused_lloyd", SOURCE, REPLACES)
    batched = rep("lloyd_solve_batched", SOLVE_SOURCE, REPLACES_BATCHED)
    res_rep = rep("lloyd_solve_resident", SOLVE_SOURCE, REPLACES_RESIDENT)
    assign_rep = rep("assign", SWEEPS_SOURCE, REPLACES_ASSIGN)
    update_rep = rep("centroid_update", SWEEPS_SOURCE, REPLACES_UPDATE)
    init_rep = rep("init_sweep", SWEEPS_SOURCE, REPLACES_INIT)
    if not phase_kernel(torch, report):
        return fail("fused kernel against its plain version")
    if not phase_solve(torch, batched):
        return fail("whole-solve kernel against its plain version")
    if not phase_small(torch):
        return fail("small-input agreement, card against CPU")
    big = phase_assign(torch, assign_rep)
    if big is None:
        return fail("assign kernel against its plain version")
    main_run = phase_main(torch, report, batched)
    if main_run is None:
        return fail("main path")
    if not phase_serve(torch, report, main_run):
        return fail("serving tier")
    if not phase_resident(torch, res_rep, main_run):
        return fail("resident solve")
    if not phase_recover(torch, batched, report, main_run):
        return fail("recoverable IPKMeans")
    if not phase_ckpt(torch, main_run):
        return fail("checkpoint round trip")
    if not phase_update(torch, update_rep, main_run, big):
        return fail("centroid-update kernel against its plain version")
    if not phase_init(torch, init_rep, main_run):
        return fail("init-sweep kernel against its plain version")
    tune = phase_tune(torch, {r["name"]: r for r in (
        report, batched, assign_rep, init_rep)}, main_run, big)
    if tune is None:
        return fail("score tile widths, group sizes and the tuner's sweep")
    del big
    if not phase_seed(torch, init_rep, assign_rep, main_run):
        return fail("k-means|| seeding")
    if not phase_twopass(torch, update_rep, assign_rep, main_run):
        return fail("twopass engine on the main path")
    if not phase_pkmeans(torch, report, assign_rep, update_rep, main_run):
        return fail("PKMeans baseline")
    if not phase_s1(torch, main_run):
        return fail("S1 variants")
    if not phase_merge(torch, main_run):
        return fail("hierarchical merge")
    bf16 = phase_bf16(torch, main_run)
    if bf16 is None:
        return fail("bfloat16 carry and bf16-accumulate kernels")
    if not phase_dist(torch, {r["name"]: r for r in (
            report, batched, assign_rep, update_rep, init_rep)}, main_run):
        return fail("distributed pipeline")
    variants = [{"name": r["name"] + "[bf16]", "route": r["route"],
                 "source": r["source"], "replaces": r["replaces"],
                 **bf16[r["name"]]}
                for r in (report, batched, assign_rep, update_rep, init_rep)]
    reports = (report, batched, res_rep, assign_rep, update_rep, init_rep,
               *variants, *tune)
    kernels = [{key: r[key] for key in KEYS + ("launches_by_path",)
                if key in r} for r in reports]
    for r in (report, batched, res_rep, update_rep, *variants, *tune):
        extra = {key: r[key] for key in r if key not in KEYS}
        print(json.dumps({r["name"]: extra}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
