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
     bit-identical;
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
  6. [resident]: one full-width solve through ``kmeans(...,
     backend="resident")``, its R, beside the fused engine's solve;
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
     batched job (printed, not gated); one trip's time beside its bound and
     one fused one-lane step's; ``twopass`` and ``fused`` bit-identical for
     3 iterations; ``twopass`` against the plain ``eager`` engine on the
     first 2**18 points, and trip by trip for 2 trips on the whole lane,
     with one fused step against the eager step there;
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
 15. a ``{"kernels": [...]}`` line, the card's line, and as the last line
     ``{"ok": true, "device": {...}}``.

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

# H100 SXM data sheet, at its 700 W limit: f32 without tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
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
    (anonymous) namespace, with <true>/<false> for a bool template flag."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    i = m.end() + int(m.group(1))
    n = re.match(r"\d+", mangled[i:])
    if not n:
        return mangled
    i += n.end()
    ident = mangled[i:i + int(n.group(0))]
    rest = mangled[i + int(n.group(0)):]
    return ident + ("<true>" if rest.startswith("ILb1E") else
                    "<false>" if rest.startswith("ILb0E") else "")


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


def library_step(x, c, w, lanes_per_chunk: int = 32):
    """Yardstick for one fused step from PyTorch library calls: matmul
    scores, argmin, index_add_, over chunks of lanes so the (lanes, S, k)
    scores stay near 2 GB.  Timed here only; the port never calls it."""
    import torch
    out = []
    for lo in range(0, x.shape[0], lanes_per_chunk):
        xs, cs, ws = (t[lo:lo + lanes_per_chunk] for t in (x, c, w))
        n_l, s, d = xs.shape
        k = cs.shape[1]
        cn = torch.sum(cs * cs, dim=-1)
        scores = cn.unsqueeze(1) - 2.0 * torch.bmm(xs, cs.transpose(1, 2))
        best, labels = torch.min(scores, dim=-1)
        mind = torch.clamp(best + torch.sum(xs * xs, dim=-1), min=0.0)
        flat = (labels + k * torch.arange(n_l, device=x.device).unsqueeze(1)
                ).flatten()
        sums = torch.zeros((n_l * k, d), device=x.device).index_add_(
            0, flat, (xs * ws.unsqueeze(-1)).reshape(-1, d))
        counts = torch.zeros(n_l * k, device=x.device).index_add_(
            0, flat, ws.flatten())
        out.append((sums.view(n_l, k, d), counts.view(n_l, k),
                    torch.sum(ws * mind, dim=-1)))
    return [torch.cat(parts) for parts in zip(*out)]


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
    # centroids: the shape of the first slice's launches
    report.update(time_step("stack", subsets, res_f.intermediate.contiguous(),
                            masks, reps=3))
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
    n_valid = int(((labs >= 0) & (labs < k1)).sum())
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
          f"bound {skew_bound:.4f} ms", flush=True)
    report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=lib_ms,
                  max_abs_err=max(err, err_big, err_skew),
                  chunk_plan=[plan.rows, plan.chunks], one_lane_ms=big_ms,
                  one_lane_library_ms=big_lib_ms,
                  one_lane_bound_ms=big_bound,
                  one_lane_chunk_plan=[plan1.rows, plan1.chunks],
                  skewed_ms=skew_ms, skewed_bound_ms=skew_bound,
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
        with mock.patch.object(seeding, "_sweep", lambda _: sweep):
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
    one trip's time beside its bound, ``twopass`` against ``fused`` for
    PK_CHECK_ITERS iterations bit for bit, one fused one-lane step's time,
    ``twopass`` against the plain ``eager`` engine on the first
    PK_SMALL_N points (whole runs and trip by trip), and trip by trip on
    the whole lane for PK_FULL_TRIPS trips, with one fused step."""
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
    fused_ms = cuda_time_ms(lambda: fused_engine.step(x1, c1), reps=1,
                            warmup=1)
    print(f"[pkmeans] one twopass trip {N}x{D}, k={K}: {trip_ms:.4f} ms "
          f"against a bound of {a_bound:.4f} ms ({a_by}) + {u_bound:.4f} ms "
          f"({u_by}); the job's {secs * 1e3 / max(iters, 1):.4f} ms a trip "
          f"on the host clock (reseed passes and the final SSE included); "
          f"one fused one-lane step {fused_ms:.4f} ms (one block "
          f"accumulates the lane)", flush=True)

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

    report.setdefault("launches_by_path", {})[
        f"pkmeans fused, {PK_CHECK_ITERS} iterations"] = \
        counts_f["fused_lloyd"]
    assign_rep["launches_by_path"]["pkmeans twopass"] = counts["assign"]
    update_rep["launches_by_path"] = {
        "ipkmeans twopass": update_rep["launches"],
        "pkmeans twopass": counts["centroid_update"]}
    report["pkmeans_fused_step_ms"] = fused_ms
    ok = (main["sane"](res) and same and small_ok and full_ok
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
    if not phase_resident(torch, res_rep, main_run):
        return fail("resident solve")
    if not phase_update(torch, update_rep, main_run, big):
        return fail("centroid-update kernel against its plain version")
    del big
    if not phase_init(torch, init_rep, main_run):
        return fail("init-sweep kernel against its plain version")
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
    reports = (report, batched, res_rep, assign_rep, update_rep, init_rep)
    kernels = [{key: r[key] for key in KEYS + ("launches_by_path",)
                if key in r} for r in reports]
    for r in (report, batched, res_rep, update_rep):
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
