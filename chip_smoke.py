#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/``, holds
each against its plain PyTorch version, drives the IPKMeans main path
(kd-tree S1 -> fused-kernel S2 with empty-cluster reseeding -> min-ASSE S3)
at full size through ``repro_torch.core.ipkmeans.ipkmeans``, and checks the
result.  Phases:

  1. device and build: the card's name and power limit, the build time;
  2. kernel against its plain version, both modes, at the main path's lane
     shape and on a ragged case; determinism on a repeat launch; the
     kernel's, the plain version's and one library yardstick's times;
     these times are taken again over the whole stack after phase 4, and
     those go into the report;
  3. small-input agreement of the whole pipeline, card against CPU;
  4. the main path at full size (n = 2**23, d = 64, K = 1024, M = 512);
  5. a ``{"kernels": [...]}`` line, the card's line, and as the last line
     ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero and prints no last line.  Without a CUDA
card, or without the repository's ``src/repro_torch`` beside this file, it
exits non-zero at once.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/fused_lloyd.cu"
REPLACES = "src/repro/kernels/fused.py:47"

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


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def step_bound_ms(n_lanes: int, s: int, d: int, k: int):
    """Least time for one fused step on these shapes: the larger of the f32
    operations (2*S*k*d per lane, the score product) over the f32 peak and
    the bytes (points, centroids and weights read once, sums, counts and
    sse written once) over the memory rate."""
    flops = 2.0 * n_lanes * s * k * d
    nbytes = 4.0 * n_lanes * (s * d + k * d + s + k * d + k + 1)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


def check_case(name, x, c, w, torch):
    """Phase 2 on one input: both modes against the plain version, and
    bitwise repeatability.  Returns (ok, max_abs_err of sums)."""
    from repro_torch.kernels import fused
    ka = fused.fused_lloyd(x, c, assign_only=True)
    pa = fused.fused_lloyd_plain(x, c, assign_only=True)
    torch.cuda.synchronize()
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


def phase_small(torch) -> bool:
    """The whole pipeline on a small input, card against CPU (plain
    version): subset ids and iterations exact, SSE within rtol 1e-4."""
    import numpy as np
    from repro_torch.core import IPKMeansConfig, KMeansParams, ipkmeans
    from repro_torch.core.ipkmeans import _partition_and_pack
    rng = np.random.default_rng(SEED)
    x = (rng.normal(size=(2048, 8)) * 3.0).astype(np.float32)
    init = x[rng.choice(2048, 16, replace=False)]
    cfg = IPKMeansConfig(num_clusters=16, num_subsets=8, kmeans=KMeansParams(
        max_iters=50, tol=TOL, backend="fused", reseed_empty=True))
    g = ipkmeans(x, init, cfg, device="cuda")
    h = ipkmeans(x, init, cfg, device="cpu")
    ids_g = _partition_and_pack(torch.as_tensor(x, device="cuda"), cfg)[0]
    ids_h = _partition_and_pack(torch.as_tensor(x), cfg)[0]
    same_ids = torch.equal(ids_g.subset_ids.cpu(), ids_h.subset_ids)
    same_iters = torch.equal(g.subset_iters.cpu(), h.subset_iters)
    rel = abs(float(g.sse) - float(h.sse)) / float(h.sse)
    print(f"[small] n=2048 d=8 K=16 M=8: subset ids equal={same_ids}, "
          f"iters equal={same_iters} ({h.subset_iters.tolist()}), sse card "
          f"{float(g.sse):.6f} cpu {float(h.sse):.6f} rel {rel:.3g}",
          flush=True)
    return same_ids and same_iters and rel <= 1e-4 and bool(
        torch.isfinite(g.centroids).all())


def phase_main(torch, report: dict) -> bool:
    import numpy as np
    from repro_torch.core import IPKMeansConfig, KMeansParams, ipkmeans
    from repro_torch.core.ipkmeans import _merge_stage, _partition_and_pack
    from repro_torch.core.kmeans import kmeans_batched
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
    cfg = IPKMeansConfig(num_clusters=K, num_subsets=M, kmeans=KMeansParams(
        max_iters=MAX_ITERS, tol=TOL, backend="fused", reseed_empty=True))

    # the entry point a user calls, with the launch count read around it
    fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ipkmeans(x, init, cfg, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = fused.launches
    report["launches"] = launches

    # the same stages once more, one at a time, for their wall times
    t0 = time.perf_counter()
    part, subsets, masks = _partition_and_pack(x, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stage = kmeans_batched(subsets, masks, init, cfg.kmeans,
                                      device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    final, sse = _merge_stage(x, stage)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    it = res.subset_iters.float()
    one = 0.0
    mean = x.double().mean(0)
    for lo in range(0, N, 1 << 21):
        one += float(torch.sum((x[lo:lo + (1 << 21)].double() - mean) ** 2))
    sse_f = float(res.sse)
    print(f"[main] ipkmeans: K={K} M={M} depth={res.kd_depth} capacity="
          f"{subsets.shape[1]} max_iters={MAX_ITERS} tol={TOL} reseed_empty="
          f"True backend=fused: {total_s:.3f} s, fused launches {launches}",
          flush=True)
    print(f"[main] stages: S1 {t1 - t0:.3f} s, S2 {t2 - t1:.3f} s, S3 "
          f"{t3 - t2:.3f} s", flush=True)
    print(f"[main] subset_iters min/median/max "
          f"{int(it.min())}/{float(it.median()):.0f}/{int(it.max())}, lanes "
          f"at max_iters {int((res.subset_iters >= MAX_ITERS).sum())}, "
          f"converged {int((res.subset_iters < MAX_ITERS).sum())}", flush=True)
    print(f"[main] SSE {sse_f:.6e} (one-centroid SSE {one:.6e}, ratio "
          f"{sse_f / one:.4f})", flush=True)
    again = (torch.equal(stage.iters, res.subset_iters)
             and torch.equal(final, res.centroids))
    print(f"[main] stage-by-stage rerun identical to the entry point's run: "
          f"{again}", flush=True)

    # one step over the whole stack at its converged centroids: the shape
    # the main path's first launches have, and the times the report carries
    report.update(time_step("stack", subsets, res.intermediate.contiguous(),
                            masks.float(), reps=3))
    return (launches > 0 and np.isfinite(sse_f) and sse_f < one and again
            and tuple(res.centroids.shape) == (K, D)
            and bool(torch.isfinite(res.centroids).all()))


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

    from repro_torch.kernels import _build, fused
    t0 = time.perf_counter()
    _build.load(fused.SOURCE)
    print(f"build: {fused.SOURCE} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds.get(fused.SOURCE, 0.0):.2f} s)",
          flush=True)

    report = {"name": "fused_lloyd", "route": "cuda", "source": SOURCE,
              "replaces": REPLACES}
    if not phase_kernel(torch, report):
        return fail("kernel against its plain version")
    if not phase_small(torch):
        return fail("small-input agreement, card against CPU")
    if not phase_main(torch, report):
        return fail("main path")
    kernel = {key: report[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
