"""The k-means variants of the reference's ``launch/perf_variants.py``: trace
the dry run (``launch/kmeans_dryrun.py``) with another Lloyd engine and
print its roofline terms beside the baseline's.

    python -m repro_torch.launch.perf_variants --cell C4

Records land beside the baselines in ``experiments/dryrun_torch/`` and are
traced again only when missing (``--force``: always).  The terms are models
from the H100 data sheet (``launch/dryrun.py``), one Lloyd trip each, not
measurements: a variant's numbers say where its work goes, not that it is
faster.  The LM cells (A, B, M) wait for the LM stack.
"""
from __future__ import annotations

import argparse
import json
import math

from repro_torch.launch.dryrun import OUT_DIR

# Cell C: the paper's own technique.  Each variant swaps the Lloyd engine
# every S2 reducer runs (kernels/engine.py); the reference's "jnp" and
# "pallas" are "eager" and "twopass".
KMEANS_VARIANTS = {
    "C1": dict(backend="twopass",
               note="two kernels a Lloyd trip (the assign kernel, then the "
                    "centroid update on its labels): the points cross "
                    "device memory twice a trip, with an (L, S) label and "
                    "distance round trip between the launches"),
    "C2": dict(backend="fused",
               note="the fused kernel: one launch and one pass over the "
                    "points a trip; labels and distances stay on chip"),
    "C3": dict(backend="resident",
               note="the whole-solve kernel, one launch a subset: the "
                    "convergence loop runs on the card with no host "
                    "between trips (the points stream from device memory "
                    "or L2 every trip: 4 MB a subset is far more than an "
                    "SM's shared memory)"),
    "C4": dict(backend="batched",
               note="the whole-solve kernel over the rank's whole S2 "
                    "stack, one thread-block cluster a subset: launches "
                    "drop from M/P (C3) to one a rank"),
    "C5": dict(backend="batched", reseed_empty=True,
               baseline=dict(backend="fused", reseed_empty=True),
               note="reseed-on whole solve against the fused engine's host "
                    "loop with the host reseed: the farthest-point reseed "
                    "runs inside the kernel's loop, so the stack keeps one "
                    "launch a rank on the paper pipeline's quality "
                    "configuration"),
    "C6": dict(backend="batched", prune="bounds",
               baseline=dict(backend="batched"),
               note="bound-pruned whole solve against the exact one: a "
                    "block whose stored margin beats twice the centroid "
                    "drift reuses its labels, bit for bit the same result "
                    "(the dry run counts one score pass a lane, so its "
                    "terms cannot show a skip)"),
}

STAGES = ("kmeans-pkmeans-iter", "kmeans-ipkmeans-s2s3")


def _kmeans_variant_suffix(backend: str, reseed_empty: bool,
                           prune: str = "none") -> str:
    """The record-name suffix ``kmeans_dryrun`` writes for a (backend,
    reseed, prune) triple: the eager baseline carries no backend suffix,
    the reseed appends ``__reseed`` and pruning ``__prune`` either way."""
    suffix = "" if backend == "eager" else f"__{backend}"
    suffix += "__reseed" if reseed_empty else ""
    return suffix + ("__prune" if prune != "none" else "")


def lloyd_solve_hbm_bytes(n, d, k, iters, engine: str):
    """Device-memory bytes of a WHOLE f32 Lloyd solve of ``n`` points:
    ``resident`` reads the points and weights once and the seeds, writes the
    centroids and three scalars; the per-step engines (``twopass``,
    ``fused``) pay ``iters`` times a trip (the reference's
    ``benchmarks/kernel_bench.py`` model, copied)."""
    f32 = 4
    if engine == "resident":
        return n * d * f32 + n * f32 + 2 * k * d * f32 + 3 * f32
    small = k * d * f32 * 2 + k * f32
    if engine == "fused":
        return iters * (n * d * f32 + n * f32 + small)
    return iters * (2 * n * d * f32 + 4 * n * f32 + small)


def run_kmeans(tag: str, force: bool = False):
    """Trace the dry run with the variant's engine (and its baseline, when
    missing) and print the roofline terms of each stage, baseline against
    variant; then the variant's own model: the per-solve bytes on
    ``resident``, the launches a stack on ``batched``."""
    from repro_torch.launch import kmeans_dryrun

    v = KMEANS_VARIANTS[tag]
    backend = v["backend"]
    reseed = bool(v.get("reseed_empty"))
    prune = v.get("prune", "none")
    mesh_tag = "16x16"
    suffix = _kmeans_variant_suffix(backend, reseed, prune)

    def have(sfx):
        return all((OUT_DIR / f"{s}__{mesh_tag}{sfx}.json").exists()
                   for s in STAGES)

    if force or not have(suffix):
        kmeans_dryrun.lower_all(multi_pod=False, backend=backend,
                                reseed_empty=reseed, prune=prune)
    base = v.get("baseline", dict(backend="eager"))
    base_suffix = _kmeans_variant_suffix(base["backend"],
                                         bool(base.get("reseed_empty")),
                                         base.get("prune", "none"))
    # the eager baseline traces the S1 cells too: only --force a re-trace
    # of a variant's own baseline
    refresh = force and base["backend"] != "eager"
    if refresh or not have(base_suffix):
        kmeans_dryrun.lower_all(multi_pod=False, backend=base["backend"],
                                reseed_empty=bool(base.get("reseed_empty")),
                                prune=base.get("prune", "none"))

    print(f"[{tag}] {v['note']}")
    out = []
    for stage in STAGES:
        b = json.loads((OUT_DIR / f"{stage}__{mesh_tag}{base_suffix}.json"
                        ).read_text())
        rec = json.loads((OUT_DIR / f"{stage}__{mesh_tag}{suffix}.json"
                          ).read_text())
        print(f"  {stage}:")
        for term in ("compute_s", "memory_s", "collective_s"):
            bt, nt = b["roofline"][term], rec["roofline"][term]
            print(f"    {term:13s}: {bt:.3e} -> {nt:.3e}"
                  + (f"  ({bt / nt:.2f}x)" if nt > 0 else ""))
        out.append(rec)

    n_sub = -(-kmeans_dryrun.N // kmeans_dryrun.M)
    d, k = kmeans_dryrun.D, kmeans_dryrun.K
    if backend == "resident":
        from repro_torch.kernels.resident import (max_resident_points,
                                                  resident_feasible)
        iters = kmeans_dryrun.MAX_ITERS
        fus = lloyd_solve_hbm_bytes(n_sub, d, k, iters, "fused")
        res = lloyd_solve_hbm_bytes(n_sub, d, k, iters, "resident")
        feasible = resident_feasible(n_sub, d, k)
        print(f"  per-solve HBM model (subset n={n_sub}, d={d}, k={k}, "
              f"iters={iters}):")
        print(f"    fused   : {fus:.3e} B  ({iters} point sweeps a solve)")
        print(f"    resident: {res:.3e} B  (1 point sweep a solve, "
              f"{fus / res:.1f}x less; fits the H100's shared memory: "
              f"{feasible})")
        if not feasible:
            n_max = max_resident_points(d, k)
            m_needed = -(-kmeans_dryrun.N // max(n_max, 1))
            print(f"    -> the subset does not fit (the fused loop runs "
                  f"instead); n <= {n_max} fits at this (d, k), i.e. "
                  f"M >= {m_needed} reducers")

    if backend == "batched":
        from repro_torch.kernels.batch_resident import (batched_group_size,
                                                        smem_bytes)
        n_dev = math.prod(int(x) for x in mesh_tag.split("x"))
        m_loc = kmeans_dryrun.M // n_dev
        t = batched_group_size(m_loc, n_sub, d, k, prune=prune)
        mode = ("reseed-on " if reseed else "") + (
            "bound-pruned " if prune != "none" else "")
        print(f"  per-stack launch model ({mode}m_loc={m_loc} subsets a "
              f"rank, subset n={n_sub}, d={d}, k={k}):")
        if t:
            print(f"    group_t={t} ({smem_bytes(n_sub, k, prune)} B of "
                  f"shared memory a block): {m_loc} launches -> "
                  f"{-(-m_loc // t)}"
                  + (" (the reseed runs inside the kernel's loop: no host "
                     "fallback, no extra launches)" if reseed else ""))
            if prune != "none":
                delta = smem_bytes(n_sub, k, prune) - smem_bytes(n_sub, k)
                print(f"    bound state: +{delta} B of shared memory a "
                      f"block (a skip flag a pruning block; the labels, "
                      f"margins and drift live in device memory)")
        else:
            print("    -> one subset does not fit a block's shared memory; "
                  "the stack runs the fused loop (more reducers, smaller "
                  "subsets)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="the dry run's k-means "
                                             "variants against their "
                                             "baselines")
    ap.add_argument("--cell", required=True,
                    choices=list(KMEANS_VARIANTS) + ["all"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    tags = list(KMEANS_VARIANTS) if args.cell == "all" else [args.cell]
    for t in tags:
        run_kmeans(t, force=args.force)


if __name__ == "__main__":
    main()
