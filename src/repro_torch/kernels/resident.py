"""One whole Lloyd solve in one kernel launch, the counterpart of
``repro.kernels.resident``.

The TPU kernel keeps a subset's points, centroids and accumulators in VMEM
and runs the convergence loop on the chip.  Here the same per-lane function
is the whole-solve CUDA kernel of ``batch_resident`` (``csrc/
lloyd_solve.cu``) launched with one lane: one thread-block cluster of up to
16 blocks on as many SMs (the largest the card takes;
``batch_resident.cluster_plan``) runs the whole loop on the card, each block
scoring its own share of the rows and summing its own share of the
clusters.  The points stream from device memory or L2 on every trip,
because one subset (4 MB at S = 16384, d = 64) is far larger than shared
memory.

``prune="bounds"`` turns on bound-gated block skipping: blocks of
``bound_block`` rows whose stored reassignment margin beats twice the
centroid drift since they were last scored reuse their cached labels.  The
segment-sum over all labels is the same code either way, so the result is
bit-for-bit the exact solve's.
"""
from __future__ import annotations

DEFAULT_BOUND_BLOCK = 256   # target point-block rows for bound-gated pruning

# Kernel launches since the last reset; only the CUDA path counts.
launches = 0


def bound_block_rows(n_pad: int, bound_block: int | None = None) -> int:
    """Pruning block size for an ``n_pad``-row subset (``n_pad`` a multiple
    of 8): the largest multiple-of-8 divisor of ``n_pad`` that is at most
    ``bound_block`` (at least 8).  The same rule as the reference's, so
    block boundaries and skip counters match it."""
    if bound_block is None:
        bound_block = DEFAULT_BOUND_BLOCK
    q = n_pad // 8
    best = 8
    for f in range(1, q + 1):
        if q % f == 0 and 8 * f <= bound_block:
            best = 8 * f
    return best


def check_prune(prune: str) -> str:
    """Validate a ``prune`` mode (every layer that takes one calls this);
    returns it."""
    if prune not in ("none", "bounds"):
        raise ValueError(
            f"unknown prune mode {prune!r} (expected 'none' or 'bounds')")
    return prune


def resident_feasible(n: int, d: int, k: int, prune: str = "none",
                      bound_block: int | None = None) -> bool:
    """Does a solve of ``n`` points against ``k`` centroids fit the
    kernel's shared-memory budget?  (Not a TPU VMEM model: the points and
    the (k, d) accumulators live in device memory here; what must fit a
    block is the score tiles and the per-cluster sort state.)"""
    from repro_torch.kernels import batch_resident
    return batch_resident.batched_feasible(n, d, k, prune=prune,
                                           bound_block=bound_block)


def lloyd_solve_resident(points, centroids, weights=None, *,
                         max_iters: int = 300, tol: float = 1e-6,
                         reseed_empty: bool = False, prune: str = "none",
                         bound_block: int | None = None,
                         return_skips: bool = False):
    """Full Lloyd solve in one launch: ``points (n,d)``, ``centroids
    (k,d)``, ``weights (n,)`` or ``None`` -> (centroids (k,d) f32, sse (),
    iters () i32, converged () bool[, skips (max_iters,2) i32]).

    Semantics of the reference's resident solve: iterate while ``iters <
    max_iters and shift > tol`` with keep-old handling of empty clusters
    (and, with ``reseed_empty``, the farthest-point reseed inside the loop),
    then score the final centroids.  ``skips`` holds [blocks skipped, blocks
    total] per iteration (zeros for ``prune="none"``).  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel with one lane, and
    a build or launch failure raises.
    """
    from repro_torch.kernels import batch_resident
    out = batch_resident.solve_stack(
        points.unsqueeze(0), centroids,
        None if weights is None else weights.unsqueeze(0),
        max_iters=max_iters, tol=tol, reseed_empty=reseed_empty, prune=prune,
        bound_block=bound_block, count_as="resident")
    res = [out.centroids[0], out.sse[0], out.iters[0], out.converged[0]]
    if return_skips:
        res.append(out.skips)
    return tuple(res)
