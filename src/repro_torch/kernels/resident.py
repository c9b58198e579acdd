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
# the most rows of a lane the whole-solve kernel indexes: its row indices
# are 32-bit, and a tile's rows reach S rounded up to 128 plus 128
MAX_LANE_ROWS = 2 ** 31 - 256

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
                      bound_block: int | None = None, device=None) -> bool:
    """Does a solve of ``n`` points against ``k`` centroids fit the
    kernel's shared-memory budget on ``device`` (``specs.get_profile``)?
    (Not a TPU VMEM model: the points and the (k, d) accumulators live in
    device memory here; what must fit a block is the score tiles and the
    per-cluster sort state.)"""
    from repro_torch.kernels import batch_resident
    return batch_resident.batched_feasible(n, d, k, prune=prune,
                                           bound_block=bound_block,
                                           device=device)


def resident_smem_bytes(n: int, d: int, k: int,
                        prune: str = "none") -> int:
    """Shared memory one block of the whole-solve kernel needs for a solve
    of ``n`` points against ``k`` centroids (``batch_resident.smem_bytes``:
    the score tiles or the counting sort's state, the norms or the
    histogram, and under ``prune="bounds"`` one skip flag per pruning
    block), the counterpart of the reference's ``resident_vmem_bytes``.
    ``d`` does not enter: the score pass walks it in chunks, and the points
    and the (k, d) sums live in device memory."""
    from repro_torch.kernels import batch_resident
    del d
    return batch_resident.smem_bytes(n, k, check_prune(prune))


def max_resident_points(d: int, k: int, prune: str = "none", device=None,
                        *, budget: int | None = None) -> int:
    """The largest subset size ``n`` such that a whole solve of every
    ``n' <= n`` points against ``k`` centroids fits one block's shared
    memory (``budget`` bytes, else ``device``'s profile), 0 when none does:
    the counterpart of the reference's S2 sizing knob.  With
    ``prune="none"`` ``n`` does not enter the kernel's shared memory, so
    the answer is ``MAX_LANE_ROWS``, the most rows the kernel indexes (32-bit
    row indices), or 0.  With ``prune="bounds"`` each pruning block takes a
    flag; the blocks are priced at their smallest, 8 rows (for example a
    multiple of 8 whose eighth is prime), so that every smaller subset fits
    too."""
    from repro_torch.kernels import batch_resident, specs
    check_prune(prune)
    del d
    if budget is None:
        budget = specs.get_profile(device).smem_per_block
    room = budget - batch_resident.smem_bytes(0, k)
    if room < 0:
        return 0
    if prune == "none":
        return MAX_LANE_ROWS
    return min(MAX_LANE_ROWS, 8 * (room // 4))


def lloyd_solve_resident(points, centroids, weights=None, *,
                         max_iters: int = 300, tol: float = 1e-6,
                         reseed_empty: bool = False, prune: str = "none",
                         bound_block: int | None = None,
                         return_skips: bool = False):
    """Full Lloyd solve in one launch: ``points (n,d)``, ``centroids
    (k,d)``, ``weights (n,)`` or ``None`` -> (centroids (k,d) in the seeds'
    dtype, sse () f32, iters () i32, converged () bool[, skips
    (max_iters,2) i32]).

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
