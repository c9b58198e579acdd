"""A whole stack of Lloyd solves in one kernel launch, the counterpart of
``repro.kernels.batch_resident``.

The TPU kernel's grid walks groups of T subsets, each group running its
convergence loop in VMEM.  On the card the kernel in ``csrc/
lloyd_solve.cu`` gives each lane (subset) one thread-block cluster of R
blocks on R neighbouring SMs, which runs that lane's whole solve: score
pass, segment-sum, ``divide_or_keep``, the farthest-point reseed of empty
clusters (``reseed_empty``), the stop test, and after the loop one scoring
pass for the SSE.  Each block of a cluster scores its own whole 128-row
tiles and owns a share of the clusters; the blocks meet at cluster
barriers and exchange their label histograms, movements and reseed
candidates through distributed shared memory, so the result has the same
bits at every R.  A lane that converges leaves its loop; the others go on.
Per-lane skipping under ``prune="bounds"`` is the reference's behaviour at
``group_t=1``.

``group_t`` (the reference's subsets per grid step, ``KernelSpec.group_t``)
is the lanes of one launch here: a stack of M lanes runs as ceil(M / t)
launches of lanes [i t, (i + 1) t), in lane order, each with its own
:func:`cluster_plan`.  A lane's solve reads no other lane, so every t gives
the one-launch result bit for bit; ``None`` is one launch.  A lane's shared
memory does not grow with the group (each lane is its own cluster of
blocks), so every group fits where one lane does
(:func:`batched_group_size`).

R is not a parameter of the solve: :func:`cluster_plan` picks it from the
stack's size and what the card reports, and ``solve_stack(...,
cluster=R)`` forces it (the card's tests and ``chip_smoke.py`` do, to hold
every R against R = 1).

The seeds are one ``(k, d)`` block every lane starts from, or ``(M, k,
d)``, one block a lane (the kernel reads lane ``g``'s at ``c0 + g * k * d``;
the shared block is the stride 0): a lane's result is the same bits either
way, given the same seeds.

On a CUDA tensor :func:`lloyd_solve_batched` launches the kernel (built at
first use) or raises; on a CPU tensor it runs :func:`lloyd_solve_plain`,
the same function in plain PyTorch.  Nothing is padded: the kernel masks the
ragged edges itself.

Subsets and seeds may be float32 or bfloat16.  The carry dtype is the
seeds': with bfloat16 seeds every divided centroid and every reseed pick is
rounded to bfloat16 before the shift is taken (the kernel's ``CARRY_BF16``
instantiation; the plain version the same), as the reference's kernels
round each trip's centroids through the carry dtype, and the centroids come
back in it.  The points are widened to float32 once, exactly.
"""
from __future__ import annotations

import ctypes
import functools
import math
from fractions import Fraction
from typing import NamedTuple

import torch

from repro_torch.device import FLOAT_DTYPES
from repro_torch.kernels import ref, specs
from repro_torch.kernels import work as work_
from repro_torch.kernels.resident import bound_block_rows, check_prune

# Kernel launches since the last reset; only the CUDA path counts.
launches = 0

SOURCE = "lloyd_solve.cu"
# shared memory of one block: the two buffers of each of its two scoring
# groups, each a 128-row point tile and a 128-row centroid tile of a
# 16-wide feature chunk (2 x 16 x 132 f32), which the counting sort's
# start and cursor reuse between score passes; and the static part, the
# 256-float reduction buffer and a few scalars
_SMEM_TILES = 2 * 2 * 2 * 16 * 132 * 4
_SMEM_STATIC = 256 * 4 + 256
# rows of a score tile: a block of a cluster owns whole tiles
TILE_ROWS = 128
# the cluster sizes the rule chooses from: up to CUDA's portable limit of 8,
# and 16 where the card allows a non-portable size; the kernel takes up to
# MAX_CLUSTER
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_CLUSTER = 16


class SolveOut(NamedTuple):
    centroids: torch.Tensor   # (M, k, d) f32
    sse: torch.Tensor         # (M,) f32
    iters: torch.Tensor       # (M,) i32
    converged: torch.Tensor   # (M,) bool
    skips: torch.Tensor       # (max(max_iters, 1), 2) i32, summed over lanes
    passes: torch.Tensor      # (M,) i32 score passes run per lane


def _bound_blocks(s: int, prune: str, bound_block: int | None):
    """(rows per pruning block, blocks per lane), (0, 0) without pruning."""
    if prune != "bounds":
        return 0, 0
    s_pad = -(-s // 8) * 8
    bb = bound_block_rows(s_pad, bound_block)
    return bb, s_pad // bb


def smem_bytes(s: int, k: int, prune: str = "none",
               bound_block: int | None = None) -> int:
    """Shared memory one block of the kernel needs: the static part; the
    score tiles or the counting sort's start and cursor (2k + 1 words),
    whichever is larger; the norms or the histogram (k words); and one
    skip flag per pruning block."""
    _, nb = _bound_blocks(s, prune, bound_block)
    return _SMEM_STATIC + max(_SMEM_TILES, (2 * k + 1) * 4) + (k + nb) * 4


def rank_unit(bb: int) -> int:
    """Rows of the unit a lane is split in among the blocks of its cluster:
    whole score tiles, and whole pruning blocks of ``bb`` rows (0: none)."""
    return TILE_ROWS if bb == 0 else math.lcm(TILE_ROWS, bb)


def cluster_rows(s: int, unit: int, r: int) -> list[int]:
    """How a lane of ``s`` rows is split among the ``r`` blocks of its
    cluster, in whole units of ``unit`` rows, as even as the units allow:
    block ``i`` owns rows [rows[i], rows[i + 1]) of the returned ``r + 1``
    boundaries.  The kernel takes these boundaries as they are."""
    nu = -(-s // unit)
    return [min(nu * i // r * unit, s) for i in range(r + 1)]


def cluster_size(m: int, s: int, bb: int, *, clusters: dict[int, int]) -> int:
    """The rule for R, the blocks of a lane's cluster, from ``clusters``:
    for each size, how many clusters the card holds at once (0: refused).
    Lanes run in waves of ``clusters[R]`` lanes, and a lane's solve takes
    about 1/R of its time on one block, so a stack of ``m`` lanes takes
    about ceil(m / clusters[R]) / R one-block solves.  R minimises that
    among the sizes the card takes with no block left without rows (R at
    most the lane's units, :func:`rank_unit`).  A tie goes to the larger R:
    when lanes take unequal numbers of trips its last wave is shorter, and
    its lanes in flight hold fewer centroids in L2.  A lone lane gets the
    largest R the card takes."""
    units = -(-s // rank_unit(bb))
    best, best_cost = 1, None
    for r in sorted(clusters):
        if clusters[r] < 1 or r > units:
            continue
        cost = Fraction(-(-max(m, 1) // clusters[r]), r)
        if best_cost is None or cost <= best_cost:
            best, best_cost = r, cost
    return best


class ClusterPlan(NamedTuple):
    r: int                 # blocks of a lane's cluster
    unit: int              # rows a block's range is made of
    rows: list             # the r + 1 row boundaries (cluster_rows)
    clusters: int          # clusters of r blocks the card holds at once
    fits: dict             # clusters the card holds at once, per size


def work(lanes: int, s: int, d: int, k: int, passes: int,
         skipped_rows: int = 0, max_iters: int = 1,
         per_lane_seeds: bool = False) -> work_.Work:
    """One launch of the whole-solve kernel over ``lanes`` lanes of ``s``
    rows: 2 k d f32 operations for each row of each score pass it ran
    (``passes`` summed over the lanes: trips, reseed passes and final
    passes), less the ``skipped_rows`` of pruned blocks; the points,
    weights and seeds (one ``(k, d)`` block, or one a lane) read once, the
    centroids, SSE, iterations, convergence flags and the ``(max_iters,
    2)`` skip counters written once."""
    seeds = (lanes if per_lane_seeds else 1) * k * d
    return work_.Work(2.0 * k * d * (s * passes - skipped_rows),
                      work_.F32 * (lanes * (s * d + s + k * d + 3) + seeds
                                   + 2 * max(max_iters, 1)))


def batched_feasible(s: int, d: int, k: int, prune: str = "none",
                     bound_block: int | None = None, device=None) -> bool:
    """Does a lane of ``s`` points against ``k`` centroids fit one block's
    shared memory on ``device`` (``specs.get_profile``: the card's, or the
    H100's for the CPU)?  ``d`` does not enter: the score pass walks it in
    chunks."""
    del d
    return specs.get_profile(device).fits(smem_bytes(s, k, prune,
                                                     bound_block))


def batched_group_size(m: int, s: int, d: int, k: int, prune: str = "none",
                       device=None, *, budget: int | None = None) -> int:
    """The most lanes one launch takes of an (m, s, d, k) stack: ``m`` when
    one lane fits a block's shared memory (:func:`batched_feasible`; the
    budget is ``device``'s profile, or ``budget`` bytes), else 0 (the
    engines' fused fallback).  Unlike the reference's VMEM groups, a lane's
    shared memory here does not grow with the group: each lane is its own
    cluster of blocks, so a group of any size fits where one lane does."""
    del d
    if budget is None:
        budget = specs.get_profile(device).smem_per_block
    return m if smem_bytes(s, k, prune) <= budget else 0


def lane_groups(m: int, group_t: int | None) -> list[tuple[int, int]]:
    """The launches of an ``m``-lane stack at ``group_t`` lanes a launch:
    ``[(lo, hi), ...]``, lanes [lo, hi) each, in lane order (``None``: one
    launch of all of them)."""
    if group_t is not None and (isinstance(group_t, bool)
                                or not isinstance(group_t, int)
                                or group_t < 1):
        raise ValueError(f"group_t={group_t!r}: group sizes must be ints "
                         f">= 1 (or None for one launch)")
    t = m if group_t is None else min(group_t, m)
    if t >= m:
        return [(0, m)]
    return [(lo, min(lo + t, m)) for lo in range(0, m, t)]


def _scores(x, x2, c):
    """Per-lane scores ``||c||^2 - 2 x.c`` (L,S,k) and min distances."""
    cn = torch.sum(c * c, dim=-1)
    sc = cn.unsqueeze(1) - 2.0 * (x @ c.transpose(1, 2))
    best, labels = torch.min(sc, dim=-1)
    return sc, labels, best, torch.clamp(best + x2, min=0.0)


def _solve_plain_chunk(x, c0, w, *, max_iters, tol, reseed_empty, bb, nb,
                       skips, carry):
    """One chunk of lanes.  Every trip computes every lane of the chunk and
    keeps the results of the active ones (the reference kernel's
    ``where(active, ...)``), so each matrix product has the same batch shape
    on every trip and rounds a lane's sums the same way whichever lanes are
    still active.  The divided centroids and the reseed picks round-trip
    the ``carry`` dtype."""
    from repro_torch.core.metrics import centroid_shift
    m, s, _ = x.shape
    k = c0.shape[-2]
    kk = min(k, s)
    dev = x.device
    x2 = torch.sum(x * x, dim=-1)
    c = c0.expand(m, k, c0.shape[-1]).clone()
    it = torch.zeros(m, dtype=torch.int32, device=dev)
    passes = torch.zeros(m, dtype=torch.int32, device=dev)
    shift = torch.full((m,), torch.inf, dtype=torch.float32, device=dev)
    if nb:
        idx = torch.zeros((m, s), dtype=torch.int64, device=dev)
        margin = torch.full((m, nb), -torch.inf, device=dev)
        dacc = torch.zeros((m, nb), device=dev)
    trip = 0
    while True:
        active = (it < max_iters) & (shift > tol)
        if not bool(torch.any(active)):
            break
        act = active.unsqueeze(-1)
        sc, lab, best, _ = _scores(x, x2, c)
        if nb:
            # the pruned body: skipped blocks keep their cached labels and
            # margins, scored ones take this pass's
            skip_b = ref.bounds_may_skip(margin, dacc)
            gap = ref.bound_gap(best + x2, ref.bound_second_best(sc, lab) + x2,
                                w > 0.0)
            gap = torch.nn.functional.pad(gap, (0, nb * bb - s),
                                          value=torch.inf)
            fresh = torch.amin(gap.view(m, nb, bb), dim=-1)
            skip_rows = skip_b.repeat_interleave(bb, dim=-1)[:, :s]
            lab = torch.where(skip_rows, idx, lab)
            idx = torch.where(act, lab, idx)
            margin = torch.where(act & ~skip_b, fresh, margin)
        sums, counts = ref.centroid_update_ref(x, lab, w, k)
        new_c = ref.divide_or_keep(sums, counts, c).to(carry).float()
        if reseed_empty:
            empty = counts <= 0.0
            fire = torch.any(empty, dim=1) & active
            if bool(torch.any(fire)):
                _, _, _, mind = _scores(x, x2, new_c)
                score = torch.where(w > 0.0, mind, -torch.inf)
                take, picks = ref.reseed_farthest(x, score, empty, kk)
                new_c = torch.where(take.unsqueeze(-1),
                                    picks.to(carry).float(), new_c)
                passes += fire.to(torch.int32)
        new_shift = centroid_shift(new_c, c)
        if nb:
            dacc = torch.where(act, torch.where(
                skip_b, dacc + new_shift[:, None], new_shift[:, None]), dacc)
            skips[trip, 0] += int(torch.sum(skip_b & act))
            skips[trip, 1] += nb * int(torch.sum(active))
        c = torch.where(act.unsqueeze(-1), new_c, c)
        shift = torch.where(active, new_shift, shift)
        it += active.to(torch.int32)
        passes += active.to(torch.int32)
        trip += 1
    _, _, _, mind = _scores(x, x2, c)
    return c, torch.sum(w * mind, dim=-1), it, shift <= tol, passes + 1


def lloyd_solve_plain(subsets, centroids, weights=None, *,
                      max_iters: int = 300, tol: float = 1e-6,
                      reseed_empty: bool = False, prune: str = "none",
                      bound_block: int | None = None) -> SolveOut:
    """The kernel's function in plain PyTorch: a lane-vectorised loop while
    any lane is active, mirroring the reference kernel's bodies (exact or
    pruned trip, in-loop reseed, final scoring pass) with per-lane block
    skipping; a lane that stops keeps its state.  Scores are ``||c||^2 -
    2 x.c`` as in the kernel, lowest index on ties.  The pruned trip
    computes every score and selects the cached labels of skipped blocks,
    which gives the skipping kernel's result.  The centroids come back in
    the seeds' dtype, the carry dtype of every trip."""
    check_prune(prune)
    m, s, _ = subsets.shape
    k = centroids.shape[-2]
    bb, nb = _bound_blocks(s, prune, bound_block)
    x = subsets.float()
    c0 = centroids.float()
    w = (torch.ones((m, s), device=x.device) if weights is None
         else weights.float())
    skips = torch.zeros((max(int(max_iters), 1), 2), dtype=torch.int32,
                        device=x.device)
    step = max(1, ref.PLAIN_SCORE_ELEMS // max(1, s * k))
    carry = centroids.dtype
    # per-lane seeds are cut with their lanes
    parts = [_solve_plain_chunk(x[lo:lo + step],
                                c0 if c0.dim() == 2 else c0[lo:lo + step],
                                w[lo:lo + step],
                                max_iters=max_iters, tol=tol,
                                reseed_empty=reseed_empty, bb=bb, nb=nb,
                                skips=skips, carry=carry)
             for lo in range(0, m, step)]
    if not parts:
        dev = x.device
        return SolveOut(torch.empty((0, k, x.shape[2]), dtype=carry,
                                    device=dev), x.new_empty((0,)),
                        torch.empty(0, dtype=torch.int32, device=dev),
                        torch.empty(0, dtype=torch.bool, device=dev), skips,
                        torch.empty(0, dtype=torch.int32, device=dev))
    c, sse, it, conv, passes = (torch.cat(p) for p in zip(*parts))
    return SolveOut(c.to(carry), sse, it, conv, skips, passes)


_fn = None
_clusters_fn = None


def _kernel():
    global _fn, _clusters_fn
    if _fn is None:
        from repro_torch.kernels import _build
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.lloyd_solve
        fn.argtypes = ([p, p, ctypes.c_longlong, p, i, i, i, i, i,
                        ctypes.c_float]
                       + [i] * 4 + [p, i] + [p] * 15)
        fn.restype = ctypes.c_int
        cl = lib.lloyd_solve_clusters
        cl.argtypes = [i] * 5 + [p]
        cl.restype = ctypes.c_int
        _fn, _clusters_fn = fn, cl
    return _fn


@functools.lru_cache(maxsize=None)
def _card_clusters(device: int, k: int, nb: int, bounds: bool, bf16: bool,
                   r: int) -> tuple[int, int]:
    """(CUDA error, clusters of ``r`` blocks the card holds at once) for
    this kernel's configuration on card ``device``."""
    _kernel()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _clusters_fn(k, nb, int(bounds), int(bf16), r,
                           ctypes.addressof(n))
    return err, n.value


def cluster_plan(m: int, s: int, k: int, prune: str = "none",
                 bound_block: int | None = None, *, device=None,
                 cluster: int | None = None,
                 bf16: bool = False) -> ClusterPlan:
    """R for a stack of ``m`` lanes of ``s`` points against ``k`` centroids
    on a card (:func:`cluster_size` on what the card reports), or the forced
    ``cluster``; ``bf16``: the kernel's bfloat16-carry instantiation.
    Raises when the card refuses the cluster shape; it never falls back to
    a smaller R."""
    bb, nb = _bound_blocks(s, prune, bound_block)
    dev = torch.device("cuda" if device is None else device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index

    def query(r):
        return _card_clusters(idx, k, nb, bb > 0, bf16, r)

    answers = {r: query(r) for r in CLUSTER_SIZES}
    fits = {r: 0 if err else n for r, (err, n) in answers.items()}
    if fits[1] < 1:
        raise RuntimeError(f"the card holds no block of the whole-solve "
                           f"kernel (k={k}, CUDA error {answers[1][0]})")
    if cluster is None:
        r = cluster_size(m, s, bb, clusters=fits)
    else:
        r = int(cluster)
        if not 1 <= r <= MAX_CLUSTER:
            raise ValueError(f"a cluster of {r} blocks: the kernel takes "
                             f"1 to {MAX_CLUSTER}")
    err, n = query(r)
    if err or n < 1:
        raise RuntimeError(f"the card refuses clusters of {r} blocks of the "
                           f"whole-solve kernel (k={k}, CUDA error {err}, "
                           f"{n} clusters fit)")
    unit = rank_unit(bb)
    return ClusterPlan(r, unit, cluster_rows(s, unit, r), n, fits)


def _launch(x, c0, w, *, max_iters, tol, reseed_empty, prune, bound_block,
            count_as, cluster, shape_only=False) -> SolveOut:
    global launches
    m, s, d = x.shape
    k = c0.shape[-2]
    # lane g's seeds at c0 + g * stride: 0 shares one (k, d) block
    stride = k * d if c0.dim() == 3 else 0
    dev = x.device
    if not all(t.is_contiguous() for t in (x, c0, w)):
        raise ValueError("the whole-solve kernel takes contiguous tensors")
    bb, nb = _bound_blocks(s, prune, bound_block)
    carry_bf16 = c0.dtype == torch.bfloat16
    x, c0, w = x.float(), c0.float(), w.float()

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    c, sse, iters, conv, passes = f32(m, k, d), f32(m), i32(m), i32(m), i32(m)
    skips = torch.zeros((max(int(max_iters), 1), 2), dtype=torch.int32,
                        device=dev)
    carry = torch.bfloat16 if carry_bf16 else torch.float32
    if m == 0:
        return SolveOut(c.to(carry), sse, iters, conv.bool(), skips, passes)
    # per-lane workspace, in device memory: labels, distances, the sort
    # order, the (k, d) sums and (k,) counts, and the bound state
    labels, mind, order = i32(m, s), f32(m, s), i32(m, s)
    sums, counts = f32(m, k, d), f32(m, k)
    gap = f32(m, s) if nb else None
    margin = f32(m, nb) if nb else None
    dacc = f32(m, nb) if nb else None

    if shape_only:
        # the dry run counts one score pass a lane (the reference's cost
        # analysis counts a loop's body once)
        work_.record(f"lloyd_solve_{count_as}", work(
            m, s, d, k, m, max_iters=max_iters, per_lane_seeds=bool(stride)))
        return SolveOut(c.to(carry), sse, iters, conv.bool(), skips, passes)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _kernel()
    plan = cluster_plan(m, s, k, prune, bound_block, device=dev,
                        cluster=cluster, bf16=carry_bf16)
    rows = (ctypes.c_int * len(plan.rows))(*plan.rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(x), ptr(c0), stride, ptr(w), m, s, d, k,
                 int(max_iters), float(tol), int(bool(reseed_empty)), bb, nb,
                 int(carry_bf16), ctypes.addressof(rows), plan.r,
                 ptr(c), ptr(labels), ptr(mind), ptr(gap), ptr(order),
                 ptr(sums), ptr(counts), ptr(margin), ptr(dacc), ptr(sse),
                 ptr(iters), ptr(conv), ptr(passes), ptr(skips), stream)
    if err != 0:
        raise RuntimeError(f"lloyd_solve kernel launch failed with CUDA "
                           f"error {err}")
    if count_as == "resident":
        from repro_torch.kernels import resident
        resident.launches += 1
    else:
        launches += 1
    return SolveOut(c.to(carry), sse, iters, conv.bool(), skips, passes)


def _check(x, c0, w):
    if x.dim() != 3 or c0.dim() not in (2, 3):
        raise ValueError(f"expected subsets (M,S,d) and centroids (k,d) or "
                         f"(M,k,d), got {tuple(x.shape)} and "
                         f"{tuple(c0.shape)}")
    m, s, d = x.shape
    if (c0.shape[-1] != d or c0.shape[-2] < 1
            or (c0.dim() == 3 and c0.shape[0] != m)):
        raise ValueError(f"centroids {tuple(c0.shape)} do not fit subsets "
                         f"{tuple(x.shape)}")
    if w is not None and tuple(w.shape) != (m, s):
        raise ValueError(f"weights {tuple(w.shape)} do not fit subsets "
                         f"{tuple(x.shape)}")
    tensors = [x, c0] + ([] if w is None else [w])
    if any(t.device != x.device for t in tensors):
        raise ValueError("subsets, centroids and weights must share one "
                         "device")
    if any(t.dtype not in FLOAT_DTYPES for t in tensors):
        raise TypeError("the whole-solve kernel takes float32 or bfloat16 "
                        "subsets, centroids and weights")


def solve_stack(subsets, centroids, weights=None, *, max_iters: int = 300,
                tol: float = 1e-6, reseed_empty: bool = False,
                prune: str = "none", bound_block: int | None = None,
                count_as: str = "batched",
                cluster: int | None = None, group_t: int | None = None,
                spec: specs.KernelSpec | None = None) -> SolveOut:
    """The kernel's function on a stack, from shared ``(k,d)`` or per-lane
    ``(M,k,d)`` seeds: the plain version for a CPU tensor, the kernel for a
    CUDA tensor (which raises when it cannot build or launch).  Both
    refuse a ``k`` beyond one block's shared memory.  A launch adds one to
    the counter of the wrapper named by ``count_as``: this module's
    ``launches`` (``"batched"``) or ``resident.launches`` (``"resident"``);
    an empty stack launches nothing.  ``cluster`` forces the blocks a
    lane's cluster has (default: :func:`cluster_plan`'s rule);
    it changes no bit of the result.  ``group_t`` (default: ``spec``'s,
    else ``None``) runs the stack as :func:`lane_groups`' launches, each
    with its seeds and weights cut with its lanes; ``skips`` is summed over
    them.  It changes no bit of the result either.  A fake or meta tensor
    takes the shape-only route (``kernels/work.py``): the kernel's outputs
    and workspaces, one score pass a lane counted, nothing launched."""
    check_prune(prune)
    _check(subsets, centroids, weights)
    if spec is not None:
        spec = specs.coerce(spec)
        if group_t is None:
            group_t = spec.group_t
    groups = lane_groups(subsets.shape[0], group_t)
    if len(groups) > 1:
        per_lane = centroids.dim() == 3
        parts = [solve_stack(
            subsets[lo:hi], centroids[lo:hi] if per_lane else centroids,
            None if weights is None else weights[lo:hi],
            max_iters=max_iters, tol=tol, reseed_empty=reseed_empty,
            prune=prune, bound_block=bound_block, count_as=count_as,
            cluster=cluster) for lo, hi in groups]
        return SolveOut(*(torch.cat(f) for f in zip(*(p[:4] for p in parts))),
                        torch.stack([p.skips for p in parts]).sum(0).to(
                            torch.int32),
                        torch.cat([p.passes for p in parts]))
    s, k = subsets.shape[1], centroids.shape[-2]
    if not batched_feasible(s, subsets.shape[2], k, prune, bound_block,
                            subsets.device):
        raise ValueError(f"k={k} clusters (S={s}, prune={prune!r}) exceed "
                         f"the whole-solve kernel's shared-memory budget: "
                         f"{smem_bytes(s, k, prune, bound_block)} > "
                         f"{specs.get_profile(subsets.device).smem_per_block}"
                         f" bytes a block (the fused engine takes a larger "
                         f"k)")
    kw = dict(max_iters=max_iters, tol=tol, reseed_empty=reseed_empty,
              prune=prune, bound_block=bound_block)
    shape_only = work_.is_fake(subsets)
    if not shape_only:
        if subsets.device.type == "cpu":
            return lloyd_solve_plain(subsets, centroids, weights, **kw)
        if subsets.device.type != "cuda":
            if not subsets.is_meta:
                raise ValueError(f"the whole-solve kernel runs on cuda or "
                                 f"cpu, not {subsets.device.type}")
            shape_only = True
    if weights is None:
        weights = torch.ones(subsets.shape[:2], dtype=torch.float32,
                             device=subsets.device)
    return _launch(subsets, centroids.contiguous(), weights,
                   count_as=count_as, cluster=cluster, shape_only=shape_only,
                   **kw)


def lloyd_solve_batched(subsets, centroids, weights=None, *,
                        group_t: int | None = None,
                        max_iters: int = 300, tol: float = 1e-6,
                        spec: specs.KernelSpec | None = None,
                        reseed_empty: bool = False, prune: str = "none",
                        bound_block: int | None = None,
                        return_skips: bool = False):
    """A whole stack of Lloyd solves in one launch: ``subsets (M,S,d)``,
    the seeds ``centroids``, shared ``(k,d)`` or one block a lane
    ``(M,k,d)``, ``weights (M,S)`` or ``None`` ->
    (centroids (M,k,d) in the seeds' dtype, sse (M,) f32, iters (M,) i32,
    converged (M,) bool[, skips (max_iters,2) i32]).

    ``group_t`` lanes a launch (default: ``spec.group_t``, else the whole
    stack) runs ceil(M / group_t) launches with the same result bit for
    bit.  Every lane is bit-for-bit the one-lane solve of
    :func:`repro_torch.kernels.resident.lloyd_solve_resident` from its own
    seeds.  ``skips`` holds [lane-blocks skipped, lane-blocks live] per
    iteration, summed over lanes (zeros for ``prune="none"``).
    """
    out = solve_stack(subsets, centroids, weights, max_iters=max_iters,
                      tol=tol, reseed_empty=reseed_empty, prune=prune,
                      bound_block=bound_block, group_t=group_t, spec=spec)
    return tuple(out[:5] if return_skips else out[:4])
