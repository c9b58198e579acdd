"""Level-synchronous k-d tree partitioning + subset labeling (paper Algs
2-3), the counterpart of the single-device ``repro.core.kdtree``.

One (region, coord) sort per level finds every region's exact median split
at once.  torch has no ``lexsort``: ``lexsort((coord, region))`` is two
stable sorts, by coord first and then by region, which gives the same order
(ties keep the original point order; -0.0 and +0.0 tie, as in the
reference's sort).  The histogram builder finds exact medians without a
sort, from radix histograms of an order-preserving integer key, under which
-0.0 sorts before +0.0 (as in the reference's histogram builder, so the two
builders part only where signed zeros straddle a median).  The random
variants take their draws as inputs (``uniforms``, ``permutation``), or
draw them from a ``torch.Generator``.  Ids and packs match the reference
exactly.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

class Partition(NamedTuple):
    subset_ids: torch.Tensor     # (n,) int32 in [0, num_subsets)
    region_ids: torch.Tensor     # (n,) int32 in [0, 2**depth) — tree leaves
    depth: int                   # tree levels == number of "MapReduce jobs"


def _lexsort(coord: torch.Tensor, region: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (region, coord), stable in the point index."""
    o1 = torch.sort(coord, stable=True).indices
    o2 = torch.sort(region[o1], stable=True).indices
    return o1[o2]


def _segment_rank(sort_primary: torch.Tensor, order: torch.Tensor,
                  num_segments: int):
    """Given a permutation ``order`` that sorts by (segment, key), return for
    each *sorted* position its rank within its segment and the segment
    size."""
    n = sort_primary.shape[0]
    sorted_seg = sort_primary[order].long()
    counts = torch.bincount(sort_primary.long(), minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=order.device) - starts[sorted_seg]
    return sorted_seg, rank, counts[sorted_seg]


def build_kdtree(points: torch.Tensor, depth: int) -> torch.Tensor:
    """Assign every point a leaf region id via ``depth`` median-split rounds.

    Axes cycle through the dimensions; the left child takes ceil(size/2)
    points.  Returns (n,) int32 region ids in [0, 2**depth).
    """
    n, d = points.shape
    region = torch.zeros(n, dtype=torch.int64, device=points.device)
    for level in range(depth):
        order = _lexsort(points[:, level % d], region)
        sorted_seg, rank, size = _segment_rank(region, order, 2 ** level)
        child = (rank >= (size + 1) // 2).long()
        new_region = torch.empty_like(region)
        new_region[order] = sorted_seg * 2 + child
        region = new_region
    return region.to(torch.int32)


def _monotone_u32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving float32 -> uint32 mapping (IEEE-754 trick), held in
    int64 in [0, 2**32): torch has no full uint32 arithmetic.  -0.0 maps
    just below +0.0."""
    b = x.to(torch.float32).contiguous().view(torch.int32).long() \
        & 0xFFFFFFFF
    return torch.where((b >> 31) == 1, b ^ 0xFFFFFFFF, b | 0x80000000)


def _histogram_median_go_right(key: torch.Tensor, idx: torch.Tensor,
                               region: torch.Tensor,
                               num_regions: int) -> torch.Tensor:
    """Exact per-region median split without sorting.

    Radix-refines the median over 8 byte rounds (4 bytes of the monotone
    key, then 4 bytes of the point index as a unique tie-break, which is
    the stable sort's order).  Each round is one integer ``scatter_add_``
    of the still-matching points into (R, 256) bins.  The left half takes
    ``(counts + 1) // 2`` points of each region.  Returns (n,) bool.
    """
    n = key.shape[0]
    dev = key.device
    counts = torch.zeros(num_regions, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, region, torch.ones_like(region))
    remaining = (counts + 1) // 2                          # ceil -> left
    match = torch.ones(n, dtype=torch.bool, device=dev)
    less = torch.zeros(n, dtype=torch.bool, device=dev)
    for r in range(8):
        src = key if r < 4 else idx
        byte = (src >> (8 * (3 - r % 4))) & 0xFF
        hist = torch.zeros(num_regions * 256, dtype=torch.int64, device=dev)
        hist.scatter_add_(0, region * 256 + byte, match.long())
        cum = torch.cumsum(hist.view(num_regions, 256), dim=1)
        # the first bin whose cumulative count reaches the remaining share
        bstar = torch.argmax((cum >= remaining[:, None]).to(torch.int32),
                             dim=1)
        below = torch.where(
            bstar > 0,
            torch.gather(cum, 1, torch.clamp(bstar - 1, min=0)[:, None])[:, 0],
            0)
        remaining = remaining - below
        b_reg = bstar[region]
        less = less | (match & (byte < b_reg))
        match = match & (byte == b_reg)
    # the unique surviving point is the median element; it joins the left
    # half iff one left slot remains
    left = less | (match & (remaining[region] > 0))
    return ~left


def build_kdtree_histogram(points: torch.Tensor, depth: int) -> torch.Tensor:
    """Sort-free k-d tree build: the reference's ``build_kdtree_histogram``
    (exact medians, ties by point index, -0.0 before +0.0) from radix
    histograms, ``depth * 8`` histogram passes instead of ``depth`` global
    sorts.  Returns (n,) int32 region ids in [0, 2**depth)."""
    n, d = points.shape
    idx = torch.arange(n, dtype=torch.int64, device=points.device)
    region = torch.zeros(n, dtype=torch.int64, device=points.device)
    for level in range(depth):
        key = _monotone_u32(points[:, level % d])
        go_right = _histogram_median_go_right(key, idx, region, 2 ** level)
        region = region * 2 + go_right.long()
    return region.to(torch.int32)


def required_depth(n: int, leaf_capacity: int) -> int:
    """Levels so leaves hold ~leaf_capacity points: round(log2(n / cap)),
    leaf in (cap/2, cap]."""
    if n <= leaf_capacity:
        return 0
    return max(0, round(math.log2(n / leaf_capacity)))


def _label_key(points: torch.Tensor, strategy: str, label_axis: int,
               uniforms, generator) -> torch.Tensor:
    """The per-point labeling key of Algorithm 3's two variants: a
    coordinate (``"axis"``), or ``(n,)`` f32 uniforms (``"random"``), given
    or drawn from ``generator``."""
    if strategy == "axis":
        return points[:, label_axis]
    if strategy != "random":
        raise ValueError(f"unknown labeling strategy: {strategy}")
    n = points.shape[0]
    if uniforms is None:
        if generator is None:
            raise ValueError("random labeling needs its uniforms, or a "
                             "torch.Generator to draw them from")
        return torch.rand((n,), generator=generator, dtype=torch.float32,
                          device=points.device)
    u = torch.as_tensor(uniforms, dtype=torch.float32, device=points.device)
    if tuple(u.shape) != (n,):
        raise ValueError(f"uniforms of shape {tuple(u.shape)}, expected "
                         f"({n},)")
    return u


def _labels_in_order(region: torch.Tensor, order: torch.Tensor,
                     num_regions: int, num_subsets: int) -> torch.Tensor:
    """Each point's rank inside its region along ``order``, mod M."""
    _, rank, _ = _segment_rank(region, order, num_regions)
    ids = torch.empty_like(region)
    ids[order] = rank % num_subsets
    return ids.to(torch.int32)


def label_regions(points: torch.Tensor, region_ids: torch.Tensor,
                  num_regions: int, num_subsets: int,
                  strategy: str = "axis", label_axis: int = 0, *,
                  uniforms=None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Paper Algorithm 3: label points inside each leaf in key order; label
    i forms subset i, and labels wrap mod ``num_subsets``.  ``strategy``:
    ``"axis"`` sorts along ``label_axis`` (variant 2, the paper's winner);
    ``"random"`` sorts by ``uniforms (n,)`` f32 (variant 1: the
    reference's ``jax.random.uniform(key, (n,))``), drawn from
    ``generator`` when not given."""
    key2 = _label_key(points, strategy, label_axis, uniforms, generator)
    region = region_ids.long()
    order = _lexsort(key2, region)
    return _labels_in_order(region, order, num_regions, num_subsets)


# Number of histogram buckets per region for the sort-free labeler (the
# radix fan-out of the tree build)
_LABEL_BUCKETS = 256


def _region_buckets(key2: torch.Tensor, region: torch.Tensor,
                    num_regions: int) -> torch.Tensor:
    """Per-point bucket id in [0, 256): the labeling key quantized against
    its region's [min, max] span, f32 ``(f - lo) / w * 256`` truncated to
    int32 and clipped, in the reference's order of operations."""
    f = key2.to(torch.float32)
    lo = torch.full((num_regions,), torch.inf, device=f.device)
    hi = torch.full((num_regions,), -torch.inf, device=f.device)
    lo.scatter_reduce_(0, region, f, "amin")
    hi.scatter_reduce_(0, region, f, "amax")
    w = hi - lo
    t = (f - lo[region]) / torch.where(w > 0, w, 1.0)[region]
    return torch.clamp((t * _LABEL_BUCKETS).to(torch.int32), 0,
                       _LABEL_BUCKETS - 1)


def label_regions_histogram(points: torch.Tensor, region_ids: torch.Tensor,
                            num_regions: int, num_subsets: int,
                            strategy: str = "axis", label_axis: int = 0, *,
                            uniforms=None,
                            generator: torch.Generator | None = None
                            ) -> torch.Tensor:
    """The sort-free labeling order: inside a region, (bucket, original
    index), where the bucket quantizes the labeling key against the
    region's span (``_region_buckets``).  The order the reference's
    distributed labeler reproduces from O(R * 256) summaries; its own
    canonical order, not the exact-key order of ``label_regions``."""
    key2 = _label_key(points, strategy, label_axis, uniforms, generator)
    region = region_ids.long()
    b = _region_buckets(key2, region, num_regions)
    order = _lexsort(b, region)
    return _labels_in_order(region, order, num_regions, num_subsets)


def random_partition(points: torch.Tensor, num_subsets: int, *,
                     permutation=None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """Variant (3): a global random partition, no k-d tree.  Point
    ``permutation[r]`` goes to subset ``r % num_subsets``, so subsets stay
    balanced.  ``permutation (n,)`` int64 is the reference's
    ``jax.random.permutation(key, n)``; drawn from ``generator`` when not
    given."""
    n = points.shape[0]
    dev = points.device
    if permutation is None:
        if generator is None:
            raise ValueError("the random partition needs its permutation, "
                             "or a torch.Generator to draw it from")
        perm = torch.randperm(n, generator=generator, device=dev)
    else:
        perm = torch.as_tensor(permutation, device=dev).long()
        if tuple(perm.shape) != (n,):
            raise ValueError(f"a permutation of shape {tuple(perm.shape)}, "
                             f"expected ({n},)")
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    ids[perm] = (torch.arange(n, device=dev) % num_subsets).to(torch.int32)
    return ids


def pack_subsets(points: torch.Tensor, subset_ids: torch.Tensor,
                 num_subsets: int, capacity: int):
    """Scatter points into a rectangular (M, capacity, d) tensor + bool mask.

    Points beyond ``capacity`` in a subset are dropped, as the reference's
    ``mode="drop"`` scatter drops them (the pipeline then raises).
    """
    n, d = points.shape
    ids = subset_ids.long()
    order = torch.sort(ids, stable=True).indices
    sorted_sub, rank, _ = _segment_rank(ids, order, num_subsets)
    keep = rank < capacity
    out = torch.zeros((num_subsets, capacity, d), dtype=points.dtype,
                      device=points.device)
    msk = torch.zeros((num_subsets, capacity), dtype=torch.bool,
                      device=points.device)
    sub, r, src = sorted_sub[keep], rank[keep], order[keep]
    out[sub, r] = points[src]
    msk[sub, r] = True
    return out, msk


def pack_subsets_sorted(points: torch.Tensor, subset_ids: torch.Tensor,
                        num_subsets: int, capacity: int):
    """Equal-size pack by one stable sort and a reshape, no scatter.

    Valid when every subset holds exactly ``capacity`` points (the k-d tree
    labeling whenever ``n == num_subsets * capacity``); the pack equals the
    scatter pack's then.
    """
    n, d = points.shape
    if n != num_subsets * capacity:
        raise ValueError(f"the sorted pack needs n == num_subsets * "
                         f"capacity, got {n} != {num_subsets} * {capacity}")
    order = torch.sort(subset_ids.long(), stable=True).indices
    packed = points[order].reshape(num_subsets, capacity, d)
    return packed, torch.ones((num_subsets, capacity), dtype=torch.bool,
                              device=points.device)


def partition_dataset(points: torch.Tensor, num_subsets: int,
                      leaf_capacity: int | None = None,
                      strategy: str = "kd_axis",
                      label_axis: int = 0,
                      builder: str = "sort",
                      labeler: str = "sort", *,
                      draws=None,
                      generator: torch.Generator | None = None) -> Partition:
    """Stage 1: tree build + labeling, or a random partition.

    ``strategy`` in {``"kd_axis"``, ``"kd_random"``, ``"random"``}: the
    paper's variants (2), (1) and (3).  ``builder``: ``"sort"`` (level-sync
    sorts) or ``"histogram"`` (the same medians, sort-free); ``labeler``:
    ``"sort"`` (exact-key order) or ``"histogram"`` (bucketed order).  The
    random variants consume ``draws``: ``(n,)`` f32 uniforms for
    ``kd_random`` (the reference's ``jax.random.uniform(key, (n,))``), an
    ``(n,)`` int64 permutation for ``random`` (its
    ``jax.random.permutation(key, n)``); without them they draw from
    ``generator``.  Single device: the reference's ``mesh`` branch comes
    with the distributed slice.
    """
    if strategy not in ("kd_axis", "kd_random", "random"):
        raise ValueError(f"unknown partition strategy: {strategy!r}")
    for what, v in (("builder", builder), ("labeler", labeler)):
        if v not in ("sort", "histogram"):
            raise ValueError(f"unknown {what}: {v!r} (expected 'sort' | "
                             f"'histogram')")
    n = points.shape[0]
    if strategy == "random":
        ids = random_partition(points, num_subsets, permutation=draws,
                               generator=generator)
        return Partition(subset_ids=ids,
                         region_ids=torch.zeros(n, dtype=torch.int32,
                                                device=points.device),
                         depth=0)
    cap = num_subsets if leaf_capacity is None else leaf_capacity
    depth = required_depth(n, cap)
    build = build_kdtree_histogram if builder == "histogram" else build_kdtree
    region = build(points, depth)
    label = (label_regions_histogram if labeler == "histogram"
             else label_regions)
    ids = label(points, region, 2 ** depth, num_subsets,
                strategy="axis" if strategy == "kd_axis" else "random",
                label_axis=label_axis, uniforms=draws, generator=generator)
    return Partition(subset_ids=ids, region_ids=region, depth=depth)
