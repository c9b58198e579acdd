"""Level-synchronous k-d tree partitioning + subset labeling (paper Algs
2-3), the counterpart of ``repro.core.kdtree`` for the ``kd_axis`` strategy
with the sort builder and labeler.

One (region, coord) sort per level finds every region's exact median split
at once.  torch has no ``lexsort``: ``lexsort((coord, region))`` is two
stable sorts, by coord first and then by region, which gives the same order
(ties keep the original point order; -0.0 and +0.0 tie, as in the
reference's sort).  Ids and packs match the reference exactly.
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


def required_depth(n: int, leaf_capacity: int) -> int:
    """Levels so leaves hold ~leaf_capacity points: round(log2(n / cap)),
    leaf in (cap/2, cap]."""
    if n <= leaf_capacity:
        return 0
    return max(0, round(math.log2(n / leaf_capacity)))


def label_regions(points: torch.Tensor, region_ids: torch.Tensor,
                  num_regions: int, num_subsets: int,
                  strategy: str = "axis", label_axis: int = 0) -> torch.Tensor:
    """Paper Algorithm 3, variant (2): sort along ``label_axis`` inside each
    leaf and label left-to-right; labels wrap mod ``num_subsets``."""
    if strategy != "axis":
        raise NotImplementedError(
            f"labeling strategy {strategy!r} draws random keys: it comes in "
            f"a later slice of the port, with a torch.Generator")
    region = region_ids.long()
    order = _lexsort(points[:, label_axis], region)
    _, rank, _ = _segment_rank(region, order, num_regions)
    ids = torch.empty_like(region)
    ids[order] = rank % num_subsets
    return ids.to(torch.int32)


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


def partition_dataset(points: torch.Tensor, num_subsets: int,
                      leaf_capacity: int | None = None,
                      strategy: str = "kd_axis",
                      label_axis: int = 0) -> Partition:
    """Stage 1: tree build + labeling, for ``strategy="kd_axis"`` with the
    sort builder and labeler (the reference's single-process default; its
    histogram builder and labeler come in a later slice)."""
    if strategy != "kd_axis":
        raise NotImplementedError(
            f"partition strategy {strategy!r} draws random numbers: it comes "
            f"in a later slice of the port")
    cap = num_subsets if leaf_capacity is None else leaf_capacity
    depth = required_depth(points.shape[0], cap)
    region = build_kdtree(points, depth)
    ids = label_regions(points, region, 2 ** depth, num_subsets,
                        strategy="axis", label_axis=label_axis)
    return Partition(subset_ids=ids, region_ids=region, depth=depth)
