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

The ``*_sharded`` functions and ``pack_subsets_a2a`` run on a mesh of ranks
(``distributed/``): points in row blocks over the mesh axes, every rank
exchanging only O(R * 256) histogram summaries per radix round, or its own
points once in the a2a pack.  Each takes the global points (every rank the
same array, on any device) and works on its own row block
(``sharding.s1_point_spec``); per-point outputs are this rank's block.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import torch

from repro_torch.distributed import comm, sharding

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
                               region: torch.Tensor, num_regions: int,
                               grp=None) -> torch.Tensor:
    """Exact per-region median split without sorting.

    Radix-refines the median over 8 byte rounds (4 bytes of the monotone
    key, then 4 bytes of the point index as a unique tie-break, which is
    the stable sort's order).  Each round is one integer ``scatter_add_``
    of the still-matching points into (R, 256) bins.  The left half takes
    ``(counts + 1) // 2`` points of each region.  Returns (n,) bool.

    With a process group ``grp`` the points are this rank's block, ``idx``
    their global indices, and each round's (R, 256) histogram is
    all-reduced over ``grp`` (round 0's row sums are the regions' sizes):
    integer sums, so every median decision is the single-device build's
    bit for bit.
    """
    n = key.shape[0]
    dev = key.device
    match = torch.ones(n, dtype=torch.bool, device=dev)
    less = torch.zeros(n, dtype=torch.bool, device=dev)
    for r in range(8):
        src = key if r < 4 else idx
        byte = (src >> (8 * (3 - r % 4))) & 0xFF
        hist = torch.zeros(num_regions * 256, dtype=torch.int64, device=dev)
        hist.scatter_add_(0, region * 256 + byte, match.long())
        if grp is not None:
            hist = comm.all_reduce(hist, grp)
        cum = torch.cumsum(hist.view(num_regions, 256), dim=1)
        if r == 0:
            # every point matches in round 0: its histogram's row sums are
            # the regions' sizes
            remaining = (cum[:, -1] + 1) // 2              # ceil -> left
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
    n = points.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=points.device)
    return _build_histogram(points, idx, depth)


def _build_histogram(points, idx, depth: int, grp=None) -> torch.Tensor:
    d = points.shape[1]
    region = torch.zeros(points.shape[0], dtype=torch.int64,
                         device=points.device)
    for level in range(depth):
        key = _monotone_u32(points[:, level % d])
        go_right = _histogram_median_go_right(key, idx, region, 2 ** level,
                                              grp)
        region = region * 2 + go_right.long()
    return region.to(torch.int32)


def _point_block(points, mesh, subset_axes, pod_axis, device):
    """This rank's row block of the global points (``sharding.
    s1_point_spec``), on ``device``, and the global index of its first
    row."""
    sl = sharding.s1_point_spec(subset_axes, pod_axis).slices(
        mesh, points.shape)[0]
    x = points[sl]
    if device is not None:
        x = x.to(device)
    return x.contiguous(), sl.start


def build_kdtree_histogram_sharded(points, depth: int, mesh,
                                   axis_names: tuple[str, ...], *,
                                   device=None) -> torch.Tensor:
    """The histogram build with the points in row blocks over
    ``axis_names`` (on the pod mesh ``("pods", "data")``): each rank
    radix-refines every region's median on its own rows and all-reduces the
    (R, 256) byte histograms each round, so the traffic a tree level is
    O(R * 256) ints, whatever n.  Point indices are global (block start +
    local index), which keeps the stable sort's tie-break: the region ids
    are the single-device build's bit for bit.  ``points`` is the global
    ``(n, d)`` tensor; returns this rank's block of the (n,) int32 region
    ids, on ``device`` (default: the points')."""
    x, lo = _point_block(points, mesh, axis_names, None, device)
    idx = torch.arange(lo, lo + x.shape[0], dtype=torch.int64,
                       device=x.device)
    return _build_histogram(x, idx, depth, comm.group(mesh, axis_names))


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
                    num_regions: int, grp=None) -> torch.Tensor:
    """Per-point bucket id in [0, 256): the labeling key quantized against
    its region's [min, max] span, f32 ``(f - lo) / w * 256`` truncated to
    int32 and clipped, in the reference's order of operations.
    With a process group ``grp`` the span's min and max are all-reduced
    over it (order free, so the buckets are the single-device ones bit for
    bit)."""
    f = key2.to(torch.float32)
    lo = torch.full((num_regions,), torch.inf, device=f.device)
    hi = torch.full((num_regions,), -torch.inf, device=f.device)
    lo.scatter_reduce_(0, region, f, "amin")
    hi.scatter_reduce_(0, region, f, "amax")
    if grp is not None:
        # one all-reduce: the max of the highs is minus the min of -high
        both = comm.all_reduce(torch.cat([lo, -hi]), grp, "min")
        lo, hi = both[:num_regions], -both[num_regions:]
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


def label_regions_histogram_sharded(points, region_ids: torch.Tensor,
                                    num_regions: int, num_subsets: int,
                                    mesh, axis_names: tuple[str, ...],
                                    label_axis: int = 0, *,
                                    device=None) -> torch.Tensor:
    """The bucketed labeler (axis variant) on row blocks, without a global
    sort.  A point's rank inside its region is the sum of three pieces
    that need no order across ranks: (a) the region's points in smaller
    buckets, an exclusive cumsum of the (R, 256) histogram summed over the
    ranks; (b) the same (region, bucket) cell's points on ranks of smaller
    index; (c) its stable rank inside the cell on this rank.  (a) and (b)
    come from one exclusive scan of the local histograms over the ranks.
    Global order is rank-major, so the sum is
    ``label_regions_histogram``'s rank and the subset ids are its bit for
    bit.  ``points`` is the global tensor, ``region_ids`` this
    rank's block of them; returns this rank's block of the (n,) int32
    subset ids."""
    x, _ = _point_block(points, mesh, axis_names, None, device)
    grp = comm.group(mesh, axis_names)
    region = region_ids.to(x.device).long()
    nb = num_regions * _LABEL_BUCKETS
    b = _region_buckets(x[:, label_axis], region, num_regions, grp)
    rb = region * _LABEL_BUCKETS + b.long()
    hist, pref = comm.exclusive_scan(torch.bincount(rb, minlength=nb), grp)
    hist = hist.view(num_regions, _LABEL_BUCKETS)
    base = (torch.cumsum(hist, dim=1) - hist).reshape(-1)   # (a)
    # (b) is pref; (c):
    order = torch.sort(rb, stable=True).indices
    _, lrank_sorted, _ = _segment_rank(rb, order, nb)
    lrank = torch.empty_like(lrank_sorted)
    lrank[order] = lrank_sorted
    rank = base[rb] + pref[rb] + lrank
    return (rank % num_subsets).to(torch.int32)


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


def pack_local(points, subset_ids: torch.Tensor, num_subsets: int,
               capacity: int, mesh, axis_names: tuple[str, ...],
               pod_axis: str | None = None, *, sort: bool = False,
               device=None):
    """This rank's block of the scatter pack (``sort``: the sorted pack)
    of the global ``points`` by the global ``subset_ids``: its subsets
    (``num_subsets`` over ``axis_names``) and, with ``pod_axis``, its pod's
    slice of their capacity, padded first to a multiple of the pod count
    (``sharding.subset_specs``).  Only this rank's subsets' points move to
    ``device`` (default: the ids').  -> ``(packed, mask, dropped)``, the
    lanes bit for bit the whole pack's; ``dropped`` counts the points past
    ``capacity`` over all subsets, from the ids every rank holds."""
    dev = subset_ids.device if device is None else torch.device(device)
    ids = subset_ids.to(dev).long()
    n_pods = sharding.axis_size(mesh, pod_axis)
    padded = capacity + -capacity % n_pods
    layout = sharding.subset_specs(axis_names, pod_axis)[0]
    m_blk, c_blk, _ = layout.slices(mesh, (num_subsets, padded,
                                           points.shape[1]))
    sel = (ids >= m_blk.start) & (ids < m_blk.stop)
    rows = torch.nonzero(sel).flatten()
    x = points[rows.to(points.device)].to(dev)
    m_loc = m_blk.stop - m_blk.start
    pack = pack_subsets_sorted if sort else pack_subsets
    out, msk = pack(x, ids[rows] - m_blk.start, m_loc, capacity)
    sizes = torch.bincount(ids, minlength=num_subsets)
    dropped = int(torch.sum(torch.clamp(sizes - capacity, min=0)))
    if padded > capacity:
        out = torch.nn.functional.pad(out, (0, 0, 0, padded - capacity))
        msk = torch.nn.functional.pad(msk, (0, padded - capacity))
    if pod_axis is not None:
        out, msk = out[:, c_blk].contiguous(), msk[:, c_blk].contiguous()
    return out, msk, dropped


def pack_subsets_a2a(points, subset_ids: torch.Tensor, num_subsets: int,
                     capacity: int, mesh, axis_names: tuple[str, ...],
                     slack: float = 1.3, pod_axis: str | None = None, *,
                     device=None):
    """The pack as one ``all_to_all`` shuffle: each point moves once, to
    the rank that owns its subset (subset ``s`` lives on in-pod rank
    ``s // (M / R)``).  ``points`` is the global tensor, sharded here in row
    blocks over ``(pod_axis,) + axis_names``; ``subset_ids`` is this
    rank's block of the ids (as the sharded S1 gives them).

    Each (source, destination) pair has ``c_send`` send slots: the mean
    ``n_loc / R`` times ``slack``, plus a 4-sigma floor, rounded up to a
    multiple of 8 (at least 8), the reference's formula.  With
    ``pod_axis`` the exchange runs over the in-pod ranks only: a point goes
    to its subset's owner inside its own pod, and each pod holds a
    ``capacity // pods`` slice of every subset, so the pack moves nothing
    across pods.

    -> this rank's ``(packed (M_loc, capacity // pods, d), mask, dropped)``
    (``sharding.subset_specs``); ``dropped`` counts the points lost to
    slot or capacity overflow over the whole mesh (0 in a healthy
    configuration; the pipeline raises otherwise).  Preconditions: M
    divides over the in-pod ranks, n over all ranks, ``capacity`` over the
    pods; where one fails it warns and packs as ``pack_local`` does (the
    ids all-gathered first).
    """
    n, d = points.shape
    axes = tuple(axis_names)
    r = sharding.axis_size(mesh, axes)
    n_pods = sharding.axis_size(mesh, pod_axis) if pod_axis else 1
    n_dev = r * n_pods
    precondition = None
    if num_subsets % r:
        precondition = f"num_subsets={num_subsets} % in-pod devices={r} != 0"
    elif n % n_dev:
        precondition = f"n={n} % devices={n_dev} != 0"
    elif capacity % n_pods:
        precondition = f"capacity={capacity} % pods={n_pods} != 0"
    all_axes = ((pod_axis,) + axes) if pod_axis else axes
    if precondition:
        warnings.warn(
            "pack_subsets_a2a: falling back to the scatter pack "
            f"(all-gathered ids) because {precondition}",
            RuntimeWarning, stacklevel=2)
        ids = torch.cat(comm.all_gather_ragged(
            subset_ids, comm.group(mesh, all_axes)))
        return pack_local(points, ids, num_subsets, capacity, mesh, axes,
                          pod_axis, device=device)
    x, _ = _point_block(points, mesh, axes, pod_axis, device)
    dev = x.device
    ids_loc = subset_ids.to(dev).long()
    m_loc = num_subsets // r
    n_loc = n // n_dev
    cap_loc = capacity // n_pods
    # per-(src, dst) send slots: mean * slack plus a 4-sigma binomial floor
    mean = n_loc / r
    c_send = max(8, -(-int(mean * slack + 4 * math.sqrt(mean)) // 8) * 8)
    # route local points to the in-pod rank owning their subset
    dst = ids_loc // m_loc
    order = torch.sort(dst, stable=True).indices
    _, slot_sorted, _ = _segment_rank(dst, order, r)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    keep = slot < c_send                                  # drop overflow
    send_x = torch.zeros((r, c_send, d), dtype=x.dtype, device=dev)
    send_id = torch.full((r, c_send), -1, dtype=torch.int64, device=dev)
    send_x[dst[keep], slot[keep]] = x[keep]
    send_id[dst[keep], slot[keep]] = ids_loc[keep]
    grp = comm.group(mesh, axes)
    flat_x = comm.all_to_all_single(send_x, grp).reshape(r * c_send, d)
    flat_id = comm.all_to_all_single(send_id, grp).reshape(r * c_send)
    # local re-pack into (m_loc, cap_loc, d)
    local_sub = torch.where(flat_id >= 0, flat_id % m_loc, m_loc)
    order2 = torch.sort(local_sub, stable=True).indices
    _, rank_sorted, _ = _segment_rank(local_sub, order2, m_loc + 1)
    rank = torch.empty_like(rank_sorted)
    rank[order2] = rank_sorted
    valid = (flat_id >= 0) & (rank < cap_loc)
    out = torch.zeros((m_loc, cap_loc, d), dtype=x.dtype, device=dev)
    msk = torch.zeros((m_loc, cap_loc), dtype=torch.bool, device=dev)
    out[local_sub[valid], rank[valid]] = flat_x[valid]
    msk[local_sub[valid], rank[valid]] = True
    total = comm.all_reduce(msk.sum().reshape(1), comm.group(mesh, all_axes))
    return out, msk, n - int(total[0])


def partition_dataset(points: torch.Tensor, num_subsets: int,
                      leaf_capacity: int | None = None,
                      strategy: str = "kd_axis",
                      label_axis: int = 0,
                      builder: str = "sort",
                      labeler: str = "sort", *,
                      draws=None,
                      generator: torch.Generator | None = None,
                      mesh=None, axis_names: tuple[str, ...] | None = None,
                      device=None) -> Partition:
    """Stage 1: tree build + labeling, or a random partition.

    ``strategy`` in {``"kd_axis"``, ``"kd_random"``, ``"random"``}: the
    paper's variants (2), (1) and (3).  ``builder``: ``"sort"`` (level-sync
    sorts) or ``"histogram"`` (the same medians, sort-free); ``labeler``:
    ``"sort"`` (exact-key order) or ``"histogram"`` (bucketed order).  The
    random variants consume ``draws``: ``(n,)`` f32 uniforms for
    ``kd_random`` (the reference's ``jax.random.uniform(key, (n,))``), an
    ``(n,)`` int64 permutation for ``random`` (its
    ``jax.random.permutation(key, n)``); without them they draw from
    ``generator``.

    With ``mesh`` and ``axis_names`` the stage runs on row blocks over
    ``axis_names`` (on the pod mesh ``("pods", "data")``): ``points`` is the
    global tensor, each rank's block moves to ``device`` (default: the
    points'), the traffic is the O(R * 256) histogram summaries, and the
    ids and regions returned are this rank's blocks.  It needs
    ``builder == labeler == "histogram"`` and ``strategy == "kd_axis"``, as
    in the reference: the sorts would need the whole dataset on one rank,
    and the random variants have no key stream that blocks reproduce.
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
    if mesh is not None:
        if axis_names is None:
            raise ValueError("sharded partition_dataset needs axis_names")
        if builder != "histogram" or labeler != "histogram":
            raise ValueError(
                "sharded partition_dataset requires builder='histogram' and "
                f"labeler='histogram' (got {builder!r}/{labeler!r}); the "
                "sort paths need the whole dataset on one rank")
        if strategy != "kd_axis":
            raise ValueError(
                f"sharded partition_dataset supports strategy='kd_axis' "
                f"only (got {strategy!r})")
        region = build_kdtree_histogram_sharded(points, depth, mesh,
                                                tuple(axis_names),
                                                device=device)
        ids = label_regions_histogram_sharded(
            points, region, 2 ** depth, num_subsets, mesh, tuple(axis_names),
            label_axis=label_axis, device=device)
        return Partition(subset_ids=ids, region_ids=region, depth=depth)
    build = build_kdtree_histogram if builder == "histogram" else build_kdtree
    region = build(points, depth)
    label = (label_regions_histogram if labeler == "histogram"
             else label_regions)
    ids = label(points, region, 2 ** depth, num_subsets,
                strategy="axis" if strategy == "kd_axis" else "random",
                label_axis=label_axis, uniforms=draws, generator=generator)
    return Partition(subset_ids=ids, region_ids=region, depth=depth)
