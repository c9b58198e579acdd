"""Stage-3 centroid merging (paper Section 2.iii), the counterpart of
``repro.core.merge``.

Both merges work on the K*M intermediate centroids of the M per-subset
solves.  ``hierarchical_merge`` carries an (N, N) distance matrix, N = K*M,
so it runs only where N**2 floats fit on the device.  Its squared distances
are sums of squares in a fixed pairwise order, so every device computes the
same bits and picks the same pairs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# rows of the initial (N, N) distance matrix computed at once: the (rows,
# N, d) difference block is rows * N * d floats
_D2_BLOCK_ELEMS = 1 << 26


def _sq_sum(diff: torch.Tensor) -> torch.Tensor:
    """``sum(diff ** 2)`` over the last dimension by halving (zero-padded
    to a power of two): the same additions in the same order on every
    device, where ``torch.sum``'s order depends on the device's kernel.
    The squares are in ``diff``'s dtype; the additions run in float32 and
    the result is rounded once back to it, as the reference's bfloat16
    sums are."""
    v = (diff * diff).float()
    d = v.shape[-1]
    width = 1 << max(0, d - 1).bit_length()
    if width != d:
        v = F.pad(v, (0, width - d))
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0].to(diff.dtype)


def _pair_sq_dists(c: torch.Tensor) -> torch.Tensor:
    """``sum((c_i - c_j) ** 2)`` for every pair, elementwise as the
    reference computes it (a matrix product would round otherwise and could
    change which pair is closest), in row blocks."""
    n, d = c.shape
    d2 = torch.empty((n, n), dtype=c.dtype, device=c.device)
    rows = max(1, _D2_BLOCK_ELEMS // max(1, n * d))
    for lo in range(0, n, rows):
        d2[lo:lo + rows] = _sq_sum(c[lo:lo + rows, None, :] - c[None, :, :])
    return d2


def hierarchical_merge(centroids: torch.Tensor,
                       num_clusters: int) -> torch.Tensor:
    """Algorithm 5: repeatedly replace the closest active pair by its
    midpoint until ``num_clusters`` remain, over N - K merge steps with an
    active mask.

    The reference's arithmetic: the (N, N) matrix of squared distances is
    computed once with +inf on the diagonal; each step takes the flat
    ``argmin`` (the first minimum, so the pair comes out with i < j; found
    as row minima, then the first least row), moves
    ``c[i]`` to the midpoint, retires ``j``, and rewrites the rows and
    columns of i and j.  The steps stay on the device: no value is read
    back to the host until the end.  Returns (num_clusters, d): the
    survivors, packed by a stable sort of the inactive flags.
    """
    return _merge(centroids, num_clusters, _closest_by_rows)


def _closest_by_rows(d2: torch.Tensor):
    """The first minimum of ``d2`` in row-major order as (i, j), each of
    shape (1,): row minima, then the first least row.  It is the flat
    ``argmin``'s answer and the faster search on a CPU, where the flat
    ``argmin`` runs on one core; on an H100 the flat search is no faster
    (``chip_smoke.py`` [merge] times both)."""
    vals, cols = torch.min(d2, dim=1)
    i = torch.argmin(vals).view(1)
    return i, cols.index_select(0, i)


def _closest_flat(d2: torch.Tensor):
    """The reference's search, one flat ``argmin`` (the same pair as
    ``_closest_by_rows``); kept to time against it."""
    flat = torch.argmin(d2).view(1)
    n = d2.shape[1]
    return flat // n, flat % n


def _merge(centroids: torch.Tensor, num_clusters: int, closest):
    """``hierarchical_merge`` with the closest-pair search ``closest``."""
    c = centroids.clone()
    n, d = c.shape
    steps = n - num_clusters
    if steps <= 0:
        return c[:num_clusters]
    dev = c.device
    idx = torch.arange(n, device=dev)
    d2 = _pair_sq_dists(c)
    d2.fill_diagonal_(torch.inf)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(steps):
        # the flat argmin (inactive/self entries are +inf)
        i, j = closest(d2)
        mid = 0.5 * (c.index_select(0, i) + c.index_select(0, j))
        c.index_copy_(0, i, mid)
        active.index_fill_(0, j, False)
        # only row/col i (moved to mid) and row/col j (retired) changed
        di = _sq_sum(c - mid)
        di = torch.where(active & (idx != i), di, torch.inf)
        d2.index_copy_(0, i, di.view(1, n))
        d2.index_copy_(1, i, di.view(n, 1))
        d2.index_fill_(0, j, torch.inf)
        d2.index_fill_(1, j, torch.inf)
    # pack the `num_clusters` active rows to the front (stable by index)
    order = torch.sort((~active).to(torch.uint8), stable=True).indices
    return c[order][:num_clusters]


def min_asse_merge(centroid_sets: torch.Tensor,
                   asses: torch.Tensor) -> torch.Tensor:
    """Paper's minimum-ASSE selection: among the M per-subset centroid sets
    (M, K, d), return the set whose subset had the lowest average SSE.
    The first index wins a tie (``torch.argmin`` returns the first
    minimum, as ``jnp.argmin`` does)."""
    return centroid_sets[torch.argmin(asses)]
