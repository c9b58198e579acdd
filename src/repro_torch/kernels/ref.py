"""Plain PyTorch oracles, the counterpart of ``repro.kernels.ref``.

Ground truth for the port's kernels and the ``eager`` engine.  Every function
takes one subset (``(n, d)`` points) like the reference, or a stack of them
with the lanes as leading dimensions (``(M, n, d)``).
"""
from __future__ import annotations

import torch


def divide_or_keep(sums: torch.Tensor, counts: torch.Tensor,
                   old_centroids: torch.Tensor) -> torch.Tensor:
    """Keep-old-centroid division policy: ``sums / counts`` where a cluster
    captured points, the previous centroid where it is empty.  Works on any
    leading lane dimensions: ``(..., k, d)``, ``(..., k)``."""
    c = counts.unsqueeze(-1)
    return torch.where(c > 0.0, sums / torch.clamp(c, min=1.0), old_centroids)


def reseed_rows(score: torch.Tensor, empty: torch.Tensor, kk: int):
    """Which centroid rows to replace, and with which point rows.

    Lane-stacked: ``score (..., n)`` f32 (``-inf`` for invalid rows),
    ``empty (..., k)`` bool -> ``(take (..., k) bool, rows (..., k) int64)``.
    Same semantics as the reference's sequential loop: the ``e``-th empty
    cluster (in index order) takes the ``e``-th farthest point, equal scores
    breaking to the lowest row.  A stable descending sort gives exactly that
    order, because each pick removes the current maximum.  An empty cluster
    keeps its old centroid when ``e >= kk`` or the score it would take is not
    finite (the reference's first pick then sees a non-finite maximum too,
    and so does every later one).
    """
    sorted_score, order = torch.sort(score.float(), dim=-1, descending=True,
                                     stable=True)
    e = torch.cumsum(empty.to(torch.int64), dim=-1) - 1          # (..., k)
    slot = torch.clamp(e, 0, score.shape[-1] - 1)
    cand = torch.gather(sorted_score, -1, slot)
    first_ok = torch.isfinite(sorted_score[..., :1])
    take = empty & (e < kk) & torch.isfinite(cand) & first_ok
    return take, torch.gather(order, -1, slot)


def reseed_farthest(points: torch.Tensor, score: torch.Tensor,
                    empty: torch.Tensor, kk: int):
    """Farthest-point re-selection: ``points (..., n, d)`` with the
    arguments of :func:`reseed_rows` -> ``(take (..., k) bool, picks
    (..., k, d))``; replace row ``j`` with ``picks[j]`` where ``take[j]``."""
    take, rows = reseed_rows(score, empty, kk)
    picks = torch.gather(
        points, -2, rows.unsqueeze(-1).expand(*rows.shape, points.shape[-1]))
    return take, picks


def assign_ref(points: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment: (n,d),(k,d) -> labels (n,) i32, min sq
    distances (n,) f32.  Ties break to the lowest index (``torch.argmin``
    returns the first minimum)."""
    x = points.float()
    c = centroids.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1).unsqueeze(-2)
    d2 = torch.clamp(x2 - 2.0 * (x @ c.transpose(-1, -2)) + c2, min=0.0)
    labels = torch.argmin(d2, dim=-1)
    mind = torch.gather(d2, -1, labels.unsqueeze(-1)).squeeze(-1)
    return labels.to(torch.int32), mind


def centroid_update_ref(points: torch.Tensor, labels: torch.Tensor,
                        weights: torch.Tensor, k: int):
    """Weighted per-cluster sums and counts: -> sums (k,d) f32, counts (k,)
    f32, as the reference's one-hot product."""
    onehot = torch.nn.functional.one_hot(labels.long(), k).float()
    onehot = onehot * weights.float().unsqueeze(-1)
    sums = onehot.transpose(-1, -2) @ points.float()
    return sums, torch.sum(onehot, dim=-2)


def _as_weights(points: torch.Tensor, weights: torch.Tensor | None):
    if weights is None:
        return torch.ones(points.shape[:-1], dtype=torch.float32,
                          device=points.device)
    return weights.float()


def lloyd_step_ref(points: torch.Tensor, centroids: torch.Tensor,
                   weights: torch.Tensor | None = None):
    """One Lloyd pass over the data -> sums (k,d) f32, counts (k,) f32, sse
    () f32; composes the two single-phase oracles like the reference."""
    k = centroids.shape[-2]
    w = _as_weights(points, weights)
    labels, mind = assign_ref(points, centroids)
    sums, counts = centroid_update_ref(points, labels, w, k)
    return sums, counts, torch.sum(w * mind, dim=-1)
