"""Distance / SSE / ASSE metrics, the counterpart of ``repro.core.metrics``.

Same ``||x||^2 - 2 x.c + ||c||^2`` decomposition and clamp as the reference.
``sse`` over a whole dataset runs in row chunks so the ``(n, k)`` distance
matrix never exists at once: at 8.4M points and 1024 centroids it would be
34 GB.  Each chunk is one plain matrix product, as the reference leaves this
contraction to XLA outside any kernel.
"""
from __future__ import annotations

import torch

# rows per chunk of ``sse``: a (2**18, 1024) f32 distance block is 1 GiB
SSE_CHUNK_ROWS = 1 << 18


def pairwise_sq_dists(points: torch.Tensor,
                      centroids: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances, (n, d) x (k, d) -> (n, k), clamped at 0."""
    x2 = torch.sum(points * points, dim=-1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=-1).unsqueeze(-2)
    xc = points @ centroids.transpose(-1, -2)
    return torch.clamp(x2 - 2.0 * xc + c2, min=0.0)


def masked_count(mask: torch.Tensor | None, n: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    if mask is None:
        return torch.tensor(float(n), dtype=torch.float32, device=device)
    return torch.sum(mask.float())


def sse(points: torch.Tensor, centroids: torch.Tensor,
        mask: torch.Tensor | None = None,
        chunk_rows: int = SSE_CHUNK_ROWS) -> torch.Tensor:
    """Sum of squared errors of each point to its nearest centroid."""
    total = torch.zeros((), dtype=torch.float32, device=points.device)
    for lo in range(0, points.shape[0], chunk_rows):
        m = torch.min(pairwise_sq_dists(points[lo:lo + chunk_rows],
                                        centroids), dim=-1).values
        if mask is not None:
            m = torch.where(mask[lo:lo + chunk_rows], m, 0.0)
        total = total + torch.sum(m)
    return total


def asse(points: torch.Tensor, centroids: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Average SSE (the paper's merge-selection criterion)."""
    cnt = masked_count(mask, points.shape[0], points.device)
    return sse(points, centroids, mask) / torch.clamp(cnt, min=1.0)


def centroid_shift(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Max euclidean movement over centroids, per lane for ``(..., k, d)``."""
    return torch.amax(torch.sqrt(torch.sum((new - old) ** 2, dim=-1)), dim=-1)
