"""PKMeans baseline (Zhao et al. 2009), the paper's comparison target: the
counterpart of the single-process ``repro.core.pkmeans.pkmeans``.

One Lloyd iteration is one MapReduce job: mappers assign points, at most K
reducers average.  Here the whole dataset is one lane, and every iteration
is one ``engine.step`` over it.  On the card ``backend="twopass"`` runs the
assign kernel, then the centroid-update kernel; ``fused``, ``resident`` and
``batched`` (which always step here, as in the reference) run the fused
kernel, one launch a trip, whose accumulate is the centroid update's
chunked sort.  Both spread the one lane's sort and sums over the whole
card, and give the same centroids bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import metrics
from repro_torch.core.kmeans import KMeansParams, check_params
from repro_torch.device import as_float, as_weights, resolve_device
from repro_torch.kernels import engine as engines


class PKMeansResult(NamedTuple):
    centroids: torch.Tensor    # (k, d)
    sse: torch.Tensor          # () total SSE over the full dataset
    iters: torch.Tensor        # () int32 — one MapReduce job per iteration
    converged: torch.Tensor    # () bool


def pkmeans(points, init_centroids, mask=None,
            params: KMeansParams = KMeansParams(), *,
            device=None) -> PKMeansResult:
    """Single-process PKMeans: global Lloyd to convergence.

    ``points (n, d)``, ``init_centroids (k, d)`` (taken as given:
    ``params.init`` is not read, as in the reference), optional ``mask
    (n,)`` (False or 0 rows are padding).  The reference's loop: while
    ``it < max_iters and shift > tol``, one ``engine.step`` on the single
    lane, ``divide_or_keep``, with ``reseed_empty`` the reseed of empty
    clusters (budget ``min(k, n)``), then ``centroid_shift``
    (``LloydEngine.lloyd_loop`` on a stack of one).  The final SSE is
    ``metrics.sse`` over the dataset.  Float32 or bfloat16 inputs; the
    seeds' dtype is the carry dtype, and the centroids and the SSE come
    back in it, as in the reference.  Runs on ``device`` (default: CUDA,
    raising without a card).
    """
    check_params(params)
    dev = resolve_device(device)
    x = as_float(points, dev)
    c0 = as_float(init_centroids, dev)
    w = None if mask is None else as_weights(mask, dev)
    engine = engines.get_engine(params.backend)
    c, iters, shift = engine.lloyd_loop(
        x.unsqueeze(0), c0, None if w is None else w.unsqueeze(0),
        max_iters=params.max_iters, tol=params.tol,
        reseed_empty=params.reseed_empty)
    final = c[0].to(c0.dtype)
    total = metrics.sse(x, final, None if w is None else w != 0.0)
    return PKMeansResult(final, total, iters[0], shift[0] <= params.tol)


def pkmeans_sharded(mesh, axis_names: tuple[str, ...],
                    params: KMeansParams = KMeansParams()):
    """The points-sharded PKMeans with a per-iteration all-reduce of the
    cluster statistics: not ported yet."""
    raise NotImplementedError(
        "pkmeans_sharded comes in a later slice of the port (the "
        "distributed slice, on torch.distributed)")
