"""PKMeans baseline (Zhao et al. 2009), the paper's comparison target: the
counterpart of the single-process ``repro.core.pkmeans.pkmeans``.

One Lloyd iteration is one MapReduce job: mappers assign points, at most K
reducers average.  Here the whole dataset is one lane, and every iteration
is one ``engine.step`` over it.  On the card ``backend="twopass"`` runs the
assign kernel, then the centroid-update kernel; ``fused``, ``resident`` and
``batched`` (which always step here, as in the reference) run the fused
kernel, one launch a trip, whose accumulate is the centroid update's
chunked sort.  Both spread the one lane's sort and sums over the whole
card, and give the same centroids bit for bit.  ``pkmeans_sharded`` is
the same loop on a mesh of ranks, the points in row blocks, with one
all-reduce of the cluster statistics a trip.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import metrics
from repro_torch.core.kmeans import KMeansParams, check_params
from repro_torch.device import as_float, as_weights, resolve_device
from repro_torch.distributed import comm, sharding
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
    c, iters, conv = engine.lloyd_loop(
        x.unsqueeze(0), c0, None if w is None else w.unsqueeze(0),
        max_iters=params.max_iters, tol=params.tol,
        reseed_empty=params.reseed_empty)
    final = c[0].to(c0.dtype)
    total = metrics.sse(x, final, None if w is None else w != 0.0)
    return PKMeansResult(final, total, iters[0], conv[0])


def pkmeans_sharded(mesh, axis_names: tuple[str, ...],
                    params: KMeansParams = KMeansParams()):
    """PKMeans with the points in row blocks over the mesh axes
    ``axis_names`` (flattened, major to minor) and one all-reduce of the
    cluster statistics each Lloyd iteration: the reference's
    ``shard_map``'d solve.

    Returns ``solve(points, init_centroids, mask=None, *, device=None) ->
    PKMeansResult``, which every rank calls with the same global ``points``
    (numpy, or a tensor) and seeds; a rank moves only its row block to
    ``device`` (default: CUDA).  Each iteration is one ``engine.step`` on
    the block, then ONE all-reduce of the (sums, counts), K * d + K floats
    ("the MapReduce job"; stage "pkmeans" in ``distributed.comm``), then
    ``divide_or_keep`` in float32, rounded to the seeds' dtype.  The SSE is
    the block's at the final centroids, all-reduced (stage "sse").  Every
    rank returns the same result.  ``reseed_empty`` raises
    ``NotImplementedError``, as in the reference: the farthest point is
    block-local state.
    """
    if params.reseed_empty:
        raise NotImplementedError(
            "reseed_empty is not supported in pkmeans_sharded; reseeding "
            "targets the per-subset solvers (kmeans/ipkmeans)")
    check_params(params)
    axes = tuple(axis_names)
    grp = comm.group(mesh, axes)
    rows = sharding.s1_point_spec(axes, None)

    def all_reduce(sums, counts, sel):
        k, d = sums.shape[-2:]
        with comm.stage("pkmeans"):
            buf = comm.all_reduce(torch.cat([sums.reshape(-1),
                                             counts.reshape(-1)]), grp)
        return (buf[:k * d].view(sums.shape), buf[k * d:].view(counts.shape),
                None)

    def solve(points, init_centroids, mask=None, *,
              device=None) -> PKMeansResult:
        dev = resolve_device(device)
        x = as_float(rows.local(mesh, points), dev).float().unsqueeze(0)
        w = None if mask is None else as_weights(rows.local(mesh, mask),
                                                 dev).unsqueeze(0)
        c0 = as_float(init_centroids, dev)
        engine = engines.get_engine(params.backend)
        c, iters, conv = engine.lloyd_loop(
            x, c0, w, max_iters=params.max_iters, tol=params.tol,
            reduce=all_reduce)
        final = c[0].to(c0.dtype)
        with comm.stage("sse"):
            total = comm.all_reduce(engine.sse(x, final.float().unsqueeze(0),
                                               w), grp)[0]
        return PKMeansResult(final, total, iters[0], conv[0])

    return solve
