"""Centroid seeding, the counterpart of ``repro.core.init``.

  * ``sample_init``: k distinct points uniformly, the top k of n uniform
    draws.
  * ``kmeans_plus_plus``: k-means++ selection (Arthur & Vassilvitskii),
    weighted, with the reference's fallbacks when the residual mass is gone
    (duplicated points, k above the number of distinct points): weighted,
    then uniform over the points not yet chosen, then uniform over all.
    Every centroid is an input point.
  * ``kmeans_parallel_init``: k-means|| (Bahmani et al.): ``rounds + 1``
    sweeps, each ONE init-sweep launch (``kernels/init.py``) that folds the
    last round's candidates into the running distances, reduces the
    potential and draws the next candidates; then ONE assign launch weights
    each candidate by the points it captures, and weighted k-means++
    reclusters the candidates.  ``backend="plain"`` runs the plain PyTorch
    oracles instead (the reference's ``"ref"``).
  * ``resolve_init``: the dispatcher the entry points (``kmeans``,
    ``ipkmeans``) call when ``init != "given"``.

Randomness is an input.  JAX's random streams cannot be reproduced in
torch, but the way the reference consumes them can: ``sample_init`` takes
``(n,)`` uniforms, ``kmeans_plus_plus`` ``(k,)`` uniforms (draw ``i`` is
``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u_i))``, the arithmetic of
``jax.random.choice`` with ``p``), and ``kmeans_parallel_init`` a
:class:`KMeansParallelDraws`.  Without draws, each function draws them from
the ``torch.Generator`` it is given, on the points' device; there is no
global random state.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core import metrics
from repro_torch.distributed import comm, sharding
from repro_torch.kernels import ref

#: strategies understood by the pipeline (``KMeansParams.init`` /
#: ``IPKMeansConfig.with_init``); "given" = the caller supplies centroids
INIT_METHODS = ("given", "sample", "kmeans++", "kmeans||")
#: k-means|| implementations: the CUDA kernels, or the plain oracles
INIT_BACKENDS = ("kernel", "plain")


class KMeansParallelDraws(NamedTuple):
    """The uniforms k-means|| consumes, each in [0, 1)."""
    first: torch.Tensor       # () the weighted-uniform first pick
    rounds: torch.Tensor      # (rounds + 1, n) one row per sweep
    recluster: torch.Tensor   # (k,) the k-means++ recluster's draws


def default_rounds(n: int, k: int) -> int:
    """The reference's round count: ``min(8, max(2, ceil(log2(n / k))))``
    for ``n > k``, else 2."""
    return min(8, max(2, int(math.ceil(math.log2(max(n, 2) / max(k, 1)))))
               if n > k else 2)


def _uniforms(shape, generator, device) -> torch.Tensor:
    if generator is None:
        raise ValueError("seeding needs its draws, or a torch.Generator to "
                         "draw them from")
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)


def _as_draw(u, shape, device) -> torch.Tensor:
    u = torch.as_tensor(u, dtype=torch.float32, device=device)
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"draws of shape {tuple(u.shape)}, expected "
                         f"{tuple(shape)}")
    return u


def parallel_draws(n: int, k: int, rounds: int, generator: torch.Generator,
                   device) -> KMeansParallelDraws:
    """Fresh k-means|| draws for ``n`` points, ``k`` seeds and ``rounds``."""
    return KMeansParallelDraws(_uniforms((), generator, device),
                               _uniforms((rounds + 1, n), generator, device),
                               _uniforms((k,), generator, device))


def _choice(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, p=probs)`` given its uniform ``u``: the
    first index whose cumulative probability reaches ``total * (1 - u)``
    -> a (1,) int64 tensor, on the device (no host sync)."""
    cum = torch.cumsum(probs, dim=0)
    return torch.searchsorted(cum, (cum[-1] * (1.0 - u)).reshape(1))


def sample_init(points: torch.Tensor, k: int, *, uniforms=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """k distinct points, uniformly: the points of the k largest of ``n``
    uniforms, largest first (equal draws: lower row first, as
    ``lax.top_k``)."""
    n = points.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"sample_init needs 0 < k <= n, got k={k}, n={n}")
    u = (_uniforms((n,), generator, points.device) if uniforms is None
         else _as_draw(uniforms, (n,), points.device))
    idx = torch.sort(u, descending=True, stable=True).indices[:k]
    return points[idx]


def kmeans_plus_plus(points: torch.Tensor, k: int, *, weights=None,
                     uniforms=None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """k-means++ seeding: each next centroid is drawn in proportion to its
    (weighted) squared distance from the chosen set; chosen rows are masked
    out of every draw, and when the residual mass is 0 the draw falls back
    to the weights, then to uniform over the rows not yet chosen, then to
    uniform over all rows (only then, with k > n, may a row repeat).

    ``uniforms (k,)``: draw ``i`` consumes ``uniforms[i]``.  The running
    minimum distance is updated with the new centroid only, the same
    minimum the reference takes over all chosen slots.
    """
    n = points.shape[0]
    dev = points.device
    w0 = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
          else torch.as_tensor(weights, dtype=torch.float32, device=dev))
    u = (_uniforms((k,), generator, dev) if uniforms is None
         else _as_draw(uniforms, (k,), dev))
    ones = torch.ones((n,), dtype=torch.float32, device=dev)

    def draw(ui, mass, chosen):
        residual = torch.where(chosen, 0.0, mass)
        weighted = torch.where(chosen, 0.0, w0)
        uniform = torch.where(chosen, 0.0, ones)
        src = torch.where(
            torch.sum(residual) > 0.0, residual,
            torch.where(torch.sum(weighted) > 0.0, weighted,
                        torch.where(torch.sum(uniform) > 0.0, uniform, ones)))
        probs = src / torch.clamp(torch.sum(src), min=1e-30)
        return _choice(probs, ui)

    rows = torch.empty((k,), dtype=torch.int64, device=dev)
    chosen = torch.zeros((n,), dtype=torch.bool, device=dev)
    mind = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    mass = w0
    for i in range(k):
        idx = draw(u[i], mass, chosen)
        rows[i:i + 1] = idx
        chosen[idx] = True
        d2 = metrics.pairwise_sq_dists(points, points[idx])[:, 0]
        mind = torch.minimum(mind, d2)
        mass = mind * w0
    return points[rows]


def _sweep(backend: str, spec=None):
    if backend == "kernel":
        from repro_torch.kernels.init import init_sweep
        return functools.partial(init_sweep, spec=spec)
    return ref.init_sweep_ref


class Shard(NamedTuple):
    """One rank's part of a sharded k-means|| (``core/ipkmeans.py`` with a
    mesh): its row block of the points and of the weights on its device,
    the block's first global row, its columns of the round draws, and the
    process group the block's partial results reduce over."""
    x: torch.Tensor
    weights: torch.Tensor
    lo: int
    rounds: torch.Tensor
    grp: object


def _rows(points, idx: torch.Tensor, device) -> torch.Tensor:
    """Rows ``idx`` of ``points`` (any device) on ``device``."""
    return points[idx.to(points.device)].to(device)


def oversample(points: torch.Tensor, draws: KMeansParallelDraws, *,
               ell: float, weights: torch.Tensor, backend: str = "kernel",
               spec=None, shard: Shard | None = None):
    """The k-means|| rounds: the weighted-uniform first pick, then sweeps
    0..rounds (sweep r folds round r-1's draws and draws round r's; round 0
    has ``psi_prev = 0`` and draws nothing).  -> ``(pool (c,) int64, mind
    (n,), psi trace [float])``: the pool is the sorted distinct
    candidates, topped up with the farthest points (stable order) when it
    holds fewer than ``len(draws.recluster)``.  ``spec`` is the init-sweep
    kernel's (``backend="kernel"`` only).

    With ``shard`` each sweep runs on the rank's row block with its columns
    of the draws, against candidates taken from the global ``points``; the
    potential is all-reduced, the drawn global rows all-gathered (ragged,
    in rank order: the single-device order), and ``mind`` is the block's.
    The draws equal the single-device ones except where a sum order moves
    ``u * psi_prev < ell * mind`` across its boundary."""
    n = points.shape[0]
    k = draws.recluster.shape[0]
    sweep = _sweep(backend, spec)
    x = points if shard is None else shard.x
    w = weights if shard is None else shard.weights
    rounds = draws.rounds if shard is None else shard.rounds
    # the first pick's probabilities are normalised in float64, then used in
    # float32, as the reference does on the host
    probs = weights.double()
    total = torch.sum(probs)
    probs = (probs / total if float(total) > 0
             else torch.full_like(probs, 1.0 / n))
    new_idx = _choice(probs.float(), draws.first)
    picks = [new_idx]
    mind = torch.full((x.shape[0],), torch.inf, dtype=torch.float32,
                      device=x.device)
    psi = torch.zeros((), dtype=torch.float32, device=x.device)
    trace = []
    for r in range(rounds.shape[0]):
        mind, sampled, psi = sweep(x, _rows(points, new_idx, x.device), mind,
                                   rounds[r], psi, ell=ell, weights=w)
        new_idx = torch.nonzero(sampled).flatten()
        if shard is not None:
            psi = comm.all_reduce(psi, shard.grp)
            new_idx = torch.cat(comm.all_gather_ragged(new_idx + shard.lo,
                                                       shard.grp))
        trace.append(psi)
        picks.append(new_idx)
    trace = torch.stack(trace).tolist()
    pool = torch.unique(torch.cat(picks))
    if pool.numel() < k:
        # degenerate draw (tiny n or ell): the farthest points fill the pool
        every = (mind if shard is None else
                 torch.cat(comm.all_gather_ragged(mind, shard.grp)))
        order = torch.sort(-every, stable=True).indices
        extra = order[~torch.isin(order, pool)][:k - pool.numel()]
        pool = torch.cat([pool, extra])
    return pool, mind, trace


def candidate_weights(points: torch.Tensor, cands: torch.Tensor,
                      weights: torch.Tensor, backend: str = "kernel",
                      spec=None, grp=None):
    """The point mass each candidate captures: one assign pass (the assign
    kernel with ``spec``, or ``ref.assign_ref``), then ``index_add_`` of the
    weights by label, as the reference leaves that scatter to XLA.  With a
    process group ``grp``, ``points`` and ``weights`` are a rank's block
    and the masses are all-reduced over it."""
    if backend == "kernel":
        from repro_torch.kernels.assign import assign
        labels = assign(points, cands, spec=spec).labels
    else:
        labels = ref.assign_ref(points, cands)[0]
    out = torch.zeros((cands.shape[0],), dtype=torch.float32,
                      device=points.device)
    out.index_add_(0, labels.long(), weights)
    return out if grp is None else comm.all_reduce(out, grp)


def kmeans_parallel_init(points: torch.Tensor, k: int, *,
                         ell: float | None = None, rounds: int | None = None,
                         weights=None, backend: str = "kernel",
                         spec=None,
                         draws: KMeansParallelDraws | None = None,
                         generator: torch.Generator | None = None,
                         return_stats: bool = False, mesh=None,
                         axis_names: tuple[str, ...] = ("data",),
                         device=None):
    """k-means|| seeding (Bahmani et al.) -> ``(k, d)`` centroids, every one
    an input point (and, with ``return_stats``, a dict of the candidate
    count, rounds, ``ell`` and the potential of each sweep).

    Defaults: ``ell = 2k`` and ``rounds = default_rounds(n, k)``.  Each
    sweep draws against the PREVIOUS sweep's potential, the one-sweep
    variant of the reference.  ``backend="kernel"`` runs the init-sweep and
    assign kernels on a CUDA tensor (their plain versions on a CPU one),
    ``"plain"`` the plain oracles ``ref.init_sweep_ref`` and
    ``ref.assign_ref``.  ``spec`` is the kernels' ``KernelSpec``; left
    ``None`` on the kernels, it is the tuning cache's entry for the sweep's
    steady candidate tile (``tuning.lookup_init_spec``), else the module
    default.

    With ``mesh`` each sweep and the weighting pass run on this rank's row
    block over ``axis_names`` (``points``: the global tensor, every rank
    the same, on any device; the block and the candidates move to
    ``device``, default the points'): the potential and the candidate
    masses are all-reduced, the drawn rows all-gathered, and the recluster
    runs on every rank from the same draws, so every rank returns the same
    seeds.
    """
    n = points.shape[0]
    if n < 1:
        raise ValueError("kmeans_parallel_init needs at least one point")
    if backend not in INIT_BACKENDS:
        raise ValueError(f"unknown init sweep backend: {backend!r} "
                         f"(expected one of {INIT_BACKENDS})")
    dev = points.device if device is None else torch.device(device)
    ell = float(2 * k) if ell is None else float(ell)
    rounds = max(1, int(default_rounds(n, k) if rounds is None else rounds))
    w = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=dev))
    if spec is None and backend == "kernel":
        from repro_torch.kernels import tuning
        cap0 = max(8, 1 << max(0, int(math.ceil(ell)) - 1).bit_length())
        spec = tuning.lookup_init_spec(n, points.shape[1], cap0,
                                       points.dtype, device=dev)
    if draws is None:
        draws = parallel_draws(n, k, rounds, generator, dev)
    shard = None
    if mesh is not None:
        sl = sharding.s1_point_spec(axis_names, None).slices(mesh, (n,))[0]
        u = torch.as_tensor(draws.rounds)[:, sl]
        shard = Shard(points[sl].to(dev).contiguous(), w[sl], sl.start,
                      _as_draw(u, (rounds + 1, sl.stop - sl.start), dev),
                      comm.group(mesh, axis_names))
    draws = KMeansParallelDraws(
        _as_draw(draws.first, (), dev),
        draws.rounds if shard is not None
        else _as_draw(draws.rounds, (rounds + 1, n), dev),
        _as_draw(draws.recluster, (k,), dev))
    pool, _, trace = oversample(points, draws, ell=ell, weights=w,
                                backend=backend, spec=spec, shard=shard)
    cands = _rows(points, pool, dev)
    if shard is None:
        cweights = candidate_weights(points, cands, w, backend, spec)
    else:
        cweights = candidate_weights(shard.x, cands, shard.weights, backend,
                                     spec, shard.grp)
    centroids = kmeans_plus_plus(cands, k, weights=cweights,
                                 uniforms=draws.recluster)
    if return_stats:
        return centroids, {"candidates": int(pool.numel()), "rounds": rounds,
                           "ell": ell, "psi": trace}
    return centroids


def resolve_init(points: torch.Tensor, k: int, method: str, *, weights=None,
                 backend: str = "kernel", spec=None, draws=None,
                 generator: torch.Generator | None = None, mesh=None,
                 axis_names: tuple[str, ...] = ("data",),
                 device=None) -> torch.Tensor:
    """An init strategy name -> ``(k, d)`` centroids.

    ``draws`` are the method's own: ``(n,)`` uniforms for ``"sample"``,
    ``(k,)`` for ``"kmeans++"``, a :class:`KMeansParallelDraws` for
    ``"kmeans||"``; without them the method draws from ``generator``.
    ``backend`` selects the k-means|| implementation (``"kernel"`` |
    ``"plain"``) and ``spec`` its kernels' ``KernelSpec``; ``weights``
    weight ``"kmeans++"`` and ``"kmeans||"``.  With ``mesh``,
    ``"kmeans||"`` runs sharded over ``axis_names`` and the others on the
    whole of ``points`` moved to ``device``, as the reference leaves them.
    """
    if method not in INIT_METHODS or method == "given":
        raise ValueError(f"unknown init method: {method!r} "
                         f"(expected one of {INIT_METHODS[1:]})")
    if method == "kmeans||":
        return kmeans_parallel_init(points, k, weights=weights,
                                    backend=backend, spec=spec, draws=draws,
                                    generator=generator, mesh=mesh,
                                    axis_names=axis_names, device=device)
    if device is not None:
        points = points.to(device)
    if method == "sample":
        return sample_init(points, k, uniforms=draws, generator=generator)
    return kmeans_plus_plus(points, k, weights=weights, uniforms=draws,
                            generator=generator)
