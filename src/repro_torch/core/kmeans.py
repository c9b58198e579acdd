"""Single-subset and stacked Lloyd's k-means, the counterpart of
``repro.core.kmeans``.

The solve is delegated whole to a :class:`repro_torch.kernels.engine
.LloydEngine` looked up from ``params.backend``: ``eager`` (plain PyTorch
oracles, the reference's ``jnp`` role), ``fused`` (the hand-written fused
kernel, one launch per Lloyd trip), ``resident`` (the whole-solve kernel,
one launch per subset) or ``batched`` (the whole-solve kernel, one launch
per stack), or ``twopass`` (the assign kernel, then the centroid-update
kernel, two launches per Lloyd trip), or ``tuned`` (``resident`` with the
tuning cache's spec).  ``kmeans`` seeds itself when ``params.init`` is not
``"given"`` (``core/init.py``); stacks always take their seeds.
``update_minibatch`` is the serving tier's refresh (``core/serve.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import metrics
from repro_torch.core.init import INIT_METHODS, resolve_init
from repro_torch.device import as_float, as_weights, resolve_device
from repro_torch.kernels import engine as engines
from repro_torch.kernels import ref


class KMeansParams(NamedTuple):
    max_iters: int = 300
    tol: float = 1e-6             # paper: "until centroids stop moving"
    backend: str = "eager"        # 'eager' | 'twopass' | 'fused' |
                                  # 'resident' | 'batched' | 'tuned'
    reseed_empty: bool = False    # re-seed empty clusters at farthest points
    prune: str = "none"           # 'none' | 'bounds' (bound-gated block
                                  # skipping in the whole-solve kernels; the
                                  # same result on every engine)
    init: str = "given"           # 'given' | 'sample' | 'kmeans++' |
                                  # 'kmeans||': seeding, resolved at the
                                  # entry points (kmeans, ipkmeans)


class KMeansResult(NamedTuple):
    centroids: torch.Tensor       # (k, d) or (M, k, d)
    sse: torch.Tensor             # () or (M,) total SSE per subset
    asse: torch.Tensor            # () or (M,) average SSE (merge criterion)
    iters: torch.Tensor           # () or (M,) int32 Lloyd iterations
    converged: torch.Tensor       # () or (M,) bool


def check_params(params: KMeansParams) -> None:
    """Raise for a value the port does not know or does not cover yet."""
    if params.init not in INIT_METHODS:
        raise ValueError(f"unknown init: {params.init!r} "
                         f"(expected one of {INIT_METHODS})")
    engines.check_prune(params.prune)
    engines.get_engine(params.backend)


def _asse(total_sse: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    # empty shards must never win the min-ASSE merge: ASSE = +inf
    return torch.where(cnt > 0.0, total_sse / torch.clamp(cnt, min=1.0),
                       torch.inf)


def lloyd_step(points, centroids, mask=None, backend: str = "eager", *,
               device=None):
    """One Lloyd iteration: assign + update -> ``(new_centroids (k,d), sse
    ())``.

    ``points (n, d)``, ``centroids (k, d)``, optional ``mask (n,)``: one
    ``engine.step`` on a stack of one lane, then ``divide_or_keep`` (an
    empty cluster keeps its centroid) in float32, cast back to the
    centroids' dtype as the reference does.  Runs on ``device`` (default:
    CUDA, raising without a card).
    """
    engine = engines.get_engine(backend)
    dev = resolve_device(device)
    x = as_float(points, dev)
    c = as_float(centroids, dev)
    w = None if mask is None else as_weights(mask, dev).unsqueeze(0)
    sums, counts, shard_sse = engine.step(x.unsqueeze(0), c.unsqueeze(0), w)
    new_c = ref.divide_or_keep(sums[0], counts[0], c.float())
    return new_c.to(c.dtype), shard_sse[0]


def update_minibatch(points, centroids, counts, mask=None,
                     params: KMeansParams = KMeansParams(), *, device=None):
    """One Sculley mini-batch refresh of a served centroid set:
    ``points (n,d)``, ``centroids (k,d)``, ``counts (k,)``, optional ``mask
    (n,)`` (0/1 or weights) -> ``(centroids (k,d) in the centroids' dtype,
    counts (k,) f32, sse () f32)``.

    Folds one batch into the running centroids with per-centre learning
    rates ``1 / count`` (``ref.minibatch_merge``); ``counts`` carries the
    per-centre mass across calls (seed it with the full solve's cluster
    sizes) and comes back grown by the batch, and ``sse`` scores the batch
    against the incoming centroids, so a rising series signals drift.
    Dispatches on ``params.backend`` (``LloydEngine.update_minibatch``: one
    fused launch on the fused-step engines); the loop controls are unused.
    Runs on ``device`` (default: CUDA, raising without a card).
    """
    engine = engines.get_engine(params.backend)
    dev = resolve_device(device)
    w = None if mask is None else as_weights(mask, dev)
    return engine.update_minibatch(as_float(points, dev),
                                   as_float(centroids, dev),
                                   as_weights(counts, dev), w)


def _init_backend(backend: str) -> str:
    """Which k-means|| implementation a Lloyd backend implies: the eager
    engine the plain oracles, every kernel engine the kernels."""
    return "plain" if backend == "eager" else "kernel"


def kmeans(points, init_centroids=None, mask=None,
           params: KMeansParams = KMeansParams(), *, k: int | None = None,
           draws=None, generator: torch.Generator | None = None,
           device=None) -> KMeansResult:
    """Run Lloyd's algorithm to convergence on one subset.

    ``points (n, d)``, ``init_centroids (k, d)``, optional ``mask (n,)``
    (False rows are padding and ignored), float32 or bfloat16; the seeds'
    dtype is the carry dtype and the centroids come back in it.  Runs on
    ``device`` (default: CUDA, raising without a card).

    With ``params.init`` other than ``"given"`` the seeds are drawn here,
    with the mask as weights: ``init_centroids`` may then be ``None``, ``k``
    is the cluster count (default: ``init_centroids.shape[0]``), and the
    draws are ``draws`` or come from ``generator`` (``core/init.py``).
    """
    check_params(params)
    dev = resolve_device(device)
    x = as_float(points, dev)
    w = None if mask is None else as_weights(mask, dev)
    if params.init != "given":
        kk = k if k is not None else (
            None if init_centroids is None else init_centroids.shape[0])
        if kk is None:
            raise ValueError(f"params.init={params.init!r} needs k= (or "
                             f"init_centroids to take the count from)")
        c0 = resolve_init(x, int(kk), params.init, weights=w,
                          backend=_init_backend(params.backend), draws=draws,
                          generator=generator)
    elif init_centroids is None:
        raise ValueError('init="given" needs init_centroids')
    else:
        c0 = as_float(init_centroids, dev)
    engine = engines.get_engine(params.backend)
    final_c, total, iters, conv = engine.solve(
        x, c0, w, max_iters=params.max_iters, tol=params.tol,
        reseed_empty=params.reseed_empty, prune=params.prune)
    cnt = metrics.masked_count(w, x.shape[0], dev)
    return KMeansResult(final_c, total, _asse(total, cnt), iters, conv)


def kmeans_batched(subsets, masks, init_centroids,
                   params: KMeansParams = KMeansParams(), *,
                   device=None) -> KMeansResult:
    """A stack of complete k-means solves — ``(M, S, d)`` + ``(M, S)`` with
    the same ``(k, d)`` seeds for every subset, as in the paper.

    Empty (all-padding) subsets keep the reference's contract: ASSE = +inf,
    so they never win the min-ASSE merge.  Seeding is the entry points'
    (``kmeans``, ``ipkmeans``): ``params.init`` must be ``"given"``.  The
    centroids come back in the seeds' dtype.
    """
    check_params(params)
    if params.init != "given":
        raise ValueError(f"kmeans_batched requires init='given' (got "
                         f"{params.init!r}): resolve the seeds at the entry "
                         f"point (kmeans / ipkmeans)")
    dev = resolve_device(device)
    x = as_float(subsets, dev)
    c0 = as_float(init_centroids, dev)
    w = None if masks is None else as_weights(masks, dev)
    engine = engines.get_engine(params.backend)
    final_c, total, iters, conv = engine.solve_batched(
        x, c0, w, max_iters=params.max_iters, tol=params.tol,
        reseed_empty=params.reseed_empty, prune=params.prune)
    if w is None:
        cnt = torch.full((x.shape[0],), float(x.shape[1]), device=dev)
    else:
        cnt = torch.sum(w, dim=1)
    return KMeansResult(final_c, total, _asse(total, cnt), iters, conv)
