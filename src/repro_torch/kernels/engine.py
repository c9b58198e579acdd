"""LloydEngine: the one place backend selection happens.

Counterpart of ``repro.kernels.engine``.  The reference's engines work on
one subset and a stack is a ``jax.vmap`` of them; here the lane dimension is
written out, so every engine method takes a stack, ``points (M,S,d)``,
``centroids (M,k,d)``, ``weights (M,S)`` or ``None``, and an optional
``lanes (L,)`` int32 naming the lanes to work on (all of them when
``None``).  Outputs have one row per listed lane.

  * ``step(points, centroids, weights, lanes) -> (sums (L,k,d), counts
    (L,k), sse (L,))`` — one Lloyd pass.
  * ``assign(points, centroids, lanes) -> (labels (L,S) i32, mind (L,S))``.
  * ``sse(points, centroids, weights, lanes) -> (L,)``.
  * ``solve_batched(subsets, init, weights, ...) -> (centroids (M,k,d), sse
    (M,), iters (M,) i32, converged (M,) bool)`` — the reference's vmap of a
    ``lax.while_loop``, as a host loop over launches on the active lanes.
  * ``solve(points, init, weights, ...)`` — one subset, a stack of one.

Engines registered: ``eager`` (the reference's ``jnp`` role: plain PyTorch
oracles), ``twopass`` (the reference's ``pallas`` role: the assign kernel,
then the centroid-update kernel, two launches per Lloyd trip), ``fused``
(the hand-written fused kernel, one launch per Lloyd trip), ``resident``
(the whole-solve kernel, one launch per subset) and ``batched`` (the
whole-solve kernel, one launch per stack).  ``tuned`` raises
``NotImplementedError`` naming the slice that ports it, and the reference's
``pallas`` names the port's ``twopass``.
``prune="bounds"`` is accepted everywhere: the whole-solve kernels skip
score passes with it, and the per-step engines run their exact loop, which
gives the same result.  Past the whole-solve kernel's shared memory,
``resident`` and ``batched`` run the fused engine's per-step loop instead,
as the reference's do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.resident import check_prune

_REGISTRY: dict[str, "LloydEngine"] = {}

# engine names of the reference the port does not register: why, by name
# (the ``jnp``/``pallas`` roles are the port's ``eager``/``twopass``)
LATER = {
    "tuned": "is not ported yet: it comes in a later slice (kernel tuning)",
    "pallas": "is the reference's name: the port's engine for that role is "
              "'twopass' (convert.BACKEND_NAMES maps it)",
}


def register(engine: "LloydEngine") -> "LloydEngine":
    _REGISTRY[engine.name] = engine
    return engine


def get_engine(name: str) -> "LloydEngine":
    if name in LATER:
        raise NotImplementedError(f"backend {name!r} {LATER[name]}")
    if name not in _REGISTRY:
        raise ValueError(f"unknown backend: {name!r} "
                         f"(expected one of {tuple(_REGISTRY)})")
    return _REGISTRY[name]


def available() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def _all_lanes(points, lanes):
    if lanes is None:
        return torch.arange(points.shape[0], dtype=torch.int32,
                            device=points.device)
    return lanes


def reseed_empty_clusters(engine: "LloydEngine", points, weights,
                          centroids, counts, lanes=None):
    """Re-seed zero-count centroids at the farthest in-subset points.

    ``centroids`` is the whole ``(M,k,d)`` stack; ``counts (L,k)`` has one row
    per listed lane.  The ``e``-th empty cluster of a lane takes its
    ``e``-th farthest point (``ref.reseed_rows``).  Only lanes with an empty
    cluster are scored, one assign launch for all of them; the reference's
    ``lax.cond`` is a select under vmap, so lanes without one keep their
    centroids either way.  The candidate budget is ``min(k, S)`` with ``S``
    the padded capacity; padded rows drop out through their ``-inf`` score.

    Updates ``centroids`` in place (the stack is the solve's own state) and
    returns it.
    """
    lanes = _all_lanes(points, lanes)
    k = centroids.shape[1]
    empty = counts <= 0.0
    need = torch.any(empty, dim=1)
    if not bool(torch.any(need)):
        return centroids
    sub = lanes[need]
    emp = empty[need]
    kk = min(k, points.shape[1])
    _, mind = engine.assign(points, centroids, sub)
    sel = sub.long()
    w = (torch.ones_like(mind) if weights is None else weights[sel])
    score = torch.where(w > 0.0, mind, -torch.inf)
    take, rows = ref.reseed_rows(score, emp, kk)
    picks = points[sel.unsqueeze(1), rows]                       # (Ln,k,d)
    centroids[sel] = torch.where(take.unsqueeze(-1), picks, centroids[sel])
    return centroids


class LloydEngine:
    """Base engine: subclasses fill in ``step``/``assign``; ``solve``,
    ``solve_batched`` and ``sse`` are built on them."""

    name: str = "?"

    def step(self, points, centroids, weights=None, lanes=None):
        raise NotImplementedError

    def assign(self, points, centroids, lanes=None):
        raise NotImplementedError

    def sse(self, points, centroids, weights=None, lanes=None):
        """Weighted SSE per lane; default: one ``assign`` pass."""
        lanes = _all_lanes(points, lanes)
        _, mind = self.assign(points, centroids, lanes)
        if weights is None:
            return torch.sum(mind, dim=1)
        return torch.sum(weights[lanes.long()].float() * mind, dim=1)

    def solve(self, points, init_centroids, weights=None, *,
              max_iters: int, tol: float, reseed_empty: bool = False,
              prune: str = "none"):
        """Lloyd to convergence on one subset -> (centroids (k,d), sse (),
        iters () i32, converged () bool)."""
        c, s, it, conv = self.solve_batched(
            points.unsqueeze(0), init_centroids,
            None if weights is None else weights.unsqueeze(0),
            max_iters=max_iters, tol=tol, reseed_empty=reseed_empty,
            prune=prune)
        return c[0], s[0], it[0], conv[0]

    def solve_batched(self, subsets, init_centroids, weights=None, *,
                      max_iters: int, tol: float, reseed_empty: bool = False,
                      prune: str = "none"):
        """A stack of solves: (M,S,d),(k,d)[,(M,S)] -> (centroids (M,k,d),
        sse (M,), iters (M,) i32, converged (M,) bool).

        The host loop ``lloyd_loop``, then one more pass per lane for the
        SSE.  ``prune`` is validated only: a host loop has no block state to
        skip, and the exact loop IS the pruned result.
        """
        check_prune(prune)
        c, iters, shift = self.lloyd_loop(
            subsets, init_centroids, weights, max_iters=max_iters, tol=tol,
            reseed_empty=reseed_empty)
        return c, self.sse(subsets, c, weights), iters, shift <= tol

    def lloyd_loop(self, subsets, init_centroids, weights=None, *,
                   max_iters: int, tol: float, reseed_empty: bool = False):
        """Lloyd trips of ``step`` to convergence: (M,S,d),(k,d) or
        (M,k,d)[,(M,S)] -> (centroids (M,k,d), iters (M,) i32, last shift
        (M,)).

        The reference vmaps a ``lax.while_loop``; a lane there keeps its
        state once ``not (it < max_iters and shift > tol)``.  Here each trip
        of a host loop runs one batched ``step`` over the lanes still
        active, ``divide_or_keep``, the reseed of lanes with an empty
        cluster, and the per-lane ``centroid_shift``; frozen lanes are not
        touched again, so they keep their centroids and ``iters`` exactly.
        One host sync per trip (the active-lane list).  It always steps,
        so on ``resident`` and ``batched`` it drives the fused ``step``:
        this is their fallback loop and PKMeans's loop (a stack of one).
        """
        from repro_torch.core.metrics import centroid_shift
        m = subsets.shape[0]
        dev = subsets.device
        k, d = init_centroids.shape[-2:]
        # the solve's own state, updated in place: never the caller's seeds
        c = torch.empty((m, k, d), dtype=torch.float32, device=dev)
        c.copy_(init_centroids)
        iters = torch.zeros(m, dtype=torch.int32, device=dev)
        shift = torch.full((m,), torch.inf, dtype=torch.float32, device=dev)
        while True:
            active = (iters < max_iters) & (shift > tol)
            lanes = torch.nonzero(active).flatten().to(torch.int32)
            if lanes.numel() == 0:
                break
            sel = lanes.long()
            sums, counts, _ = self.step(subsets, c, weights, lanes)
            old = c[sel]
            c[sel] = ref.divide_or_keep(sums, counts, old)
            if reseed_empty:
                reseed_empty_clusters(self, subsets, weights, c, counts,
                                      lanes)
            shift[sel] = centroid_shift(c[sel], old)
            iters[sel] += 1
        return c, iters, shift


class EagerEngine(LloydEngine):
    """Plain PyTorch oracles (the reference's ``jnp`` engine): ground truth
    for every other engine."""

    name = "eager"

    def step(self, points, centroids, weights=None, lanes=None):
        sel = _all_lanes(points, lanes).long()
        w = None if weights is None else weights[sel]
        return ref.lloyd_step_ref(points[sel], centroids[sel], w)

    def assign(self, points, centroids, lanes=None):
        sel = _all_lanes(points, lanes).long()
        return ref.assign_ref(points[sel], centroids[sel])


class TwoPassEngine(LloydEngine):
    """The assign kernel, then the centroid-update kernel on its labels (the
    reference's ``pallas`` engine): the points are read twice per trip, with
    an (L, S) label and distance round trip between the launches; use it
    when the per-point labels are the product.  Its labels and sums are the
    fused pass's bit for bit; only the SSE is summed otherwise."""

    name = "twopass"

    def step(self, points, centroids, weights=None, lanes=None):
        from repro_torch.kernels import ops
        lanes = _all_lanes(points, lanes)
        if weights is None:
            weights = torch.ones(points.shape[:2], dtype=torch.float32,
                                 device=points.device)
        labels, mind = ops.assign(points, centroids, lanes=lanes)
        sums, counts = ops.centroid_update(points, labels, weights,
                                           centroids.shape[1], lanes=lanes)
        sse = torch.sum(weights[lanes.long()] * mind, dim=1)
        return sums, counts, sse

    def assign(self, points, centroids, lanes=None):
        from repro_torch.kernels import ops
        return ops.assign(points, centroids, lanes=lanes)


class FusedEngine(LloydEngine):
    """The fused kernel: one pass over the points per iteration, one launch
    per iteration for the whole stack."""

    name = "fused"

    def step(self, points, centroids, weights=None, lanes=None):
        from repro_torch.kernels import ops
        return ops.lloyd_step_fused(points, centroids, weights, lanes=lanes)

    def assign(self, points, centroids, lanes=None):
        from repro_torch.kernels import ops
        return ops.lloyd_assign_fused(points, centroids, lanes=lanes)

    def sse(self, points, centroids, weights=None, lanes=None):
        # step IS one pass here: its sse output is the cheapest scoring
        return self.step(points, centroids, weights, lanes)[2]


class ResidentEngine(FusedEngine):
    """The whole-solve kernel, one launch per subset: the convergence loop,
    the reseed of empty clusters and the final scoring pass run on the card
    with no host between trips.  ``step``/``assign``/``sse`` are the fused
    engine's.  A stack is one solve per lane (the reference's vmap of the
    resident solve).  A shape beyond the whole-solve kernel's shared memory
    (``resident.resident_feasible``; for example k = 20,000 at any S) runs
    the fused engine's per-step host loop instead, as the reference falls
    back: the fused kernel on a card, its plain version on the CPU.  Past
    the fused kernel's own limit its wrapper raises."""

    name = "resident"

    def _fused_loop(self, subsets, init_centroids, weights, **kw):
        return LloydEngine.solve_batched(self, subsets, init_centroids,
                                         weights, **kw)

    def solve(self, points, init_centroids, weights=None, *,
              max_iters: int, tol: float, reseed_empty: bool = False,
              prune: str = "none"):
        from repro_torch.kernels import ops, resident
        check_prune(prune)
        kw = dict(max_iters=max_iters, tol=tol, reseed_empty=reseed_empty,
                  prune=prune)
        n, d = points.shape
        if not resident.resident_feasible(n, d, init_centroids.shape[0],
                                          prune=prune):
            c, s, it, conv = self._fused_loop(
                points.unsqueeze(0), init_centroids,
                None if weights is None else weights.unsqueeze(0), **kw)
            return c[0], s[0], it[0], conv[0]
        return ops.lloyd_solve_resident(points, init_centroids, weights,
                                        **kw)

    def solve_batched(self, subsets, init_centroids, weights=None, *,
                      max_iters: int, tol: float, reseed_empty: bool = False,
                      prune: str = "none"):
        outs = [self.solve(subsets[i], init_centroids,
                           None if weights is None else weights[i],
                           max_iters=max_iters, tol=tol,
                           reseed_empty=reseed_empty, prune=prune)
                for i in range(subsets.shape[0])]
        return tuple(torch.stack(parts) for parts in zip(*outs))


class BatchedEngine(ResidentEngine):
    """The whole-solve kernel over a whole S2 stack in ONE launch, one
    thread-block cluster per lane (``batch_resident.cluster_plan``); each
    lane is bit-for-bit the ``resident`` solve.  A shape beyond the kernel's
    shared memory (``batch_resident.batched_feasible``) runs the fused
    engine's per-step host loop over the whole stack instead, as the
    reference falls back.  Single solves (``solve``) are the resident
    engine's."""

    name = "batched"

    def solve_batched(self, subsets, init_centroids, weights=None, *,
                      max_iters: int, tol: float, reseed_empty: bool = False,
                      prune: str = "none"):
        from repro_torch.kernels import batch_resident, ops
        check_prune(prune)
        kw = dict(max_iters=max_iters, tol=tol, reseed_empty=reseed_empty,
                  prune=prune)
        _, s, d = subsets.shape
        if not batch_resident.batched_feasible(s, d, init_centroids.shape[0],
                                               prune=prune):
            return self._fused_loop(subsets, init_centroids, weights, **kw)
        return ops.lloyd_solve_batched(subsets, init_centroids, weights,
                                       **kw)


register(EagerEngine())
register(TwoPassEngine())
register(FusedEngine())
register(ResidentEngine())
register(BatchedEngine())
