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
    ``lax.while_loop``, as a host loop over launches on the active lanes;
    ``init`` is the shared ``(k,d)`` seeds or ``(M,k,d)``, one block a lane,
    and each lane is bit for bit its ``solve`` from its own seeds.
  * ``solve(points, init, weights, ...)`` — one subset, a stack of one.
  * ``update_minibatch(points, centroids, counts, weights)`` — one
    mini-batch refresh of one subset: ``step`` on a stack of one lane, then
    ``ref.minibatch_merge``.

Engines registered: ``eager`` (the reference's ``jnp`` role: plain PyTorch
oracles), ``twopass`` (the reference's ``pallas`` role: the assign kernel,
then the centroid-update kernel, two launches per Lloyd trip), ``fused``
(the hand-written fused kernel, one launch per Lloyd trip), ``resident``
(the whole-solve kernel, one launch per subset), ``batched`` (the
whole-solve kernel, one launch per stack) and, from ``kernels/tuning.py``,
``tuned`` (``resident`` with the tuning cache's spec).  The reference's
``pallas`` raises ``NotImplementedError`` naming the port's ``twopass``.
Points may be float32 or bfloat16, and the seeds' dtype is the carry
dtype, as in the reference: the per-step loop keeps its state in float32
but rounds each trip's centroids and reseed picks to the seeds' dtype
before the shift, the whole-solve kernels do the same on the card, and
``solve``/``solve_batched`` return the seeds' dtype.
``resolve_spec`` is the hook through which a ``KernelSpec`` reaches the
kernels (``None``: each kernel's module default); the ``tuned`` engine
overrides it with the tuning cache's lookup.
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
                          centroids, counts, lanes=None, carry=None):
    """Re-seed zero-count centroids at the farthest in-subset points.

    ``centroids`` is the whole ``(M,k,d)`` stack; ``counts (L,k)`` has one row
    per listed lane.  The ``e``-th empty cluster of a lane takes its
    ``e``-th farthest point (``ref.reseed_rows``), rounded through the
    ``carry`` dtype when one is given.  Only lanes with an empty
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
    if carry is not None:
        picks = picks.to(carry)
    centroids[sel] = torch.where(take.unsqueeze(-1), picks.float(),
                                 centroids[sel])
    return centroids


class LloydEngine:
    """Base engine: subclasses fill in ``step``/``assign``; ``solve``,
    ``solve_batched`` and ``sse`` are built on them."""

    name: str = "?"

    def step(self, points, centroids, weights=None, lanes=None):
        raise NotImplementedError

    def assign(self, points, centroids, lanes=None):
        raise NotImplementedError

    def resolve_spec(self, points, centroids):
        """The ``KernelSpec`` for this launch shape, or ``None`` for each
        kernel's module default (``specs.DEFAULT_SPEC`` and
        ``UPDATE_DEFAULT_SPEC``).  ``step`` and ``assign`` pass it to the
        kernels; the ``tuned`` engine overrides it."""
        return None

    def update_minibatch(self, points, centroids, counts, weights=None):
        """One Sculley mini-batch refresh of one subset: ``points (n,d)``,
        ``centroids (k,d)``, ``counts (k,)`` f32, ``weights (n,)`` or
        ``None`` -> ``(centroids (k,d) in the centroids' dtype, counts (k,)
        f32, sse () f32)``.

        ``step`` on a stack of one lane gives the batch's sums, counts and
        SSE against the incoming centroids; ``ref.minibatch_merge`` folds
        them into the running state.  So ``eager`` runs the oracle
        (``ref.minibatch_update_ref``'s arithmetic), ``twopass`` its assign
        and update kernels, and the fused-step engines one fused launch."""
        sums, bcounts, sse = self.step(
            points.unsqueeze(0), centroids.unsqueeze(0),
            None if weights is None else weights.unsqueeze(0))
        new_c, new_counts = ref.minibatch_merge(centroids, counts, sums[0],
                                                bcounts[0])
        return new_c.to(centroids.dtype), new_counts, sse[0]

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
        """Lloyd to convergence on one subset -> (centroids (k,d) in the
        seeds' dtype, sse (), iters () i32, converged () bool)."""
        c, s, it, conv = self.solve_batched(
            points.unsqueeze(0), init_centroids,
            None if weights is None else weights.unsqueeze(0),
            max_iters=max_iters, tol=tol, reseed_empty=reseed_empty,
            prune=prune)
        return c[0], s[0], it[0], conv[0]

    def solve_batched(self, subsets, init_centroids, weights=None, *,
                      max_iters: int, tol: float, reseed_empty: bool = False,
                      prune: str = "none"):
        """A stack of solves: (M,S,d), the seeds (k,d) shared or (M,k,d) a
        lane each[, (M,S)] -> (centroids (M,k,d) in the seeds' dtype, sse
        (M,), iters (M,) i32, converged (M,) bool).

        The host loop ``lloyd_loop``, then one more pass per lane for the
        SSE.  ``prune`` is validated only: a host loop has no block state to
        skip, and the exact loop IS the pruned result.
        """
        check_prune(prune)
        c, iters, conv = self.lloyd_loop(
            subsets, init_centroids, weights, max_iters=max_iters, tol=tol,
            reseed_empty=reseed_empty)
        return (c.to(init_centroids.dtype), self.sse(subsets, c, weights),
                iters, conv)

    def lloyd_loop(self, subsets, init_centroids, weights=None, *,
                   max_iters: int, tol: float, reseed_empty: bool = False,
                   reduce=None):
        """Lloyd trips of ``step`` to convergence: (M,S,d),(k,d) or
        (M,k,d)[,(M,S)] -> (centroids (M,k,d), iters (M,) i32, converged
        (M,) bool).

        The reference vmaps a ``lax.while_loop``; a lane there keeps its
        state once ``not (it < max_iters and shift > tol)``.  Here each trip
        of a host loop runs one batched ``step`` over the lanes still
        active, ``divide_or_keep``, the reseed of lanes with an empty
        cluster, and the per-lane ``centroid_shift``; frozen lanes are not
        touched again, so they keep their centroids and ``iters`` exactly.
        One host sync per trip (the active-lane list).  It always steps,
        so on ``resident`` and ``batched`` it drives the fused ``step``:
        this is their fallback loop and PKMeans's loop (a stack of one).

        The state is float32, but each trip's divided centroids and reseed
        picks are rounded to the seeds' dtype (the carry dtype) before the
        shift, as the reference's loop casts them back to it; bfloat16
        points are widened once, exactly.

        ``reduce(sums, counts, sel) -> (sums, counts, stop)`` turns each
        trip's statistics of the active lanes ``sel`` (int64) into the ones
        the divide sees, and gives the active lanes' stop threshold from
        then on (``None``: ``tol``).  The distributed solvers pass it: the
        all-reduce over the ranks of ``pkmeans_sharded``, and the exact or
        int8 error-feedback reduction over the pods of the cross-pod S2,
        whose threshold widens to the quantization's noise floor.
        """
        from repro_torch.core.metrics import centroid_shift
        m = subsets.shape[0]
        dev = subsets.device
        k, d = init_centroids.shape[-2:]
        carry = init_centroids.dtype
        subsets = subsets.float()
        # the solve's own state, updated in place: never the caller's seeds
        c = torch.empty((m, k, d), dtype=torch.float32, device=dev)
        c.copy_(init_centroids)
        iters = torch.zeros(m, dtype=torch.int32, device=dev)
        shift = torch.full((m,), torch.inf, dtype=torch.float32, device=dev)
        stop = torch.full((m,), tol, dtype=torch.float32, device=dev)
        while True:
            active = (iters < max_iters) & (shift > stop)
            lanes = torch.nonzero(active).flatten().to(torch.int32)
            if lanes.numel() == 0:
                break
            sel = lanes.long()
            sums, counts, _ = self.step(subsets, c, weights, lanes)
            if reduce is not None:
                sums, counts, lane_stop = reduce(sums, counts, sel)
                if lane_stop is not None:
                    stop[sel] = lane_stop
            old = c[sel]
            c[sel] = ref.divide_or_keep(sums, counts, old).to(carry).float()
            if reseed_empty:
                reseed_empty_clusters(self, subsets, weights, c, counts,
                                      lanes, carry)
            shift[sel] = centroid_shift(c[sel], old)
            iters[sel] += 1
        return c, iters, shift <= stop


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
        # as the reference: the hook's spec, when it gives one, applies to
        # both launches
        spec = self.resolve_spec(points, centroids)
        labels, mind = ops.assign(points, centroids, lanes=lanes, spec=spec)
        sums, counts = ops.centroid_update(points, labels, weights,
                                           centroids.shape[1], lanes=lanes,
                                           spec=spec)
        sse = torch.sum(weights[lanes.long()].float() * mind, dim=1)
        return sums, counts, sse

    def assign(self, points, centroids, lanes=None):
        from repro_torch.kernels import ops
        return ops.assign(points, centroids, lanes=lanes,
                          spec=self.resolve_spec(points, centroids))


class FusedEngine(LloydEngine):
    """The fused kernel: one pass over the points per iteration, one launch
    per iteration for the whole stack."""

    name = "fused"

    def step(self, points, centroids, weights=None, lanes=None):
        from repro_torch.kernels import ops
        return ops.lloyd_step_fused(points, centroids, weights, lanes=lanes,
                                    spec=self.resolve_spec(points, centroids))

    def assign(self, points, centroids, lanes=None):
        from repro_torch.kernels import ops
        return ops.lloyd_assign_fused(
            points, centroids, lanes=lanes,
            spec=self.resolve_spec(points, centroids))

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
                                          prune=prune, device=points.device):
            c, s, it, conv = self._fused_loop(
                points.unsqueeze(0), init_centroids,
                None if weights is None else weights.unsqueeze(0), **kw)
            return c[0], s[0], it[0], conv[0]
        return ops.lloyd_solve_resident(points, init_centroids, weights,
                                        **kw)

    def solve_batched(self, subsets, init_centroids, weights=None, *,
                      max_iters: int, tol: float, reseed_empty: bool = False,
                      prune: str = "none"):
        per_lane = init_centroids.dim() == 3
        outs = [self.solve(subsets[i],
                           init_centroids[i] if per_lane else init_centroids,
                           None if weights is None else weights[i],
                           max_iters=max_iters, tol=tol,
                           reseed_empty=reseed_empty, prune=prune)
                for i in range(subsets.shape[0])]
        return tuple(torch.stack(parts) for parts in zip(*outs))


class BatchedEngine(ResidentEngine):
    """The whole-solve kernel over a whole S2 stack, one thread-block
    cluster per lane (``batch_resident.cluster_plan``), from shared or
    per-lane seeds; each lane is bit-for-bit the ``resident`` solve.  The
    stack runs as ceil(M / t) launches of t lanes (``resolve_group_size``:
    the tuning cache's ``group_t``, else t = M, one launch), with the same
    result at every t.  A shape beyond the kernel's shared memory
    (``batch_resident.batched_feasible``) runs the fused engine's per-step
    host loop over the whole stack instead, as the reference falls back.
    Single solves (``solve``) are the resident engine's."""

    name = "batched"

    def resolve_group_size(self, m: int, s: int, d: int, k: int, dtype,
                           prune: str = "none", device=None) -> int:
        """Lanes a launch for an (M, S, d, k) stack, 0 when one lane does
        not fit (the fused fallback).  The cap is
        ``batch_resident.batched_group_size`` (M, where one lane fits); the
        tuning cache's ``group_t`` for the stack (``tuning.lookup_group_t``,
        the ``|m<bucket>`` key on ``device``'s kind) is clamped to it, and
        without an entry the whole stack is one launch."""
        from repro_torch.kernels import batch_resident
        from repro_torch.kernels import tuning    # deferred: tuning imports us
        cap = batch_resident.batched_group_size(m, s, d, k, prune,
                                                device=device)
        if cap <= 0:
            return 0
        cached = tuning.lookup_group_t(s, d, k, m, dtype, device=device)
        return min(cached, cap) if cached else cap

    def solve_batched(self, subsets, init_centroids, weights=None, *,
                      max_iters: int, tol: float, reseed_empty: bool = False,
                      prune: str = "none"):
        from repro_torch.kernels import batch_resident, ops
        check_prune(prune)
        kw = dict(max_iters=max_iters, tol=tol, reseed_empty=reseed_empty,
                  prune=prune)
        m, s, d = subsets.shape
        k = init_centroids.shape[-2]
        if not batch_resident.batched_feasible(s, d, k, prune=prune,
                                               device=subsets.device):
            return self._fused_loop(subsets, init_centroids, weights, **kw)
        t = self.resolve_group_size(m, s, d, k, subsets.dtype, prune=prune,
                                    device=subsets.device)
        # an empty stack (t = 0) launches nothing either way
        return ops.lloyd_solve_batched(subsets, init_centroids, weights,
                                       group_t=t or None, **kw)


register(EagerEngine())
register(TwoPassEngine())
register(FusedEngine())
register(ResidentEngine())
register(BatchedEngine())
