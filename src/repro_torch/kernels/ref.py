"""Plain PyTorch oracles, the counterpart of ``repro.kernels.ref``.

Ground truth for the port's kernels and the ``eager`` engine.  Every function
takes one subset (``(n, d)`` points) like the reference, or a stack of them
with the lanes as leading dimensions (``(M, n, d)``).
"""
from __future__ import annotations

import torch

# elements of one score block of a plain version: larger inputs go in
# chunks, of rows (``by_row_chunks``) or of lanes (the kernels' plain
# versions)
PLAIN_SCORE_ELEMS = 1 << 26


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


def by_row_chunks(fn, points: torch.Tensor, k: int, *args) -> tuple:
    """``fn(points, *args)`` over row chunks of ``points (..., n, d)``, each
    small enough that its ``(..., rows, k)`` scores stay within
    PLAIN_SCORE_ELEMS; ``fn`` returns a tuple of ``(..., rows)`` tensors,
    joined here along the rows."""
    rows = max(1, PLAIN_SCORE_ELEMS // max(1, points.shape[:-2].numel() * k))
    if points.shape[-2] <= rows:
        return tuple(fn(points, *args))
    parts = [fn(points[..., lo:lo + rows, :], *args)
             for lo in range(0, points.shape[-2], rows)]
    return tuple(torch.cat(t, dim=-1) for t in zip(*parts))


def row_dots(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Dot products of ``x (..., n, d)`` with ``c (..., k, d)``, float32
    operands -> ``(..., n, k)``.

    On the CPU each is a chain of fused multiply-adds over d in index
    order, one float32 rounding a term (the product is exact in float64).
    That is the order of the CPU matrix product's kernel, bit for bit, but
    a matrix product of a few rows takes another kernel and another order,
    so a bucket's pad rows would move the real rows' bits
    (``core/serve.py``); here a row's products depend on that row alone.
    On a card it is a matrix product: nothing there pads a plain
    version."""
    if x.device.type != "cpu":
        return x @ c.transpose(-1, -2)
    xd, cd = x.double(), c.double()
    acc = (xd[..., 0:1] * cd[..., 0].unsqueeze(-2)).float()
    for j in range(1, x.shape[-1]):
        acc = (acc + xd[..., j:j + 1] * cd[..., j].unsqueeze(-2)).float()
    return acc


# ---- bfloat16 (KernelSpec.acc_dtype="bfloat16") ----
# The reference's bf16 kernels round their operands, each dot product over
# the whole of d, and each score ``cn - 2 x.c`` to bfloat16, and round each
# cluster's weighted partial sum over a block of ``bn`` rows.  The plain
# versions below compute each product in float32 on bfloat16-valued
# operands and round it once: never a bfloat16 ``matmul``, whose reduction
# cuBLAS and oneDNN may round differently.


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bfloat16, as float32 values."""
    return t.to(torch.bfloat16).float()


def bf16_scores(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The bfloat16 score of ``x (..., n, d)`` against ``c (..., k, d)``
    (either dtype) -> ``(..., n, k)`` float32: the norms of ``c`` as given,
    summed in float32 and rounded; the product of the rounded operands in
    float32, each dot rounded; ``cn - 2 dot`` rounded."""
    cn = round_bf16(torch.sum(c.float() * c.float(), dim=-1))
    dot = round_bf16(row_dots(round_bf16(x), round_bf16(c)))
    return round_bf16(cn.unsqueeze(-2) - 2.0 * dot)


def bf16_block_sums(x: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
                    k: int, bn: int):
    """The bfloat16 accumulate: ``x (L,S,d)``, ``labels (L,S)``, ``w (L,S)``
    -> ``(sums (L,k,d), counts (L,k))`` float32.  Points and weights are
    rounded to bfloat16; each cluster's weighted sum over a block of ``bn``
    rows (rows ``[b bn, (b + 1) bn)``) is taken in float32 and rounded to
    bfloat16, and the partials are added in float32 in block order; the
    counts are the blocks' float32 sums added in block order.  A label
    outside ``[0, k)`` contributes nothing."""
    n_l, s, d = x.shape
    xs, ws = round_bf16(x), round_bf16(w)
    sums = torch.zeros((n_l, k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((n_l, k), dtype=torch.float32, device=x.device)
    col = torch.arange(k, device=x.device)
    nb = -(-s // bn)
    step = max(1, PLAIN_SCORE_ELEMS // max(1, n_l * bn * k))
    for b0 in range(0, nb, step):
        lo, hi = b0 * bn, min(s, (b0 + step) * bn)
        g = -(-(hi - lo) // bn)
        pad = g * bn - (hi - lo)
        oh = (labels[:, lo:hi].long().unsqueeze(-1) == col).float()
        oh = oh * ws[:, lo:hi].unsqueeze(-1)
        oh = torch.nn.functional.pad(oh, (0, 0, 0, pad)).view(n_l, g, bn, k)
        xb = torch.nn.functional.pad(xs[:, lo:hi], (0, 0, 0, pad))
        part = round_bf16(oh.transpose(-1, -2) @ xb.view(n_l, g, bn, d))
        cnt = torch.sum(oh, dim=2)
        for j in range(g):
            sums = sums + part[:, j]
            counts = counts + cnt[:, j]
    return sums, counts


def assign_ref(points: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment: (n,d),(k,d) -> labels (n,) i32, min sq
    distances (n,) f32.  Ties break to the lowest index (``torch.argmin``
    returns the first minimum).  Large inputs go in row chunks, so that the
    (n, k) distances never exist at once."""
    return by_row_chunks(_assign_block, points, centroids.shape[-2],
                         centroids)


def _assign_block(points: torch.Tensor, centroids: torch.Tensor):
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
    f32, as the reference's one-hot product.  A label outside ``[0, k)``
    has an all-zero one-hot row, as in ``jax.nn.one_hot``, so its point
    contributes nothing."""
    col = torch.arange(k, device=labels.device)
    onehot = (labels.long().unsqueeze(-1) == col).float()
    onehot = onehot * weights.float().unsqueeze(-1)
    sums = onehot.transpose(-1, -2) @ points.float()
    return sums, torch.sum(onehot, dim=-2)


def init_sweep_ref(points: torch.Tensor, cands: torch.Tensor,
                   old_mind: torch.Tensor, uniforms: torch.Tensor, psi_prev,
                   *, ell: float, cand_valid: torch.Tensor | None = None,
                   weights: torch.Tensor | None = None):
    """One k-means|| round sweep: (n,d),(c,d),(n,),(n,),() -> (new_mind (n,)
    f32, sampled (n,) bool, psi () f32).

    The reference's expressions in its order: ``||c||^2 - 2 x.c`` minimised
    over the candidates (invalid ones carry +inf norms and never win; with
    none the minimum is +inf), ``||x||^2`` added back and clamped at 0,
    folded into ``old_mind``; the draw ``u * psi_prev < ell * new_mind``
    gated on positive weight and positive ``psi_prev``; ``psi = sum(w *
    new_mind)``.  The scores are taken in row chunks so that the ``(n, c)``
    block never exists at once.
    """
    x = points.float()
    c = cands.float()
    n = x.shape[0]
    norms = torch.sum(c * c, dim=-1)
    if cand_valid is not None:
        norms = torch.where(cand_valid, norms, torch.inf)
    best = torch.full((n,), torch.inf, dtype=torch.float32, device=x.device)
    if n and c.shape[0]:
        best, = by_row_chunks(
            lambda xs: (torch.amin(norms - 2.0 * (xs @ c.T), dim=-1),), x,
            c.shape[0])
    cand_min = torch.clamp(best + torch.sum(x * x, dim=-1), min=0.0)
    mind = torch.minimum(old_mind.float(), cand_min)
    w = _as_weights(x, weights)
    pp = torch.as_tensor(psi_prev, dtype=torch.float32, device=x.device)
    take = (uniforms.float() * pp < ell * mind) & (w > 0.0) & (pp > 0.0)
    return mind, take, torch.sum(w * mind)


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


def minibatch_merge(centroids: torch.Tensor, counts: torch.Tensor,
                    sums: torch.Tensor, bcounts: torch.Tensor):
    """Fold one batch's ``(sums (k,d), bcounts (k,))`` into the running
    ``(centroids (k,d), counts (k,))`` -> ``(new_centroids (k,d) f32,
    new_counts (k,) f32)``.

    Sculley's sequential mini-batch update with ``eta = w / count`` and
    the assignments fixed at the batch's start telescopes to the running
    mean ``(counts c + sums) / (counts + bcounts)``, computed here in
    float32 in that order.  A centre the batch never touched keeps its
    coordinates bit for bit (a ``where``, not a ``c n / n`` round trip).
    The one definition the oracle below and ``LloydEngine.update_minibatch``
    share."""
    c = centroids.float()
    counts = counts.float()
    new_counts = counts + bcounts
    new_c = torch.where(bcounts.unsqueeze(-1) > 0.0,
                        (counts.unsqueeze(-1) * c + sums)
                        / torch.clamp(new_counts.unsqueeze(-1), min=1.0), c)
    return new_c, new_counts


def minibatch_update_ref(points: torch.Tensor, centroids: torch.Tensor,
                         counts: torch.Tensor,
                         weights: torch.Tensor | None = None):
    """Oracle of one mini-batch refresh: ``(n,d), (k,d), (k,)[, (n,)]`` ->
    ``(new_centroids (k,d) f32, new_counts (k,) f32, sse () f32)``.  One
    assign pass, the weighted segment sums, then :func:`minibatch_merge`;
    ``sse`` scores the batch against the incoming centroids."""
    w = _as_weights(points, weights)
    labels, mind = assign_ref(points, centroids)
    sums, bcounts = centroid_update_ref(points, labels, w,
                                        centroids.shape[-2])
    new_c, new_counts = minibatch_merge(centroids, counts, sums, bcounts)
    return new_c, new_counts, torch.sum(w * mind)


# ---- bound-gated block skipping (prune="bounds") ----
# Hamerly-style: a block of points whose stored reassignment margin (the
# worst d2 - d1 over the block, in distance units) exceeds twice the
# centroid drift accumulated since the block was last scored keeps every
# assignment, so its score pass can be skipped.  The whole-solve kernel and
# its plain version share these three definitions.


def bound_second_best(scores: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Min score over the non-assigned centroids: (..., k), (...) -> (...).
    +inf when k == 1: a single centroid can never steal an assignment."""
    col = torch.arange(scores.shape[-1], device=scores.device)
    masked = torch.where(col == labels.unsqueeze(-1).long(), torch.inf,
                         scores)
    return torch.amin(masked, dim=-1)


def bound_gap(best_sq: torch.Tensor, second_sq: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Per-point reassignment margin d2 - d1 from the squared best and
    second-best distances; +inf for invalid (padding) rows, so they never
    constrain a block's margin."""
    gap = (torch.sqrt(torch.clamp(second_sq, min=0.0))
           - torch.sqrt(torch.clamp(best_sq, min=0.0)))
    return torch.where(valid, gap, torch.inf)


def bounds_may_skip(margin: torch.Tensor, drift: torch.Tensor) -> torch.Tensor:
    """The triangle-inequality skip test, strict: every best distance grew
    by at most ``drift`` and every second-best shrank by at most ``drift``,
    so ``margin > 2 * drift`` keeps the block's assignments.  A fresh block
    carries a ``-inf`` margin and is always scored."""
    return margin > 2.0 * drift


def _solve_init(points, centroids, weights):
    x = points.float()
    lead = x.shape[:-2]
    c = centroids.float().expand(*lead, *centroids.shape[-2:]).clone()
    w = _as_weights(x, weights)
    it = torch.zeros(lead, dtype=torch.int32, device=x.device)
    shift = torch.full(lead, torch.inf, dtype=torch.float32, device=x.device)
    return x, c, w, it, shift


def lloyd_solve_ref(points: torch.Tensor, centroids: torch.Tensor,
                    weights: torch.Tensor | None = None, *,
                    max_iters: int = 300, tol: float = 1e-6):
    """A whole Lloyd solve -> (centroids (..., k, d) f32, sse (...) f32,
    iters (...) i32, converged (...) bool).

    Iterate while ``iters < max_iters and shift > tol`` with keep-old
    handling of empty clusters, then score the final centroids once more.
    ``points (..., n, d)`` with lanes as leading dimensions; ``centroids``
    ``(k, d)`` shared by every lane or one ``(..., k, d)`` per lane.  A lane
    that stops keeps its state while the others go on.
    """
    from repro_torch.core.metrics import centroid_shift
    x, c, w, it, shift = _solve_init(points, centroids, weights)
    while True:
        active = (it < max_iters) & (shift > tol)
        if not bool(torch.any(active)):
            break
        sums, counts, _ = lloyd_step_ref(x, c, w)
        new_c = divide_or_keep(sums, counts, c)
        new_shift = centroid_shift(new_c, c)
        c = torch.where(active[..., None, None], new_c, c)
        shift = torch.where(active, new_shift, shift)
        it = it + active.to(torch.int32)
    _, mind = assign_ref(x, c)
    return c, torch.sum(w * mind, dim=-1), it, shift <= tol


def lloyd_solve_bounds_ref(points: torch.Tensor, centroids: torch.Tensor,
                           weights: torch.Tensor | None = None, *,
                           max_iters: int = 300, tol: float = 1e-6,
                           block_rows: int = 64):
    """:func:`lloyd_solve_ref` with the block-skip logic of the pruned
    kernel -> (centroids, sse, iters, converged, skips (..., max_iters, 2)
    i32: [blocks skipped, blocks total] per iteration and lane).

    It computes the full score matrix every iteration but SELECTS the cached
    assignment for the blocks the bound declares skippable, so an unsound
    bound diverges from :func:`lloyd_solve_ref`.  Blocks are ``block_rows``
    rows, the last one padded with rows that never constrain a margin.
    """
    from repro_torch.core.metrics import centroid_shift
    x, c, w, it, shift = _solve_init(points, centroids, weights)
    lead, n, k = x.shape[:-2], x.shape[-2], c.shape[-2]
    bb = max(1, min(int(block_rows), n))
    nb = -(-n // bb)
    pad = nb * bb - n
    idx = torch.zeros((*lead, n), dtype=torch.int64, device=x.device)
    margin = torch.full((*lead, nb), -torch.inf, device=x.device)
    dacc = torch.zeros((*lead, nb), device=x.device)
    skips = torch.zeros((*lead, max(int(max_iters), 1), 2), dtype=torch.int32,
                        device=x.device)
    trip = 0
    while True:
        active = (it < max_iters) & (shift > tol)
        if not bool(torch.any(active)):
            break
        skip_b = bounds_may_skip(margin, dacc)                   # (..., nb)
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        c2 = torch.sum(c * c, dim=-1).unsqueeze(-2)
        d2 = torch.clamp(x2 - 2.0 * (x @ c.transpose(-1, -2)) + c2, min=0.0)
        labels = torch.argmin(d2, dim=-1)
        mind = torch.gather(d2, -1, labels.unsqueeze(-1)).squeeze(-1)
        gap = bound_gap(mind, bound_second_best(d2, labels), w > 0.0)
        gap = torch.nn.functional.pad(gap, (0, pad), value=torch.inf)
        new_margin = torch.amin(gap.view(*lead, nb, bb), dim=-1)
        skip_rows = skip_b.repeat_interleave(bb, dim=-1)[..., :n]
        new_idx = torch.where(skip_rows, idx, labels)
        new_margin = torch.where(skip_b, margin, new_margin)
        sums, counts = centroid_update_ref(x, new_idx, w, k)
        new_c = divide_or_keep(sums, counts, c)
        new_shift = centroid_shift(new_c, c)
        new_dacc = torch.where(skip_b, dacc + new_shift.unsqueeze(-1),
                               new_shift.unsqueeze(-1))
        a = active.unsqueeze(-1)
        idx = torch.where(a, new_idx, idx)
        margin = torch.where(a, new_margin, margin)
        dacc = torch.where(a, new_dacc, dacc)
        skips[..., trip, 0] = torch.where(
            active, torch.sum(skip_b, dim=-1).to(torch.int32), 0)
        skips[..., trip, 1] = torch.where(active, nb, 0)
        c = torch.where(active[..., None, None], new_c, c)
        shift = torch.where(active, new_shift, shift)
        it = it + active.to(torch.int32)
        trip += 1
    _, mind = assign_ref(x, c)
    return c, torch.sum(w * mind, dim=-1), it, shift <= tol, skips
