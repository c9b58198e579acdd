"""Public wrappers around the port's kernels, the counterpart of
``repro.kernels.ops``.

The fused-pass wrappers take one subset, ``(n,d)`` points with ``(k,d)``
centroids as in the reference, or a stack, ``(M,S,d)`` with ``(M,k,d)`` and
optional ``lanes`` (``kernels/fused.py``).  The whole-solve wrappers take
one subset (``lloyd_solve_resident``, ``kernels/resident.py``) or a stack
with shared ``(k,d)`` seeds (``lloyd_solve_batched``,
``kernels/batch_resident.py``).  ``assign`` and ``centroid_update`` (the
``twopass`` engine's two kernels) take one subset or a stack with ``lanes``;
``init_sweep`` runs one k-means|| round (``kernels/init.py``).  All run the
CUDA kernel on CUDA tensors and its plain version on CPU tensors.
"""
from __future__ import annotations

from repro_torch.kernels import fused, ref
from repro_torch.kernels.assign import assign
from repro_torch.kernels.batch_resident import lloyd_solve_batched
from repro_torch.kernels.centroid_update import centroid_update
from repro_torch.kernels.init import init_sweep
from repro_torch.kernels.resident import lloyd_solve_resident

__all__ = ["assign", "centroid_update", "init_sweep", "lloyd_step_fused",
           "lloyd_assign_fused", "lloyd_solve_resident",
           "lloyd_solve_batched", "assign_ref", "centroid_update_ref",
           "init_sweep_ref", "lloyd_step_ref", "lloyd_solve_ref",
           "lloyd_solve_bounds_ref"]


def lloyd_step_fused(points, centroids, weights=None, *, lanes=None):
    """One fused Lloyd pass -> (sums (k,d), counts (k,), sse ()) for one
    subset, or ``(L,k,d), (L,k), (L,)`` for a stack."""
    if points.dim() == 2:
        out = fused.fused_lloyd(
            points.unsqueeze(0), centroids.unsqueeze(0),
            None if weights is None else weights.unsqueeze(0))
        return out.sums[0], out.counts[0], out.sse[0]
    out = fused.fused_lloyd(points, centroids, weights, lanes)
    return out.sums, out.counts, out.sse


def lloyd_assign_fused(points, centroids, *, lanes=None):
    """Labels + min squared distances from the fused pass's assign-only
    mode -> (labels (n,) i32, mind (n,)) or ``(L,S)`` each for a stack."""
    if points.dim() == 2:
        out = fused.fused_lloyd(points.unsqueeze(0), centroids.unsqueeze(0),
                                assign_only=True)
        return out.labels[0], out.mind[0]
    out = fused.fused_lloyd(points, centroids, lanes=lanes, assign_only=True)
    return out.labels, out.mind


# the oracles, so callers can switch implementations uniformly
assign_ref = ref.assign_ref
centroid_update_ref = ref.centroid_update_ref
init_sweep_ref = ref.init_sweep_ref
lloyd_step_ref = ref.lloyd_step_ref
lloyd_solve_ref = ref.lloyd_solve_ref
lloyd_solve_bounds_ref = ref.lloyd_solve_bounds_ref
