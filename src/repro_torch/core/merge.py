"""Stage-3 centroid merging (paper Section 2.iii), the counterpart of
``repro.core.merge``.  ``hierarchical_merge`` comes in a later slice."""
from __future__ import annotations

import torch


def min_asse_merge(centroid_sets: torch.Tensor,
                   asses: torch.Tensor) -> torch.Tensor:
    """Paper's minimum-ASSE selection: among the M per-subset centroid sets
    (M, K, d), return the set whose subset had the lowest average SSE.
    The first index wins a tie (``torch.argmin`` returns the first
    minimum, as ``jnp.argmin`` does)."""
    return centroid_sets[torch.argmin(asses)]
