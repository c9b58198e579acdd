"""The port's kernels and the engines that run them.

``fused`` holds the hand-written CUDA fused Lloyd pass (``csrc/
fused_lloyd.cu``) and its plain PyTorch version; ``batch_resident`` the
whole-solve kernel (``csrc/lloyd_solve.cu``) over a stack and its plain
version, and ``resident`` the same kernel on one subset; ``assign``,
``centroid_update`` and ``init`` the assign, centroid-update and k-means||
init-sweep kernels (``csrc/sweeps.cu``); ``ops`` wraps them; ``engine`` is
the backend registry (``eager`` | ``twopass`` | ``fused`` | ``resident`` |
``batched``, and ``tuned`` from ``tuning``); ``specs`` the ``KernelSpec``
every single-pass wrapper takes as ``spec=`` and the card's
``DeviceProfile``; ``tuning`` the tuning cache's lookup.  Importing this
package needs no GPU and no compiler: the CUDA sources are built at the
first launch on a CUDA tensor (``_build``).
"""
from repro_torch.kernels import (assign, batch_resident, centroid_update,
                                 engine, fused, init, ops, ref, resident,
                                 specs, tuning)

__all__ = ["assign", "batch_resident", "centroid_update", "engine", "fused",
           "init", "ops", "ref", "resident", "specs", "tuning"]
