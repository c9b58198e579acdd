"""The port's kernels and the engines that run them.

``fused`` holds the hand-written CUDA fused Lloyd pass (``csrc/
fused_lloyd.cu``) and its plain PyTorch version; ``batch_resident`` the
whole-solve kernel (``csrc/lloyd_solve.cu``) over a stack and its plain
version, and ``resident`` the same kernel on one subset; ``assign``,
``centroid_update`` and ``init`` the assign, centroid-update and k-means||
init-sweep kernels (``csrc/sweeps.cu``); ``ops`` wraps them; ``engine`` is
the backend registry (``eager`` | ``twopass`` | ``fused`` | ``resident`` |
``batched``, and ``tuned`` from ``tuning``); ``specs`` the ``KernelSpec``
every wrapper takes as ``spec=`` and the card's ``DeviceProfile``;
``tuning`` the tuning cache and the tuner's sweep (``python -m
repro_torch.launch.autotune``).  Importing this package needs no GPU and
no compiler: the CUDA sources are built at the first launch on a CUDA
tensor (``_build``).
"""
from repro_torch.kernels import (assign, batch_resident, centroid_update,
                                 engine, fused, init, ops, ref, resident,
                                 specs, tuning)
from repro_torch.kernels.batch_resident import (batched_feasible,
                                                batched_group_size,
                                                lloyd_solve_batched)
from repro_torch.kernels.engine import (LloydEngine, available, get_engine,
                                        register)
from repro_torch.kernels.init import init_sweep
from repro_torch.kernels.resident import (check_prune, lloyd_solve_resident,
                                          max_resident_points,
                                          resident_feasible,
                                          resident_smem_bytes)
from repro_torch.kernels.specs import DeviceProfile, KernelSpec, get_profile
from repro_torch.kernels.tuning import (TuningCache, autotune_batched,
                                        autotune_init_sweep, autotune_step,
                                        candidate_group_ts, candidate_specs,
                                        lookup_group_t, lookup_init_spec,
                                        lookup_spec)

lloyd_step_fused = ops.lloyd_step_fused

__all__ = ["assign", "batch_resident", "centroid_update", "engine", "fused",
           "init", "ops", "ref", "resident", "specs", "tuning",
           "batched_feasible", "batched_group_size", "lloyd_solve_batched",
           "lloyd_step_fused", "lloyd_solve_resident", "resident_feasible",
           "resident_smem_bytes", "max_resident_points", "check_prune",
           "init_sweep", "LloydEngine", "available", "get_engine",
           "register", "DeviceProfile", "KernelSpec", "get_profile",
           "TuningCache", "autotune_step", "autotune_init_sweep",
           "autotune_batched", "candidate_specs", "candidate_group_ts",
           "lookup_spec", "lookup_init_spec", "lookup_group_t"]
