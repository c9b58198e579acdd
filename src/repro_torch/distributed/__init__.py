"""The port's distributed layer on ``torch.distributed``: the k-means mesh
and its row-block layouts (``sharding``), the one helper every collective
goes through (``comm``), int8 error-feedback compression (``compress``),
the process world the tests and ``chip_smoke.py`` start (``world``), and
the fault-tolerance runtime (``runtime``: heartbeats, eviction, per-stack
recovery of IPKMeans S2).

NCCL runs across cards and gloo on the CPU; a gloo world on a card stages
every collective through host memory (``comm``).  Nothing here starts a
process or a group when it is imported.
"""
from repro_torch.distributed.runtime import (Coordinator, FTConfig,
                                             RecoveryPlan, WorkerState,
                                             run_with_recovery,
                                             solve_stacks_with_recovery)

__all__ = ["Coordinator", "FTConfig", "RecoveryPlan", "WorkerState",
           "run_with_recovery", "solve_stacks_with_recovery"]
