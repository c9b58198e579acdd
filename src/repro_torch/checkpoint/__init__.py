"""Atomic and asynchronous checkpoints of trees of tensors, on the
reference's format on disk (``manager``)."""
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import (AsyncCheckpointer, gc_old,
                                            latest_step, restore,
                                            restore_latest, save)

__all__ = ["manager", "AsyncCheckpointer", "save", "restore",
           "restore_latest", "latest_step", "gc_old"]
