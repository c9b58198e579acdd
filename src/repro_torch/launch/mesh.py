"""Production mesh construction, the counterpart of ``repro.launch.mesh``.

A mesh is a ``DeviceMesh`` over the process group this process belongs
to: a world of ranks (``distributed/world.py``), or for the dry run the
fake world of 256 or 512 ranks in one process (``world.fake``).  Defined as
functions, so importing this module touches no process group.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.distributed import sharding


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single pod (256 cards) or 2x16x16 (512 cards, 2 pods), over
    a world of that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return sharding.make_mesh(shape, axes)


def make_local_mesh(shape=None, axes=("data",)):
    """A mesh over the ranks the world actually has (tests, examples):
    ``(world size,)`` by default."""
    if shape is None:
        shape = (dist.get_world_size(),)
    return sharding.make_mesh(tuple(shape), tuple(axes))


def flat_axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)
