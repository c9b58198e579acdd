"""What a kernel launch costs, and the shape-only route of the wrappers.

Each kernel module has a ``work(...)`` function that gives the f32
operations and the device-memory bytes of one launch from its shapes and
mode (:class:`Work`): the operations the kernel computes, and each input
read once and each output written once.  ``chip_smoke.py`` divides them by
the card's peaks for its bounds, and the dry run
(``launch/kmeans_dryrun.py``) adds them up per rank.

A wrapper given a fake tensor (``torch._subclasses.FakeTensor``, under a
``FakeTensorMode``) or a ``meta`` tensor takes a third route beside the
kernel (a CUDA tensor) and the plain version (a CPU tensor): it returns
empty outputs with the kernel's shapes and dtypes, launches nothing, and
hands the launch's :class:`Work` to every tally opened with :func:`tally`
(:func:`record`).  The route is chosen by the tensor's type alone; on the
real routes it costs one ``isinstance`` test.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

F32 = 4


class Work(NamedTuple):
    flops: float        # f32 operations
    bytes: float        # device-memory bytes: inputs read, outputs written


def is_fake(t: torch.Tensor) -> bool:
    """Does ``t`` take the shape-only route (a fake tensor)?  A ``meta``
    tensor does too; the wrappers test for it on their non-CPU, non-CUDA
    branch, so that the real routes pay this one test only."""
    return isinstance(t, FakeTensor)


# the open tallies: each a callable (name, Work) -> None
_tallies: list = []


@contextlib.contextmanager
def tally(sink):
    """Hand every shape-only launch inside the block to ``sink(name,
    work)``."""
    _tallies.append(sink)
    try:
        yield sink
    finally:
        _tallies.remove(sink)


def record(name: str, work: Work) -> None:
    """A shape-only launch of the kernel ``name``."""
    for sink in _tallies:
        sink(name, work)
