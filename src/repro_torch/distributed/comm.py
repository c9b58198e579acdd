"""The one place the port's collectives go through.

``all_reduce``, ``all_gather`` (and ``all_gather_ragged`` for blocks of
different lengths: the lengths first, then the padded blocks),
``all_to_all_single`` (equal blocks over dim 0) and ``exclusive_scan`` (the
sum over the ranks below this one, and over all), each over a process group
(``group(mesh, axes)`` names the group of some mesh axes; ``None`` is the
world).  Each returns a new tensor on the input's device.

Every call adds one to its stage's count, and the bytes this rank hands to
the collective (its input tensor) to the stage's bytes, as the kernel
wrappers count their launches: ``stage("s2")`` names the stage of the calls
inside it; ``reset()`` sets every count to 0 and ``read()`` returns them.
``reset(timed=True)`` also adds each stage block's wall time to
``seconds`` (host clock, the card's queue drained at both ends of the
block): a measurement's switch, off by default, so the solvers' stages add
no device synchronisation.

A gloo world with CUDA tensors stages every collective through host
memory: the rule follows the backend's name (gloo, or NCCL which cannot
put two ranks on one card), never a caught error.  Bool tensors travel as
uint8.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

# stage -> {"calls": n, "bytes": b} since the last reset (this process)
counts: dict[str, dict[str, int]] = {}
# stage -> seconds spent inside stage() blocks since reset(timed=True)
seconds: dict[str, float] = {}
_stages: list[str] = ["other"]
_timed = False

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


@contextlib.contextmanager
def stage(name: str):
    """Count the collectives inside the block under ``name`` (and time it
    after ``reset(timed=True)``)."""
    _stages.append(name)
    timed = _timed
    if timed:
        _drain()
        t0 = time.perf_counter()
    try:
        yield
    finally:
        if timed:
            _drain()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        _stages.pop()


def _drain() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def reset(timed: bool = False) -> None:
    """Every count to 0; ``timed``: time the stage blocks from now on."""
    global _timed
    counts.clear()
    seconds.clear()
    _timed = timed


def read() -> dict[str, dict[str, int]]:
    return {k: dict(v) for k, v in counts.items()}


def _count(t: torch.Tensor) -> None:
    c = counts.setdefault(_stages[-1], {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def group(mesh, axes):
    """The process group over the mesh axes ``axes`` (in mesh order): the
    world for all of them, the mesh's own group for one."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    if not axes or tuple(a for a in names if a in axes) != axes:
        raise ValueError(f"axes {axes} must be axes of the mesh {names}, in "
                         f"its order")
    if len(axes) == len(names):
        return dist.group.WORLD
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    raise ValueError(f"no process group for axes {axes} of a mesh {names}")


def size(grp=None) -> int:
    return dist.get_world_size(grp)


def index(grp=None) -> int:
    return dist.get_rank(grp)


def _wire(t: torch.Tensor, grp):
    """The tensor as the backend takes it: contiguous, bool as uint8, on
    the host under gloo."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.is_cuda and dist.get_backend(grp) == "gloo":
        t = t.cpu()
    return t


def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=like.dtype)


def all_reduce(t: torch.Tensor, grp=None, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" | "min" | "max") of ``t`` over the group's ranks."""
    _count(t)
    w = _wire(t, grp)
    if w is t:
        w = t.clone()
    dist.all_reduce(w, op=_OPS[op], group=grp)
    return _back(w, t)


def all_gather(t: torch.Tensor, grp=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all) stacked in group-rank order ->
    ``(P, *t.shape)``."""
    _count(t)
    w = _wire(t, grp)
    out = torch.empty(size(grp) * w.numel(), dtype=w.dtype, device=w.device)
    dist.all_gather_into_tensor(out, w.reshape(-1), group=grp)
    return _back(out.view((size(grp),) + tuple(w.shape)), t)


def all_gather_ragged(t: torch.Tensor, grp=None) -> list[torch.Tensor]:
    """Every rank's ``t``, whose first dimension may differ between ranks,
    in group-rank order: the lengths are gathered first, then the blocks
    padded to the longest."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    lens = all_gather(n, grp)[:, 0].tolist()
    top = max(lens)
    pad = torch.zeros((top - t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    full = all_gather(torch.cat([t, pad]), grp)
    return [full[r, :m] for r, m in enumerate(lens)]


def all_to_all_single(t: torch.Tensor, grp=None) -> torch.Tensor:
    """Block ``j`` of ``t``'s dim 0 goes to group rank ``j``; the result
    holds the blocks received, in group-rank order (equal blocks)."""
    _count(t)
    w = _wire(t, grp)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=grp)
    return _back(out, t)


def exclusive_scan(t: torch.Tensor, grp=None):
    """-> ``(total, below)``: the sum of ``t`` over the group's ranks, and
    over the ranks below this one (zeros on rank 0), from one all-gather."""
    every = all_gather(t, grp)
    return torch.sum(every, dim=0), torch.sum(every[:index(grp)], dim=0)
