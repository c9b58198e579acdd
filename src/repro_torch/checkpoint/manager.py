"""Checkpointing: atomic, async, the counterpart of
``repro.checkpoint.manager``, on the same format on disk.

Layout: <dir>/step_<N>/ containing
  arrays.npz   — every leaf as a full array, ``a0``, ``a1``, ... in leaf
                 order
  meta.json    — step, wall time, and the leaf manifest (name, shape,
                 dtype)
  COMMITTED    — the sentinel, written last; restore ignores uncommitted
                 dirs

Trees are dicts, lists, tuples and NamedTuples of tensors (or anything
``numpy.asarray`` takes); ``None`` holds no leaf.  Leaves are ordered, and
named, as ``jax.tree_util`` orders and names them: a dict's keys sorted, a
NamedTuple by its fields, and a leaf's name its path in ``keystr`` form
(``['params']/[0]/.field``).  bfloat16 is stored as a ``uint16`` view with
``"bfloat16"`` in the manifest.  So a checkpoint written by either package
restores in the other.

Atomicity: write into step_<N>.tmp, rename it, then touch COMMITTED.
``AsyncCheckpointer`` copies the tree to the host (the only blocking part)
and writes it in a daemon thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _flatten_with_names(tree, path: str = ""):
    """-> ``(names, leaves)`` in ``jax.tree_util``'s order."""
    def sub(key):
        return f"{path}/{key}" if path else key

    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(sub(f"[{key!r}]"), tree[key]) for key in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(sub(f".{f}"), v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(sub(f"[{i}]"), v) for i, v in enumerate(tree)]
    else:
        return [path], [tree]
    names, leaves = [], []
    for name, child in items:
        n, lv = _flatten_with_names(child, name)
        names += n
        leaves += lv
    return names, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the iterator
    ``leaves`` (a dict keeps its own key order, its values filled in sorted
    key order)."""
    if like is None:
        return None
    if isinstance(like, dict):
        filled = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return type(like)((key, filled[key]) for key in like)
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf as ``(host numpy array, logical dtype)``: a tensor is copied
    (the caller may change it while a thread writes), a bfloat16 one as its
    ``uint16`` bits with ``"bfloat16"``; the logical dtype is ``None`` where
    the array's own names it."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _host_tree(tree):
    """``(names, host leaves)``: every leaf on the host now, so that nothing
    on a card is read later."""
    names, leaves = _flatten_with_names(tree)
    return names, [_to_host(leaf) for leaf in leaves]


def _write(directory: Path, step: int, names, host) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz",
             **{f"a{i}": a for i, (a, _) in enumerate(host)})
    meta = {
        "step": step,
        "time": time.time(),
        "leaves": [{"name": n, "shape": list(a.shape),
                    "dtype": logical or str(a.dtype)}
                   for n, (a, logical) in zip(names, host)],
    }
    (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    (final / "COMMITTED").touch()
    return final


def save(directory: str | os.PathLike, step: int, tree) -> Path:
    """Blocking atomic save of a tree of tensors -> the step's directory."""
    names, host = _host_tree(tree)
    return _write(Path(directory), step, names, host)


def latest_step(directory: str | os.PathLike) -> int | None:
    """The highest committed step in ``directory``, or ``None``."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if (p / "COMMITTED").exists()]
    return max(steps) if steps else None


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def restore(directory: str | os.PathLike, step: int, like):
    """Restore step ``step`` into the structure of ``like``: each leaf on
    ``like``'s leaf's device and in its dtype (a leaf that is not a tensor
    gives a CPU tensor of the stored dtype).  Raises ``FileNotFoundError``
    for an uncommitted step and ``ValueError`` when the leaf count or a
    shape differs."""
    path = Path(directory) / f"step_{step:08d}"
    if not (path / "COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "arrays.npz") as data:
        arrays = [_from_host(data[f"a{i}"], leaf["dtype"])
                  for i, leaf in enumerate(meta["leaves"])]
    names, leaves = _flatten_with_names(like)
    if len(arrays) != len(leaves):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, "
                         f"target tree has {len(leaves)}")
    out = []
    for a, leaf, name in zip(arrays, leaves, names):
        if tuple(a.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(a.shape)} vs {tuple(np.shape(leaf))}")
        if isinstance(leaf, torch.Tensor):
            a = a.to(device=leaf.device, dtype=leaf.dtype)
        out.append(a)
    return _unflatten(like, iter(out))


def restore_latest(directory, like):
    """``(step, tree)`` of the latest committed step, or ``None``."""
    step = latest_step(directory)
    if step is None:
        return None
    return step, restore(directory, step, like)


def gc_old(directory: str | os.PathLike, keep: int = 3):
    """Delete all but the ``keep`` latest committed steps."""
    directory = Path(directory)
    steps = sorted(p for p in directory.glob("step_*")
                   if (p / "COMMITTED").exists())
    for p in steps[:-keep]:
        shutil.rmtree(p)


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with work: a host copy, then a daemon
    write."""

    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = None

    def save(self, step: int, tree):
        """Copy ``tree`` to the host now (CUDA tensors included, before the
        thread starts), then write and collect old steps in the thread."""
        self.wait()
        names, host = _host_tree(tree)

        def work():
            _write(self.directory, step, names, host)
            gc_old(self.directory, self.keep)
            self.last_saved = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
