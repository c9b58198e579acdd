"""The tuning cache's lookup half and the ``tuned`` engine, the counterpart
of ``repro.kernels.tuning``.

  * :class:`TuningCache` reads and writes the reference's JSON schema
    (``version`` 1, ``entries``: key -> ``KernelSpec.to_json()`` plus sweep
    metadata) at ``default_cache_path()``: ``REPRO_TUNING_CACHE`` when set,
    else ``experiments/tuning/kernel_specs.json`` at the repository's root,
    the reference's file.
  * :func:`cache_key` builds the reference's keys letter for letter,
    ``device_kind|dtype|n<bucket>|d<d>|k<k>`` (``|m<bucket>`` for a stack,
    ``|init`` for the k-means|| sweep), the dtype by its name.  Each
    package keys its entries by its own device kind (here the card's name,
    ``specs.get_profile(device).device_kind``: the H100's for CPU tensors),
    so either package reads a file the other wrote and finds its own
    entries in it.
  * :func:`lookup_spec` / :func:`lookup_init_spec` return the cached
    ``KernelSpec`` for a launch shape, or ``None`` (each kernel's module
    default).  The serving tier (``core/serve.py``) looks up each bucket's
    spec, ``core/init.py`` the init sweep's.
  * :class:`TunedEngine`, registered as ``tuned``: ``resident`` whose
    ``resolve_spec`` hook returns the cached spec.  A cached spec that sets
    ``block_k`` or ``group_t`` raises ``ValueError`` (``specs.coerce``): no
    port kernel reads them.

The reference's sweep (``candidate_specs``, ``autotune_*``,
``launch/autotune.py``) is not ported: the port's kernels read only
``block_n`` and ``acc_dtype`` of a spec.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from pathlib import Path

import torch

from repro_torch.kernels import engine as engine_mod
from repro_torch.kernels import specs
from repro_torch.kernels.specs import KernelSpec

ENV_CACHE_PATH = "REPRO_TUNING_CACHE"
CACHE_VERSION = 1


def default_cache_path() -> Path:
    env = os.environ.get(ENV_CACHE_PATH)
    if env:
        return Path(env)
    return (Path(__file__).resolve().parents[3]
            / "experiments" / "tuning" / "kernel_specs.json")


def n_bucket(n: int) -> int:
    """Shape-family bucket for n: the next power of two (at least 8)."""
    return max(8, 1 << max(0, int(n - 1).bit_length()))


def dtype_name(dtype) -> str:
    """A ``torch.dtype`` (or a name) as the reference's keys write it:
    ``"float32"``, ``"bfloat16"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def cache_key(device_kind: str, dtype, n: int, d: int, k: int,
              m: int | None = None, kernel: str | None = None) -> str:
    """The reference's key: ``m`` extends it for a stack (n is then the
    subset size), ``kernel`` for another kernel family (``"init"``: the
    k-means|| sweep, k the candidate-tile capacity, bucketed like n)."""
    kk = n_bucket(k) if kernel == "init" else k
    key = (f"{device_kind.lower().strip()}|{dtype_name(dtype)}|"
           f"n{n_bucket(n)}|d{d}|k{kk}")
    if m is not None:
        key = f"{key}|m{n_bucket(m)}"
    return key if kernel is None else f"{key}|{kernel}"


@dataclasses.dataclass
class TuningCache:
    """The persisted winners, ``key -> KernelSpec`` plus metadata, in the
    reference's schema::

        {"version": 1,
         "entries": {"<device>|<dtype>|n<bucket>|d<d>|k<k>":
                       {"block_n": 256, "block_k": 128,
                        "acc_dtype": "float32", "time_us": 812.4, ...}}}

    A file of another version, or one that does not parse, is ignored with
    a warning; so is an entry that is not a valid ``KernelSpec``."""

    path: Path
    entries: dict[str, dict] = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path: str | Path | None = None) -> "TuningCache":
        p = Path(path) if path is not None else default_cache_path()
        entries: dict[str, dict] = {}
        if p.exists():
            try:
                obj = json.loads(p.read_text())
                if obj.get("version") == CACHE_VERSION:
                    entries = dict(obj.get("entries", {}))
                else:
                    warnings.warn(f"ignoring tuning cache {p}: version "
                                  f"{obj.get('version')!r} != {CACHE_VERSION}")
            except (OSError, json.JSONDecodeError, AttributeError) as e:
                warnings.warn(f"ignoring unreadable tuning cache {p}: {e}")
        return cls(path=p, entries=entries)

    def get(self, key: str) -> KernelSpec | None:
        entry = self.entries.get(key)
        if entry is None:
            return None
        try:
            return KernelSpec.from_json(entry)
        except (KeyError, ValueError, TypeError) as e:
            warnings.warn(f"ignoring malformed tuning entry {key!r}: {e}")
            return None

    def put(self, key: str, spec: KernelSpec, **meta) -> None:
        self.entries[key] = {**spec.to_json(), **meta}

    def save(self) -> Path:
        """Write the file whole (a temporary file, then a rename), so that a
        reader never sees half of it."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = json.dumps({"version": CACHE_VERSION,
                              "entries": self.entries}, indent=2,
                             sort_keys=True)
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(payload)
        os.replace(tmp, self.path)
        return self.path


# the process's cache, loaded at first use and again whenever
# default_cache_path() names another file
_ACTIVE: TuningCache | None = None


def _active_cache() -> TuningCache:
    global _ACTIVE
    want = default_cache_path()
    if _ACTIVE is None or _ACTIVE.path != want:
        _ACTIVE = TuningCache.load(want)
    return _ACTIVE


def reload_cache() -> TuningCache:
    """Read the cache file again (after it was rewritten)."""
    global _ACTIVE
    _ACTIVE = None
    return _active_cache()


def _device_kind(device_kind, device) -> str:
    return device_kind or specs.get_profile(device).device_kind


def lookup_spec(n: int, d: int, k: int, dtype=torch.float32,
                device_kind: str | None = None, m: int | None = None, *,
                device=None) -> KernelSpec | None:
    """The cached spec for this launch shape, or ``None`` (the module
    defaults).  The device kind defaults to ``device``'s
    (``specs.get_profile``); with ``m``, the stack entry (n the subset
    size)."""
    kind = _device_kind(device_kind, device)
    return _active_cache().get(cache_key(kind, dtype, n, d, k, m=m))


def lookup_init_spec(n: int, d: int, c: int, dtype=torch.float32,
                     device_kind: str | None = None, *,
                     device=None) -> KernelSpec | None:
    """The cached spec of the k-means|| init sweep at (n points, d dims, c
    candidate-tile capacity), or ``None``: what ``core.init.
    kmeans_parallel_init`` consults when no spec is pinned."""
    kind = _device_kind(device_kind, device)
    return _active_cache().get(cache_key(kind, dtype, n, d, c,
                                         kernel="init"))


class TunedEngine(engine_mod.ResidentEngine):
    """``resident`` with the tuning cache's kernel spec.

    The solve is ``resident``'s (the whole-solve kernel, or the fused
    engine's per-step loop past its shared memory); ``resolve_spec`` looks
    the launch shape up, ``(S, d, k)`` of a lane and the points' dtype on
    their device, and gives ``None`` on a miss, so every per-step launch
    (``step``, ``assign``, the fallback loop, ``update_minibatch``) takes
    the cached spec.  The whole-solve kernel's arithmetic is fixed float32,
    as the reference's resident kernel's is, so there the entry is only
    validated: a spec no port kernel can honour raises on every path."""

    name = "tuned"

    def resolve_spec(self, points, centroids):
        spec = lookup_spec(points.shape[-2], points.shape[-1],
                           centroids.shape[-2], points.dtype,
                           device=points.device)
        return None if spec is None else specs.coerce(spec)

    def solve(self, points, init_centroids, weights=None, **kw):
        self.resolve_spec(points, init_centroids)
        return super().solve(points, init_centroids, weights, **kw)


engine_mod.register(TunedEngine())
