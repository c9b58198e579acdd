"""The tuning cache, the tuner's sweep and the ``tuned`` engine, the
counterpart of ``repro.kernels.tuning``.

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
  * :func:`lookup_spec` / :func:`lookup_init_spec` / :func:`lookup_group_t`
    return the cached ``KernelSpec`` (or the stack's ``group_t``) for a
    launch shape, or ``None`` (each kernel's module default; one launch a
    stack).  The serving tier (``core/serve.py``) looks up each bucket's
    spec, ``core/init.py`` the init sweep's, the ``batched`` engine the
    stack's group size (``engine.BatchedEngine.resolve_group_size``).
  * the sweep: :func:`candidate_specs` builds the grid of a launch shape,
    pruned by the instantiated tile widths (``specs.BLOCK_KS``) and by one
    block's shared memory (``KernelSpec.*_smem_bytes`` against
    ``profile.fits``), and deduplicated by what the kernel launches;
    :func:`autotune_step` times one fused step a candidate,
    :func:`autotune_init_sweep` one k-means|| round, and
    :func:`autotune_batched` one whole solve of a stack at each group size
    (:func:`candidate_group_ts`), each recording the winner in a cache
    under the reference's key.  ``device="cpu"`` times the plain versions,
    as the reference's interpret mode times its interpreter: a run that
    exercises every candidate, not a timing of the card.  Every candidate
    gives the same bits; only the time differs.
    ``python -m repro_torch.launch.autotune`` drives the sweep.
  * :class:`TunedEngine`, registered as ``tuned``: ``resident`` whose
    ``resolve_spec`` hook returns the cached spec, so a cached ``block_k``,
    ``block_n`` and ``acc_dtype`` reach every per-step launch.  A cached
    ``block_k`` no score kernel is built for raises ``ValueError``
    (``specs.coerce``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from pathlib import Path

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import engine as engine_mod
from repro_torch.kernels import specs
from repro_torch.kernels.specs import DeviceProfile, KernelSpec

ENV_CACHE_PATH = "REPRO_TUNING_CACHE"
CACHE_VERSION = 1

# the sweep's grid, the reference's: block_n (the bf16 accumulate's block),
# block_k (the score tile widths the kernels are built for) and the group
# sizes of the whole-solve stack sweep (the cap always joins)
BLOCK_NS = (64, 128, 256, 512)
BLOCK_KS = specs.BLOCK_KS
GROUP_TS = (1, 2, 4, 8, 16)


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


def lookup_group_t(s: int, d: int, k: int, m: int, dtype=torch.float32,
                   device_kind: str | None = None, *,
                   device=None) -> int | None:
    """The cached group size of an (m, s, d, k) stack (the ``|m<bucket>``
    entry), or ``None`` (one launch): what the ``batched`` engine's group
    sizing consults."""
    spec = lookup_spec(s, d, k, dtype, device_kind, m=m, device=device)
    return None if spec is None else spec.group_t


def lookup_init_spec(n: int, d: int, c: int, dtype=torch.float32,
                     device_kind: str | None = None, *,
                     device=None) -> KernelSpec | None:
    """The cached spec of the k-means|| init sweep at (n points, d dims, c
    candidate-tile capacity), or ``None``: what ``core.init.
    kmeans_parallel_init`` consults when no spec is pinned."""
    kind = _device_kind(device_kind, device)
    return _active_cache().get(cache_key(kind, dtype, n, d, c,
                                         kernel="init"))


# ------------------------------------------------------------------ sweep ---

def launch_key(spec: KernelSpec, n: int, d: int, k: int, smem_bytes: str):
    """What a candidate launches: its tile width and arithmetic, and in
    bfloat16 the clamped block of the accumulate's partial sums (the init
    sweep has no accumulate).  In float32 ``block_n`` changes nothing."""
    reads_bn = spec.bf16 and smem_bytes != "init_smem_bytes"
    bn = spec.tile_shapes(n, d, k)[0] if reads_bn else None
    return spec.block_k, spec.acc_dtype, bn


def candidate_specs(n: int, d: int, k: int,
                    profile: DeviceProfile | None = None,
                    block_ns=BLOCK_NS, block_ks=BLOCK_KS,
                    acc_dtypes=("float32",),
                    smem_bytes: str = "fused_smem_bytes") -> list[KernelSpec]:
    """The pruned sweep grid of one launch shape.

    Drops (a) a ``block_k`` no score kernel is built for
    (``specs.BLOCK_KS``), (b) a candidate whose block does not fit
    ``profile``'s shared memory, priced by the ``KernelSpec`` method named
    by ``smem_bytes`` (``fused_smem_bytes`` for the Lloyd step,
    ``init_smem_bytes`` for the k-means|| sweep, where ``k`` is the
    candidate-tile capacity), and (c) duplicates: candidates that launch
    the same kernel (:func:`launch_key`), keeping the first.  The module
    default (in ``acc_dtypes[0]``) always competes, first, even where the
    budget would drop it, so the grid is never empty."""
    profile = profile or specs.get_profile()
    default = specs.DEFAULT_SPEC.replace(acc_dtype=acc_dtypes[0])
    out = {launch_key(default, n, d, k, smem_bytes): default}
    for acc in acc_dtypes:
        for bn in block_ns:
            for bk in block_ks:
                cand = KernelSpec(block_n=bn, block_k=bk, acc_dtype=acc)
                if bk not in specs.BLOCK_KS or not profile.fits(
                        getattr(cand, smem_bytes)(n, d, k)):
                    continue
                out.setdefault(launch_key(cand, n, d, k, smem_bytes), cand)
    return list(out.values())


def _timeit(fn, device, repeats: int = 3, warmup: int = 1) -> float:
    """Median wall seconds of ``fn()`` over ``repeats`` runs after
    ``warmup``, each ended by a synchronisation of ``device`` when it is a
    card."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def autotune_step(n: int, d: int, k: int, *,
                  dtype=torch.float32,
                  profile: DeviceProfile | None = None,
                  cache: TuningCache | None = None,
                  repeats: int = 3,
                  device=None,
                  block_ns=BLOCK_NS, block_ks=BLOCK_KS,
                  acc_dtypes=("float32",),
                  measure=None,
                  seed: int = 0):
    """Sweep the grid of one (n, d, k, dtype) fused step and record the
    winner in ``cache`` (the caller saves) -> ``(best_spec, rows)``, the
    rows the whole table, fastest first.

    ``measure(spec) -> seconds`` may be injected; the default times one
    fused step (``ops.lloyd_step_fused``) on ``device`` (default: the card)
    on normal points and centroids drawn from ``torch.Generator(device)``
    seeded with ``seed + n * d * k``.  ``profile`` defaults to
    ``device``'s, and its device kind keys the entry."""
    dev = resolve_device(device)
    profile = profile or specs.get_profile(dev)
    cands = candidate_specs(n, d, k, profile, block_ns=block_ns,
                            block_ks=block_ks, acc_dtypes=acc_dtypes)
    if measure is None:
        from repro_torch.kernels import ops
        gen = torch.Generator(dev).manual_seed(seed + n * d * k)
        x, c = _normal(gen, (n, d), dtype), _normal(gen, (k, d), dtype)

        def measure(spec):
            return _timeit(lambda: ops.lloyd_step_fused(x, c, spec=spec),
                           dev, repeats)

    rows = sorted(({"spec": cand, "time_us": measure(cand) * 1e6,
                    "smem_bytes": cand.fused_smem_bytes(n, d, k)}
                   for cand in cands), key=lambda r: r["time_us"])
    best = rows[0]
    if cache is not None:
        cache.put(cache_key(profile.device_kind, dtype, n, d, k),
                  best["spec"], time_us=round(best["time_us"], 2),
                  n=n, d=d, k=k, candidates=len(cands))
    return best["spec"], rows


def autotune_init_sweep(n: int, d: int, c: int, *,
                        dtype=torch.float32,
                        ell: float | None = None,
                        profile: DeviceProfile | None = None,
                        cache: TuningCache | None = None,
                        repeats: int = 3,
                        device=None,
                        block_ns=BLOCK_NS, block_ks=BLOCK_KS,
                        acc_dtypes=("float32",),
                        measure=None,
                        seed: int = 0):
    """Sweep the grid of the k-means|| init sweep at (n points, d dims, c
    candidate-tile capacity) and record the winner under the ``|init``
    key -> ``(best_spec, rows)``.

    ``measure(spec) -> seconds`` may be injected; the default times one
    round (``ops.init_sweep``, ``ell`` default ``2 c``) from a running
    minimum of +inf against ``c`` candidates, the points, candidates and
    uniforms drawn from ``torch.Generator(device)`` seeded with ``seed +
    n * d * c``."""
    dev = resolve_device(device)
    profile = profile or specs.get_profile(dev)
    cands = candidate_specs(n, d, c, profile, block_ns=block_ns,
                            block_ks=block_ks, acc_dtypes=acc_dtypes,
                            smem_bytes="init_smem_bytes")
    ell = float(2 * c) if ell is None else float(ell)
    if measure is None:
        from repro_torch.kernels import ops
        gen = torch.Generator(dev).manual_seed(seed + n * d * c)
        x, cd = _normal(gen, (n, d), dtype), _normal(gen, (c, d), dtype)
        u = torch.rand((n,), generator=gen, device=dev)
        om = torch.full((n,), torch.inf, device=dev)

        def measure(spec):
            return _timeit(lambda: ops.init_sweep(x, cd, om, u, 1.0, ell=ell,
                                                  spec=spec), dev, repeats)

    rows = sorted(({"spec": cand, "time_us": measure(cand) * 1e6,
                    "smem_bytes": cand.init_smem_bytes(n, d, c)}
                   for cand in cands), key=lambda r: r["time_us"])
    best = rows[0]
    if cache is not None:
        cache.put(cache_key(profile.device_kind, dtype, n, d, c,
                            kernel="init"),
                  best["spec"], time_us=round(best["time_us"], 2),
                  n=n, d=d, k=c, candidates=len(cands))
    return best["spec"], rows


def candidate_group_ts(m: int, s: int, d: int, k: int,
                       profile: DeviceProfile | None = None,
                       group_ts=GROUP_TS,
                       prune: str = "none") -> list[int]:
    """The group sizes to sweep for an (m, s, d, k) stack: ``group_ts``
    clamped to ``m`` and to the cap (``profile.batched_group_size``: ``m``
    where one lane fits), with the cap itself always among them, sorted;
    ``[]`` when one lane does not fit (the engines' fused fallback)."""
    profile = profile or specs.get_profile()
    cap = profile.batched_group_size(m, s, d, k, prune)
    if cap <= 0:
        return []
    out = {min(int(t), m) for t in group_ts if 1 <= min(int(t), m) <= cap}
    out.add(cap)
    return sorted(out)


def autotune_batched(m: int, s: int, d: int, k: int, *,
                     dtype=torch.float32,
                     profile: DeviceProfile | None = None,
                     cache: TuningCache | None = None,
                     repeats: int = 3,
                     device=None,
                     group_ts=GROUP_TS,
                     solve_iters: int = 8,
                     reseed_empty: bool = False,
                     prune: str = "none",
                     measure=None,
                     seed: int = 0):
    """Sweep the group sizes of the whole-solve kernel for one (m, s, d, k)
    stack and record the winner (``DEFAULT_SPEC`` with ``group_t`` set)
    under the ``|m<bucket>`` key -> ``(best_spec | None, rows)``, ``None``
    when one lane does not fit.

    ``measure(t) -> seconds`` may be injected; the default times one whole
    solve of ``solve_iters`` trips (``tol=0``, so every group size runs the
    same trips) of normal points against shared normal seeds drawn from
    ``torch.Generator(device)`` seeded with ``seed + m * s * d * k``, with
    ``reseed_empty`` and ``prune`` as given; both land under the same key,
    as in the reference (the group size changes no bit)."""
    from repro_torch.kernels import batch_resident
    from repro_torch.kernels.resident import check_prune
    check_prune(prune)
    dev = resolve_device(device)
    profile = profile or specs.get_profile(dev)
    cands = candidate_group_ts(m, s, d, k, profile, group_ts, prune=prune)
    if not cands:
        return None, []
    if measure is None:
        from repro_torch.kernels import ops
        gen = torch.Generator(dev).manual_seed(seed + m * s * d * k)
        x, c = _normal(gen, (m, s, d), dtype), _normal(gen, (k, d), dtype)

        def measure(t):
            return _timeit(lambda: ops.lloyd_solve_batched(
                x, c, group_t=t, max_iters=solve_iters, tol=0.0,
                reseed_empty=reseed_empty, prune=prune), dev, repeats)

    lane_bytes = batch_resident.smem_bytes(s, k, prune)
    rows = sorted(({"group_t": t, "time_us": measure(t) * 1e6,
                    "launches": -(-m // t), "smem_bytes": lane_bytes}
                   for t in cands), key=lambda r: r["time_us"])
    best = specs.DEFAULT_SPEC.replace(group_t=rows[0]["group_t"])
    if cache is not None:
        cache.put(cache_key(profile.device_kind, dtype, s, d, k, m=m), best,
                  time_us=round(rows[0]["time_us"], 2),
                  m=m, n=s, d=d, k=k, candidates=len(cands))
    return best, rows


# ----------------------------------------------------------- tuned engine ---

class TunedEngine(engine_mod.ResidentEngine):
    """``resident`` with the tuning cache's kernel spec.

    The solve is ``resident``'s (the whole-solve kernel, or the fused
    engine's per-step loop past its shared memory); ``resolve_spec`` looks
    the launch shape up, ``(S, d, k)`` of a lane and the points' dtype on
    their device, and gives ``None`` on a miss, so every per-step launch
    (``step``, ``assign``, the fallback loop, ``update_minibatch``) takes
    the cached spec: its ``block_k`` the score tile, its ``acc_dtype`` the
    arithmetic, its ``block_n`` the bf16 accumulate's blocks.  The
    whole-solve kernel scores float32 in tiles of 128, as the reference's
    resident kernel is fixed float32, so there the entry is only
    validated: a spec no port kernel can launch raises on every path."""

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
