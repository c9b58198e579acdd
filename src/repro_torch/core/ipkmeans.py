"""IPKMeans — the paper's contribution, the counterpart of the
single-process ``repro.core.ipkmeans.ipkmeans``.

Three stages (Section 2):
  S1  partition_dataset : k-d tree median splits + labeling (or a random
      partition), then a pack into an (M, S, d) stack plus mask
  S2  per-subset k-means: M independent Lloyd solves to convergence, the
      whole stack in one launch of the whole-solve kernel
      (``backend="batched"``, the reference's main configuration), or one
      launch per Lloyd trip (``backend="fused"``)
  S3  merge             : min-ASSE selection or hierarchical midpoint
      merging, then the SSE over the dataset

Before S1, with ``init`` other than ``"given"``, the shared seeds are drawn
from the whole dataset (``core/init.py``).  The port takes every value of
the reference's single-process configuration: ``partition`` ``"kd_axis"`` |
``"kd_random"`` | ``"random"``, ``s1`` ``"auto"`` | ``"sort"`` |
``"histogram"``, ``pack`` ``"scatter"`` | ``"sorted"`` | ``"a2a"`` (which
needs a device mesh, so it warns and scatters, as the reference's
single-process path does), ``merge`` ``"min_asse"`` | ``"hierarchical"``, and
every ``init``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import torch

from repro_torch.core import kdtree, merge, metrics
from repro_torch.core.init import INIT_METHODS, resolve_init
from repro_torch.core.kmeans import (KMeansParams, KMeansResult, _init_backend,
                                     check_params, kmeans_batched)
from repro_torch.device import as_float, resolve_device

REDUCE_MODES = ("exact", "int8ef")
S1_MODES = ("auto", "sort", "histogram")
PARTITIONS = ("kd_axis", "kd_random", "random")
PACKS = ("scatter", "sorted", "a2a")
MERGES = ("min_asse", "hierarchical")


@dataclasses.dataclass(frozen=True)
class IPKMeansConfig:
    num_clusters: int                       # K — final clusters wanted
    num_subsets: int                        # M — parallel "reducers"
    partition: str = "kd_axis"              # 'kd_axis' | 'kd_random' | 'random'
    merge: str = "min_asse"                 # 'min_asse' | 'hierarchical'
    pack: str = "scatter"                   # 'scatter' | 'sorted' | 'a2a'
                                            # (a2a needs a mesh: it warns
                                            # and scatters here)
    reduce: str = "exact"                   # cross-pod reduction; the
                                            # single-process path has none
    s1: str = "auto"                        # 'auto' | 'sort' | 'histogram':
                                            # tree build + labeling ('auto'
                                            # is 'sort' on one process)
    leaf_capacity: int | None = None        # default: num_subsets (paper)
    label_axis: int = 0
    kmeans: KMeansParams = KMeansParams()

    def __post_init__(self):
        if self.reduce not in REDUCE_MODES:
            raise ValueError(f"unknown reduce: {self.reduce!r} "
                             f"(expected one of {REDUCE_MODES})")
        if self.s1 not in S1_MODES:
            raise ValueError(f"unknown s1: {self.s1!r} "
                             f"(expected one of {S1_MODES})")

    def with_backend(self, backend: str) -> "IPKMeansConfig":
        """Same config, different Lloyd engine ('eager' | 'twopass' |
        'fused' | 'resident' | 'batched')."""
        return dataclasses.replace(
            self, kmeans=self.kmeans._replace(backend=backend))

    def with_init(self, init: str) -> "IPKMeansConfig":
        """Same config, different seeding ('given' | 'sample' | 'kmeans++' |
        'kmeans||'): other than "given", ``ipkmeans`` draws the shared seeds
        itself instead of taking ``init_centroids``."""
        if init not in INIT_METHODS:
            raise ValueError(f"unknown init: {init!r} "
                             f"(expected one of {INIT_METHODS})")
        return dataclasses.replace(self, kmeans=self.kmeans._replace(
            init=init))

    @property
    def init(self) -> str:
        """The seeding strategy (it lives on the nested ``KMeansParams``)."""
        return self.kmeans.init

    def subset_capacity(self, n: int) -> int:
        """Static bound on points per subset (tensor packing size)."""
        if self.partition == "random":
            return -(-n // self.num_subsets)                   # ceil
        cap = self.leaf_capacity or self.num_subsets
        depth = kdtree.required_depth(n, cap)
        # leaves hold <= ceil(n / 2^depth) points; labels wrap mod M, so a
        # leaf contributes <= ceil(max_leaf / M) points to each subset
        max_leaf = -(-n // (2 ** depth))
        return (2 ** depth) * (-(-max_leaf // self.num_subsets))


class IPKMeansResult(NamedTuple):
    centroids: torch.Tensor                 # (K, d) final centroids
    sse: torch.Tensor                       # () SSE over the FULL dataset
    intermediate: torch.Tensor              # (M, K, d) per-subset centroids
    asses: torch.Tensor                     # (M,) per-subset ASSE
    subset_iters: torch.Tensor              # (M,) Lloyd iterations per subset
    kd_depth: int                           # tree levels ("jobs")


def check_config(cfg: IPKMeansConfig) -> None:
    """Raise ``ValueError`` for a value the reference does not know."""
    for what, v, known in (("partition", cfg.partition, PARTITIONS),
                           ("pack", cfg.pack, PACKS),
                           ("merge", cfg.merge, MERGES)):
        if v not in known:
            raise ValueError(f"unknown {what}: {v!r} (expected one of "
                             f"{known})")
    check_params(cfg.kmeans)


def _check_pack_complete(n: int, masks: torch.Tensor, pack: str) -> None:
    """Raise if the pack lost points: a dropped point silently biases every
    downstream centroid."""
    lost = n - int(masks.sum())
    if lost:
        raise ValueError(
            f"pack={pack!r} dropped {lost} of {n} points (packed mask counts "
            f"{n - lost}): subset capacity is too small for this partition's "
            "skew")


def _partition_and_pack(points: torch.Tensor, cfg: IPKMeansConfig, *,
                        draws=None, generator: torch.Generator | None = None):
    """S1: partition, then route each subset to its reducer's row.

    ``cfg.s1`` ``"histogram"`` runs the sort-free tree build and the
    bucketed labeler; ``"auto"`` is ``"sort"`` on one process.  The random
    partitions consume ``draws`` or draw from ``generator``
    (``kdtree.partition_dataset``).  ``cfg.pack``: ``"sorted"`` (one sort
    and a reshape) when every subset holds exactly ``capacity`` points
    (``n == M * capacity``), else ``"scatter"``; ``"a2a"`` needs a device
    mesh, so it warns and scatters.
    """
    s1 = "sort" if cfg.s1 == "auto" else cfg.s1
    part = kdtree.partition_dataset(
        points, cfg.num_subsets, leaf_capacity=cfg.leaf_capacity,
        strategy=cfg.partition, label_axis=cfg.label_axis, builder=s1,
        labeler=s1, draws=draws, generator=generator)
    n = points.shape[0]
    capacity = cfg.subset_capacity(n)
    if cfg.pack == "sorted" and n == cfg.num_subsets * capacity:
        subsets, masks = kdtree.pack_subsets_sorted(
            points, part.subset_ids, cfg.num_subsets, capacity)
    else:
        if cfg.pack == "a2a":
            warnings.warn(
                "pack='a2a' needs a device mesh; using the scatter pack "
                "instead", RuntimeWarning, stacklevel=3)
        subsets, masks = kdtree.pack_subsets(
            points, part.subset_ids, cfg.num_subsets, capacity)
    _check_pack_complete(n, masks, cfg.pack)
    return part, subsets, masks


def _merge_stage(points: torch.Tensor, res: KMeansResult,
                 cfg: IPKMeansConfig):
    m, k, d = res.centroids.shape
    if cfg.merge == "hierarchical":
        final = merge.hierarchical_merge(res.centroids.reshape(m * k, d), k)
    else:
        final = merge.min_asse_merge(res.centroids, res.asse)
    return final, metrics.sse(points, final)


def _resolve_init_stage(points: torch.Tensor, init_centroids,
                        cfg: IPKMeansConfig, draws=None,
                        generator: torch.Generator | None = None):
    """The seeding stage: with ``cfg.init`` other than ``"given"``, the
    shared per-reducer seeds drawn from the whole dataset -> ``(seeds,
    cfg.with_init("given"))``; otherwise the given seeds and ``cfg``."""
    if cfg.init == "given":
        if init_centroids is None:
            raise ValueError('cfg.init="given" needs init_centroids')
        return init_centroids, cfg
    seeds = resolve_init(points, cfg.num_clusters, cfg.init,
                         backend=_init_backend(cfg.kmeans.backend),
                         draws=draws, generator=generator)
    return seeds, cfg.with_init("given")


def ipkmeans(points, init_centroids, cfg: IPKMeansConfig, *, draws=None,
             partition_draws=None, generator: torch.Generator | None = None,
             device=None) -> IPKMeansResult:
    """Single-process IPKMeans: ``points (n, d)``, the shared seeds
    ``init_centroids (K, d)`` every reducer starts from, and ``cfg``.

    With ``cfg.init`` other than ``"given"`` the seeds are drawn from the
    whole dataset before S1, from ``draws`` or ``generator``
    (``core/init.py``), and ``init_centroids`` may be ``None``.
    ``partition="kd_random"`` takes ``partition_draws`` as ``(n,)`` f32
    uniforms and ``"random"`` as an ``(n,)`` int64 permutation (the
    reference draws them with ``jax.random.uniform(key, (n,))`` and
    ``jax.random.permutation(key, n)`` from the key it partitions with);
    without them they come from ``generator``, after the seeding's draws.
    Float32 or bfloat16 points and seeds: S2 carries the seeds' dtype, the
    intermediate and final centroids come back in it, and the final SSE in
    the points' and seeds' dtype, as in the reference.
    Runs on ``device`` (default: CUDA, raising without a card).  Each stage
    is also reachable alone (``_resolve_init_stage``,
    ``_partition_and_pack``, ``kmeans_batched``, ``_merge_stage``), which is
    how ``chip_smoke.py`` times them.
    """
    check_config(cfg)
    dev = resolve_device(device)
    x = as_float(points, dev)
    init_centroids, cfg = _resolve_init_stage(x, init_centroids, cfg, draws,
                                              generator)
    part, subsets, masks = _partition_and_pack(
        x, cfg, draws=partition_draws, generator=generator)
    res = kmeans_batched(subsets, masks, init_centroids, cfg.kmeans,
                         device=dev)
    final, total_sse = _merge_stage(x, res, cfg)
    return IPKMeansResult(centroids=final, sse=total_sse,
                          intermediate=res.centroids, asses=res.asse,
                          subset_iters=res.iters, kd_depth=part.depth)
