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
the reference's configuration: ``partition`` ``"kd_axis"`` |
``"kd_random"`` | ``"random"``, ``s1`` ``"auto"`` | ``"sort"`` |
``"histogram"``, ``pack`` ``"scatter"`` | ``"sorted"`` | ``"a2a"`` (which
needs a mesh, so the single-process ``ipkmeans`` warns and scatters, as the
reference's does), ``merge`` ``"min_asse"`` | ``"hierarchical"``, ``reduce``
``"exact"`` | ``"int8ef"`` (the pod path's), and every ``init``.

``ipkmeans_distributed`` runs the pipeline on a mesh of ranks
(``distributed/``), each rank one process: S2 with the subsets in blocks
over the mesh and NO collective inside the loops (the paper's "one
MapReduce job with much more reducers"), or, with a pod axis, each subset's
points also in blocks over the pods and one (sums, counts) reduction over
the pods each Lloyd iteration.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple

import torch

from repro_torch.core import kdtree, merge, metrics
from repro_torch.core.init import INIT_METHODS, resolve_init
from repro_torch.core.kmeans import (KMeansParams, KMeansResult, _init_backend,
                                     check_params, kmeans_batched)
from repro_torch.device import as_float, resolve_device
from repro_torch.distributed import comm, compress, sharding
from repro_torch.kernels import engine as engines

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
    reduce: str = "exact"                   # 'exact' | 'int8ef': the
                                            # cross-pod stats reduction
                                            # (pod_axis only)
    s1: str = "auto"                        # 'auto' | 'sort' | 'histogram':
                                            # tree build + labeling ('auto'
                                            # is 'histogram' with a pod axis,
                                            # else 'sort')
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

    def with_s1(self, s1: str) -> "IPKMeansConfig":
        """Same config, other S1 machinery ('auto' | 'sort' |
        'histogram'): the histogram pair is the one that runs sharded."""
        return dataclasses.replace(self, s1=s1)

    def with_reduce(self, reduce: str) -> "IPKMeansConfig":
        """Same config, other cross-pod reduction ('exact' | 'int8ef'); it
        acts only in ``ipkmeans_distributed`` with a ``pod_axis``."""
        return dataclasses.replace(self, reduce=reduce)

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


def _check_pack_complete(n: int, masks: torch.Tensor, pack: str,
                         dropped: int | None = None) -> None:
    """Raise if the pack lost points (``dropped``, else counted from the
    masks): a dropped point silently biases every downstream centroid."""
    lost = n - int(masks.sum()) if dropped is None else dropped
    if lost:
        raise ValueError(
            f"pack={pack!r} dropped {lost} of {n} points (packed mask counts "
            f"{n - lost}): subset capacity or a2a slack is too small for "
            "this partition's skew")


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


def _merge(res: KMeansResult, cfg: IPKMeansConfig) -> torch.Tensor:
    m, k, d = res.centroids.shape
    if cfg.merge == "hierarchical":
        return merge.hierarchical_merge(res.centroids.reshape(m * k, d), k)
    return merge.min_asse_merge(res.centroids, res.asse)


def _merge_stage(points: torch.Tensor, res: KMeansResult,
                 cfg: IPKMeansConfig):
    final = _merge(res, cfg)
    return final, metrics.sse(points, final)


def _resolve_init_stage(points: torch.Tensor, init_centroids,
                        cfg: IPKMeansConfig, draws=None,
                        generator: torch.Generator | None = None, mesh=None,
                        axis_names: tuple[str, ...] = ("data",),
                        device=None):
    """The seeding stage: with ``cfg.init`` other than ``"given"``, the
    shared per-reducer seeds drawn from the whole dataset -> ``(seeds,
    cfg.with_init("given"))``; otherwise the given seeds and ``cfg``.  With
    ``mesh`` the k-means|| sweeps run sharded over ``axis_names``
    (``init.kmeans_parallel_init``) and the seeds land on ``device``."""
    if cfg.init == "given":
        if init_centroids is None:
            raise ValueError('cfg.init="given" needs init_centroids')
        return init_centroids, cfg
    seeds = resolve_init(points, cfg.num_clusters, cfg.init,
                         backend=_init_backend(cfg.kmeans.backend),
                         draws=draws, generator=generator, mesh=mesh,
                         axis_names=axis_names, device=device)
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


# ------------------------------------------------------------ on a mesh ---

def _check_distributed(cfg: IPKMeansConfig, mesh, axis_names, pod_axis):
    """The reference's validations of ``ipkmeans_distributed``, with its
    messages."""
    n_dev = sharding.axis_size(mesh, axis_names)
    if cfg.num_subsets % n_dev:
        raise ValueError(
            f"num_subsets={cfg.num_subsets} not divisible by mesh size "
            f"{n_dev}")
    names = tuple(mesh.mesh_dim_names)
    if pod_axis is not None:
        if pod_axis in axis_names or pod_axis not in names:
            raise ValueError(
                f"pod_axis={pod_axis!r} must be a mesh axis outside "
                f"axis_names={axis_names} (mesh has {names})")
        if cfg.kmeans.reseed_empty:
            raise ValueError(
                "reseed_empty is not supported on the cross-pod S2 path: "
                "farthest-point selection needs a global view of the "
                "subset, but points are sharded over the pod axis")
    elif cfg.reduce != "exact":
        raise ValueError(
            f"reduce={cfg.reduce!r} needs pod_axis: compressed reduction "
            f"acts on the cross-pod stats all-reduce, and without a pod "
            f"axis S2 has no reduction at all (the paper's claim)")


def a2a_pod_capacity(capacity: int, n_pods: int) -> int:
    """The pod a2a pack's capacity: each pod's share of a subset
    fluctuates around ``capacity / n_pods``, so the per-pod slice gets the
    send slots' slack-plus-4-sigma headroom, rounded up to a multiple of 8;
    the capacity is that slice times the pods (the reference's
    ``_partition_and_pack``)."""
    mean = capacity / n_pods
    cap_loc = max(8, -(-int(mean * 1.3 + 4 * math.sqrt(mean)) // 8) * 8)
    return cap_loc * n_pods


def _partition_and_pack_distributed(host, whole, cfg: IPKMeansConfig, mesh,
                                    axis_names, pod_axis, dev, *,
                                    draws=None, generator=None):
    """S1 on the mesh -> ``(partition, this rank's subsets, masks)`` in the
    layout of ``sharding.subset_specs``.

    ``cfg.s1`` ``"histogram"`` with ``partition="kd_axis"`` runs sharded,
    the points in row blocks over ``(pod_axis,) + axis_names``
    (``"auto"`` is ``"histogram"`` with a pod axis, else ``"sort"``); any
    other S1 runs on the whole array on every rank (``whole()``), as the
    reference leaves it global.  ``pack="a2a"`` exchanges the points once
    (``kdtree.pack_subsets_a2a``; with pods, the capacity of
    ``a2a_pod_capacity``); ``"scatter"`` and ``"sorted"`` pack this rank's
    subsets from the global points by the global ids (all-gathered after a
    sharded S1).  The pack's count of lost points is checked either way.
    """
    s1 = cfg.s1
    if s1 == "auto":
        s1 = "histogram" if pod_axis is not None else "sort"
    point_axes = ((pod_axis,) + axis_names) if pod_axis else axis_names
    sharded = s1 == "histogram" and cfg.partition == "kd_axis"
    n = host.shape[0]
    m = cfg.num_subsets
    capacity = cfg.subset_capacity(n)
    if sharded:
        part = kdtree.partition_dataset(
            host, m, leaf_capacity=cfg.leaf_capacity, strategy=cfg.partition,
            label_axis=cfg.label_axis, builder="histogram",
            labeler="histogram", mesh=mesh, axis_names=point_axes,
            device=dev)
    else:
        part = kdtree.partition_dataset(
            whole(), m, leaf_capacity=cfg.leaf_capacity,
            strategy=cfg.partition, label_axis=cfg.label_axis, builder=s1,
            labeler=s1, draws=draws, generator=generator)
    if cfg.pack == "a2a":
        if pod_axis is not None:
            capacity = a2a_pod_capacity(
                capacity, sharding.axis_size(mesh, pod_axis))
        ids = (part.subset_ids if sharded else sharding.s1_point_spec(
            axis_names, pod_axis).local(mesh, part.subset_ids))
        subsets, masks, dropped = kdtree.pack_subsets_a2a(
            host, ids, m, capacity, mesh, axis_names, pod_axis=pod_axis,
            device=dev)
    else:
        ids = part.subset_ids
        if sharded:
            ids = torch.cat(comm.all_gather_ragged(
                ids, comm.group(mesh, point_axes)))
        source = host if sharded else whole()
        subsets, masks, dropped = kdtree.pack_local(
            source, ids, m, capacity, mesh, axis_names, pod_axis,
            sort=cfg.pack == "sorted" and n == m * capacity, device=dev)
    _check_pack_complete(n, masks, cfg.pack, dropped)
    return part, subsets, masks


def _gather_results(res: KMeansResult, grp) -> KMeansResult:
    """Every rank's block of per-subset results, in rank order, through
    ONE all-gather of their bytes."""
    fields = [t.contiguous() for t in res]
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in fields])
    every = comm.all_gather(flat, grp)
    out, off = [], 0
    for t in fields:
        nb = t.numel() * t.element_size()
        blocks = [every[r, off:off + nb].clone().view(t.dtype).reshape(t.shape)
                  for r in range(every.shape[0])]
        out.append(torch.cat(blocks))
        off += nb
    return KMeansResult(*out)


def _s2_cross_pod_solve(sub: torch.Tensor, msk: torch.Tensor,
                        init_centroids: torch.Tensor, cfg: IPKMeansConfig,
                        grp):
    """S2 of this rank when each subset's points are in blocks over the
    pods: ``sub (M_loc, S_loc, d)``, ``msk (M_loc, S_loc)``, its subsets'
    slice of points, and ``grp`` the pod group.

    Each Lloyd iteration runs one ``engine.step`` on the lanes still
    active and reduces their (sums, counts) over the pods: ONE f32
    all-reduce (``reduce="exact"``), or the int8 error-feedback all-gather
    (``"int8ef"``, per-row scales; the residual of every lane is carried
    across iterations).  Every pod receives the same stats, so the lanes'
    convergence, and their iteration counts, agree without more traffic.
    With ``int8ef`` each active lane's stop threshold widens to the noise
    floor of the quantized reduction, ``sqrt(d)`` times its largest
    per-cluster centroid error ``(err_S + |c| err_N) / (N - err_N)`` (the
    reference's rule: a tol under the wire precision would spin to
    ``max_iters``).  The state is f32 throughout, as in the reference.
    Then the SSE and the point count of each subset, all-reduced over the
    pods.  -> ``(centroids (M_loc,k,d) f32, sse, asse, iters i32,
    converged)``, the same on every pod.
    """
    params = cfg.kmeans
    engine = engines.get_engine(params.backend)
    m_loc, _, d = sub.shape
    x = sub.float()
    w = msk.float()
    c0 = init_centroids.float()
    residual = compress.init_ef({"sums": c0.expand(m_loc, -1, -1),
                                 "counts": c0[:, 0].expand(m_loc, -1)}
                                ).residual
    axes = {"sums": -1, "counts": -1}
    sqrt_d = torch.sqrt(torch.tensor(float(d), device=sub.device))

    def exact(sums, counts, sel):
        buf = comm.all_reduce(torch.cat([sums.reshape(-1),
                                         counts.reshape(-1)]), grp)
        return (buf[:sums.numel()].view(sums.shape),
                torch.clamp(buf[sums.numel():].view(counts.shape), min=0.0),
                None)

    def int8ef(sums, counts, sel):
        state = compress.EFState({key: r[sel] for key, r in residual.items()})
        red, state, err = compress.ef_allreduce(
            {"sums": sums, "counts": counts}, state, grp, axes=axes,
            return_error_bound=True)
        for key, r in state.residual.items():
            residual[key][sel] = r
        cnt = torch.clamp(red["counts"], min=0.0)
        # the noise floor: sqrt(d) times the largest per-cluster error of
        # the divided centroids (the divide's result where cnt > 0)
        e_s = err["sums"][..., 0]                             # (L, k)
        e_n = err["counts"]                                   # (L, 1)
        upd = red["sums"] / torch.clamp(cnt, min=1.0).unsqueeze(-1)
        cmax = torch.amax(torch.abs(upd), dim=-1)             # (L, k)
        noise = torch.where(
            cnt > 0.0,
            (e_s + cmax * e_n) / torch.clamp(cnt - e_n, min=1.0), 0.0)
        floor = sqrt_d * torch.amax(noise, dim=-1)
        return red["sums"], cnt, torch.clamp(floor, min=params.tol)

    c, iters, conv = engine.lloyd_loop(
        x, c0, w, max_iters=params.max_iters, tol=params.tol,
        reduce=int8ef if cfg.reduce == "int8ef" else exact)
    # the final scoring pass at the converged centroids, like engine.solve
    both = comm.all_reduce(torch.cat([engine.sse(x, c, w),
                                      torch.sum(w, dim=1)]), grp)
    sse, cnt = both[:m_loc], both[m_loc:]
    asse = torch.where(cnt > 0.0, sse / torch.clamp(cnt, min=1.0), torch.inf)
    return c, sse, asse, iters, conv


def ipkmeans_distributed(points, init_centroids, cfg: IPKMeansConfig, mesh,
                         axis_names: tuple[str, ...] = ("data",),
                         pod_axis: str | None = None, *, draws=None,
                         partition_draws=None,
                         generator: torch.Generator | None = None,
                         device=None) -> IPKMeansResult:
    """IPKMeans on a mesh of ranks (``distributed/sharding.py``); every rank
    calls it with the same global ``points`` (numpy, or a tensor, best on
    the CPU) and the same seeds, draws and config, and gets the same
    result.

    A rank moves to ``device`` (default: CUDA) only what it owns: its row
    block of the points for the stages the reference shards (the sharded
    S1, the a2a pack, the k-means|| sweeps, the S3 SSE) and its subsets'
    points; the whole array only for the stages the reference leaves global
    (the sort S1, and seeding with ``"sample"`` or ``"kmeans++"``).

    S2 runs this rank's ``M / P`` subsets (``P`` ranks along
    ``axis_names``) through ``kmeans_batched`` with NO collective: on
    ``backend="batched"`` one whole-solve launch a rank.  Then one
    all-gather of the per-subset results, and S3 on every rank.  The
    collectives are counted by stage in ``distributed.comm`` ("init",
    "s1", "s2", "s3").

    With ``pod_axis`` (a mesh axis outside ``axis_names``, e.g. from
    ``sharding.kmeans_pod_mesh``), each subset's points are also in blocks
    over that axis and S2 is the cross-pod solve: one (sums, counts)
    reduction over the pods each Lloyd iteration, ``cfg.reduce`` deciding
    how (``_s2_cross_pod_solve``).  The subset capacity is padded to a
    multiple of the pod count.

    ``num_subsets`` must be a multiple of the ranks along ``axis_names``;
    ``reduce`` other than ``"exact"`` needs a pod axis, and the pod axis
    ``reseed_empty=False``: the reference's ``ValueError`` otherwise.
    Seeding (``init`` other than ``"given"``) consumes ``draws`` or
    ``generator`` as ``ipkmeans`` does; ``"kmeans||"`` sweeps row blocks
    over ``axis_names``.
    """
    check_config(cfg)
    axis_names = tuple(axis_names)
    _check_distributed(cfg, mesh, axis_names, pod_axis)
    dev = resolve_device(device)
    host = points if isinstance(points, torch.Tensor) else \
        as_float(points, torch.device("cpu"))
    kept = {}

    def whole() -> torch.Tensor:
        if "x" not in kept:
            kept["x"] = as_float(host, dev)
        return kept["x"]

    with comm.stage("init"):
        seeds, cfg = _resolve_init_stage(
            host, init_centroids, cfg, draws, generator, mesh=mesh,
            axis_names=axis_names, device=dev)
    seeds = as_float(seeds, dev)
    with comm.stage("s1"):
        part, subsets, masks = _partition_and_pack_distributed(
            host, whole, cfg, mesh, axis_names, pod_axis, dev,
            draws=partition_draws, generator=generator)
    with comm.stage("s2"):
        if pod_axis is None:
            res = kmeans_batched(subsets, masks, seeds, cfg.kmeans,
                                 device=dev)
        else:
            c, sse, asse, iters, conv = _s2_cross_pod_solve(
                subsets, masks, seeds, cfg, comm.group(mesh, pod_axis))
            res = KMeansResult(c.to(seeds.dtype), sse, asse, iters, conv)
    with comm.stage("s3"):
        res = _gather_results(res, comm.group(mesh, axis_names))
        final = _merge(res, cfg)
        point_axes = ((pod_axis,) + axis_names) if pod_axis else axis_names
        rows = sharding.s1_point_spec(axis_names, pod_axis).slices(
            mesh, host.shape)[0]
        x = kept["x"][rows] if "x" in kept else as_float(host[rows], dev)
        total = comm.all_reduce(metrics.sse_f32(x, final), comm.group(
            mesh, point_axes)).to(torch.promote_types(x.dtype, final.dtype))
    return IPKMeansResult(centroids=final, sse=total,
                          intermediate=res.centroids, asses=res.asse,
                          subset_iters=res.iters, kd_depth=part.depth)
