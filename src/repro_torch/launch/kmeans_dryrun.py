"""Dry run of the paper's technique at production scale, the counterpart
of ``repro.launch.kmeans_dryrun``.

The production clustering problem (N = 2^26 points, d = 64, K = 1024,
M = 4096 reducers, 50 iterations) on the 16x16 mesh (256 cards) or, with
``--multi-pod``, 2x16x16 (512).  Nothing runs on a card: the process is rank
0 of a fake world of that many ranks (``distributed/world.fake``), the
cells run the port's own stage functions on fake CUDA tensors, and
``launch/dryrun.py``'s ``Tally`` counts what rank 0 would do: operations,
device-memory bytes, the bytes on the card (inputs and peak), kernel
launches and collectives.  It runs on a host without a card, in seconds.

Cells, one record each (``experiments/dryrun_torch/kmeans-<cell>__<mesh>
[__<backend>][__reseed][__prune].json``, the reference's keys;
``trace_s``, the fake run's seconds, takes the place of ``compile_s``):

  * ``pkmeans-iter``: ONE Lloyd trip of PKMeans on the rank's row block,
    then its all-reduce of (sums, counts) (``pkmeans_sharded``'s trip).
  * ``ipkmeans-s1``, ``-s1-hist``, ``-s1-opt``, ``-s1-a2a`` (the eager
    baseline only; S1 has no Lloyd phase): the k-d tree partition and the
    pack as ``ipkmeans_distributed`` runs them: the sort build on the whole
    array on every rank, or the histogram build on row blocks; then the
    scatter pack, the sorted pack or the all-to-all pack.
  * ``ipkmeans-s2s3``: the rank's M / P subsets through ``kmeans_batched``,
    the gather of the results, the min-ASSE merge and the S3 SSE.
    ``collectives_in_solver_loop`` counts the collectives of the S2 stage:
    the paper's claim is that there are none.
  * ``--pods P``: ``ipkmeans-s2-xpod<P>-<reduce>`` (each subset's points
    over the pod axis, one (sums, counts) reduction a trip, the modelled
    DCN bytes beside it) and, on the eager baseline,
    ``ipkmeans-s1-xpod<P>`` (the histogram S1 on row blocks over
    (pods, data) and the pod all-to-all pack; its reductions must stay
    within 4x the O(R * 256) histogram model, or it raises).
  * ``--init``: ``ipkmeans-init-round``, one k-means|| sweep a shard on a
    (2K, d) candidate tile, the potential's all-reduce and the drawn rows'
    gather.

A loop counts ONE trip, as XLA's cost analysis counts a loop body once:
the host-loop engines (``eager``, ``twopass``, ``fused``) run one trip of
``LloydEngine.lloyd_loop``'s body (every lane active; with the reseed, the
reseed's assign pass on every lane, as the reference's select computes
both branches), and the whole-solve engines (``resident``, ``batched``,
``tuned``) count one score pass a lane.  The fake tensors cannot be read
back, so where the port reads a size from the data (the pack's kept rows,
the gathered id blocks, the all-to-all's send slots) the cell uses the
balanced size the k-d tree's medians give, and says so in its note.

    python -m repro_torch.launch.kmeans_dryrun [--backend batched]
        [--reseed-empty] [--prune bounds] [--init] [--pods 2]
        [--reduce int8ef] [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path
from typing import NamedTuple

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core import io_model, kdtree, merge, metrics
from repro_torch.core.ipkmeans import (IPKMeansConfig, _gather_results,
                                       a2a_pod_capacity, cross_pod_reduce)
from repro_torch.core.kmeans import KMeansParams, KMeansResult, _asse, \
    kmeans_batched
from repro_torch.core.pkmeans import stats_all_reduce
from repro_torch.device import as_float
from repro_torch.distributed import comm, sharding, world
from repro_torch.kernels import batch_resident, ref
from repro_torch.kernels import engine as engines
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

# production clustering problem (embedding-table scale)
N, D, K, M = 1 << 26, 64, 1024, 4096
MAX_ITERS = 50
TOL = 1e-6

DEV = torch.device("cuda", 0)     # every rank's card, fake
HOST = torch.device("cpu")

# the engines whose solve is one whole-solve launch (where it fits)
WHOLE_SOLVE = ("resident", "batched", "tuned")
TRIP = ("counts ONE Lloyd trip (XLA's cost analysis counts a loop body "
        "once); total = iters x the trip")


class Shape(NamedTuple):
    n: int = N
    d: int = D
    k: int = K
    m: int = M
    max_iters: int = MAX_ITERS


def _trip(engine, x, c0, w, *, reduce=None, reseed_empty=False):
    """One trip of ``LloydEngine.lloyd_loop``'s body with every lane
    active: step, the ``reduce`` hook, divide, the reseed, the shift ->
    ``(centroids (L, k, d) f32, shift (L,))``."""
    m = x.shape[0]
    k, d = c0.shape[-2:]
    carry = c0.dtype
    c = torch.empty((m, k, d), dtype=torch.float32, device=x.device)
    c.copy_(c0)
    lanes = torch.arange(m, dtype=torch.int32, device=x.device)
    sums, counts, _ = engine.step(x, c, w, lanes)
    if reduce is not None:
        sums, counts, _ = reduce(sums, counts, lanes.long())
    new = ref.divide_or_keep(sums, counts, c).to(carry).float()
    if reseed_empty:
        # engine.reseed_empty_clusters with every lane scored: its host
        # test of which lanes need it reads the data
        _, mind = engine.assign(x, new, lanes)
        wt = torch.ones_like(mind) if w is None else w
        score = torch.where(wt > 0.0, mind, -torch.inf)
        take, rows = ref.reseed_rows(score, counts <= 0.0,
                                     min(k, x.shape[1]))
        picks = x[lanes.long().unsqueeze(1), rows].to(carry)
        new = torch.where(take.unsqueeze(-1), picks.float(), new)
    return new, metrics.centroid_shift(new, c)


def _host_loop_solve(engine, x, w, c0, params: KMeansParams):
    """``LloydEngine.solve_batched`` at one trip: the trip, then the final
    scoring pass -> ``KMeansResult``."""
    c, shift = _trip(engine, x, c0, w, reseed_empty=params.reseed_empty)
    sse = engine.sse(x, c, w)
    cnt = torch.sum(w, dim=1)
    iters = torch.ones(x.shape[0], dtype=torch.int32, device=x.device)
    return KMeansResult(c.to(c0.dtype), sse, _asse(sse, cnt), iters,
                        shift <= params.tol)


def _whole_solve(backend: str, s: int, d: int, k: int, prune: str) -> bool:
    return backend in WHOLE_SOLVE and batch_resident.batched_feasible(
        s, d, k, prune, device=DEV)


def _gather_ids(ids, grp):
    """``comm.all_gather_ragged`` of equal blocks: the lengths, then the
    blocks (n divides over the ranks, so no block is padded)."""
    comm.all_gather(torch.tensor([ids.shape[0]], dtype=torch.int64,
                                 device=ids.device), grp)
    return comm.all_gather(ids, grp).reshape(-1)


def _pack_all(x, ids, m, cap):
    """``kdtree.pack_subsets`` where every point fits its subset (no
    subset holds more than ``cap``), without the mask of kept rows."""
    order = torch.sort(ids, stable=True).indices
    sub, rank, _ = kdtree._segment_rank(ids, order, m)
    out = torch.zeros((m, cap, x.shape[1]), dtype=x.dtype, device=x.device)
    msk = torch.zeros((m, cap), dtype=torch.bool, device=x.device)
    out[sub, rank] = x[order]
    msk[sub, rank] = True
    return out, msk


def _pack_local(points, ids, m, cap, mesh, axes, pod_axis, sort):
    """``kdtree.pack_local`` of balanced subsets (each holds n / m points,
    as the k-d tree's medians give when n is m times a power of two): this
    rank's subsets' rows are a block of the ids' stable order."""
    n, d = points.shape
    ids = ids.to(DEV).long()
    n_pods = sharding.axis_size(mesh, pod_axis)
    padded = cap + -cap % n_pods
    m_blk, c_blk, _ = sharding.subset_specs(axes, pod_axis)[0].slices(
        mesh, (m, padded, d))
    m_loc = m_blk.stop - m_blk.start
    per = n // m
    order = torch.sort(ids, stable=True).indices
    rows = torch.sort(order[m_blk.start * per:m_blk.stop * per]).values
    x = points[rows.to(points.device)].to(DEV)
    local = ids[rows] - m_blk.start
    if sort:
        out, msk = kdtree.pack_subsets_sorted(x, local, m_loc, cap)
    else:
        out, msk = _pack_all(x, local, m_loc, cap)
    if padded > cap:
        out = torch.nn.functional.pad(out, (0, 0, 0, padded - cap))
        msk = torch.nn.functional.pad(msk, (0, padded - cap))
    if pod_axis is not None:
        out, msk = out[:, c_blk].contiguous(), msk[:, c_blk].contiguous()
    return out, msk


def _pack_a2a(points, ids, m, cap, mesh, axes, pod_axis, slack=1.3):
    """``kdtree.pack_subsets_a2a`` when every point fits its send slots:
    the same two all-to-alls and count all-reduce; the re-pack writes the
    empty slots to a spare row that is cut off, in place of the mask."""
    n, d = points.shape
    r = sharding.axis_size(mesh, axes)
    n_pods = sharding.axis_size(mesh, pod_axis) if pod_axis else 1
    if m % r or n % (r * n_pods) or cap % n_pods:
        raise ValueError(f"the a2a pack needs m={m} over {r} in-pod ranks, "
                         f"n={n} over {r * n_pods} ranks and capacity {cap} "
                         f"over {n_pods} pods")
    x, _ = kdtree._point_block(points, mesh, axes, pod_axis, DEV)
    ids = ids.to(DEV).long()
    m_loc, cap_loc = m // r, cap // n_pods
    mean = n // (r * n_pods) / r
    c_send = max(8, -(-int(mean * slack + 4 * math.sqrt(mean)) // 8) * 8)
    dst = ids // m_loc
    order = torch.sort(dst, stable=True).indices
    _, slot_sorted, _ = kdtree._segment_rank(dst, order, r)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    send_x = torch.zeros((r, c_send, d), dtype=x.dtype, device=DEV)
    send_id = torch.full((r, c_send), -1, dtype=torch.int64, device=DEV)
    send_x[dst, slot] = x
    send_id[dst, slot] = ids
    grp = comm.group(mesh, axes)
    flat_x = comm.all_to_all_single(send_x, grp).reshape(r * c_send, d)
    flat_id = comm.all_to_all_single(send_id, grp).reshape(r * c_send)
    local = torch.where(flat_id >= 0, flat_id % m_loc, m_loc)
    order2 = torch.sort(local, stable=True).indices
    _, rank_sorted, _ = kdtree._segment_rank(local, order2, m_loc + 1)
    rank = torch.empty_like(rank_sorted)
    rank[order2] = rank_sorted
    valid = (flat_id >= 0) & (rank < cap_loc)
    out = torch.zeros((m_loc + 1, cap_loc + 1, d), dtype=x.dtype, device=DEV)
    msk = torch.zeros((m_loc + 1, cap_loc + 1), dtype=torch.bool, device=DEV)
    sub = torch.where(valid, local, m_loc)
    row = torch.where(valid, rank, cap_loc)
    out[sub, row] = flat_x
    msk[sub, row] = valid
    out, msk = out[:m_loc, :cap_loc], msk[:m_loc, :cap_loc]
    all_axes = ((pod_axis,) + tuple(axes)) if pod_axis else tuple(axes)
    comm.all_reduce(msk.sum().reshape(1), comm.group(mesh, all_axes))
    return out, msk


def s1_stage(host, shape: Shape, mesh, axes, pod_axis=None, *,
             builder="sort", pack="scatter"):
    """S1 on this rank, as ``ipkmeans._partition_and_pack_distributed``
    runs it: the ``"histogram"`` build and labeler on row blocks over
    ``(pod_axis,) + axes``, or the ``"sort"`` pair on the whole array on
    the card; then ``pack`` (``"scatter"`` | ``"sorted"`` | ``"a2a"``).
    ``host`` holds the global points on the host.  -> ``(subsets,
    masks)`` of this rank."""
    axes = tuple(axes)
    n = host.shape[0]
    m = shape.m
    point_axes = ((pod_axis,) + axes) if pod_axis else axes
    cap = IPKMeansConfig(num_clusters=shape.k, num_subsets=m
                         ).subset_capacity(n)
    with comm.stage("s1"):
        if builder == "histogram":
            part = kdtree.partition_dataset(
                host, m, builder="histogram", labeler="histogram",
                mesh=mesh, axis_names=point_axes, device=DEV)
        else:
            whole = as_float(host, DEV)
            part = kdtree.partition_dataset(whole, m, builder=builder,
                                            labeler=builder)
        ids = part.subset_ids
        if pack == "a2a":
            if pod_axis is not None:
                cap = a2a_pod_capacity(cap, sharding.axis_size(mesh,
                                                               pod_axis))
            if builder != "histogram":
                ids = sharding.s1_point_spec(axes, pod_axis).local(mesh, ids)
            return _pack_a2a(host, ids, m, cap, mesh, axes, pod_axis)
        if builder == "histogram":
            ids = _gather_ids(ids, comm.group(mesh, point_axes))
        return _pack_local(host if builder == "histogram" else whole, ids, m,
                           cap, mesh, axes, pod_axis,
                           sort=pack == "sorted" and n == m * cap)


def _s3_sse(host, final, mesh, axes, pod_axis=None):
    """S3's SSE: this rank's row block against the merged centroids, one
    all-reduce (``ipkmeans_distributed``)."""
    point_axes = ((pod_axis,) + tuple(axes)) if pod_axis else tuple(axes)
    rows = sharding.s1_point_spec(axes, pod_axis).slices(mesh, host.shape)[0]
    x = as_float(host[rows], DEV)
    return comm.all_reduce(metrics.sse_f32(x, final),
                           comm.group(mesh, point_axes))


def s2s3_stage(sub, msk, c0, host, mesh, axes, params: KMeansParams):
    """S2 of this rank's subsets (``kmeans_batched``; a host-loop engine at
    one trip), then S3: the gather of every rank's results, the min-ASSE
    merge and the SSE.  -> ``(centroids, sse)``."""
    engine = engines.get_engine(params.backend)
    _, s, d = sub.shape
    with comm.stage("s2"):
        if _whole_solve(params.backend, s, d, c0.shape[-2], params.prune):
            res = kmeans_batched(sub, msk, c0, params, device=DEV)
        else:
            res = _host_loop_solve(engine, sub.float(), msk.float(), c0,
                                   params)
    with comm.stage("s3"):
        res = _gather_results(res, comm.group(mesh, axes))
        final = merge.min_asse_merge(res.centroids, res.asse)
        return final, _s3_sse(host, final, mesh, axes)


def s2_xpod_stage(sub, msk, c0, host, pmesh, cfg: IPKMeansConfig):
    """The cross-pod S2 of this rank at one trip (``_s2_cross_pod_solve``:
    the trip's reduction over the pods in stage "s2", the final SSE's in
    "s2-sse"), then S3 over the pod mesh.  -> ``(centroids, sse)``."""
    pod, data = sharding.KMEANS_POD_AXIS, (sharding.KMEANS_DATA_AXIS,)
    engine = engines.get_engine(cfg.kmeans.backend)
    grp = comm.group(pmesh, pod)
    m_loc = sub.shape[0]
    x, w, c0f = sub.float(), msk.float(), c0.float()
    with comm.stage("s2"):
        c, shift = _trip(engine, x, c0f, w,
                         reduce=cross_pod_reduce(cfg, c0f, m_loc, grp))
    with comm.stage("s2-sse"):
        both = comm.all_reduce(torch.cat([engine.sse(x, c, w),
                                          torch.sum(w, dim=1)]), grp)
        sse, cnt = both[:m_loc], both[m_loc:]
    res = KMeansResult(c.to(c0.dtype), sse, _asse(sse, cnt),
                       torch.ones(m_loc, dtype=torch.int32, device=DEV),
                       shift <= cfg.kmeans.tol)
    with comm.stage("s3"):
        res = _gather_results(res, comm.group(pmesh, data))
        final = merge.min_asse_merge(res.centroids, res.asse)
        return final, _s3_sse(host, final, pmesh, data, pod)


def pkmeans_trip(host, c0, mesh, axes, backend: str):
    """One trip of ``pkmeans_sharded`` on this rank's row block."""
    engine = engines.get_engine(backend)
    rows = sharding.s1_point_spec(axes, None)
    x = as_float(rows.local(mesh, host), DEV).float().unsqueeze(0)
    c, _ = _trip(engine, x, c0, None,
                 reduce=stats_all_reduce(comm.group(mesh, axes)))
    return c[0]


def init_round_stage(host, cands, mind, u, w, psi_prev, mesh, axes,
                     backend: str):
    """One sharded k-means|| round (``init.oversample`` with a shard): the
    sweep on this rank's row block, the potential's all-reduce, and the
    gather of the drawn rows, ``ell / P`` of them a rank (the expected
    draw; the real count is the data's)."""
    from repro_torch.core.init import _sweep
    sweep = _sweep("plain" if backend == "eager" else "kernel")
    grp = comm.group(mesh, axes)
    x = as_float(sharding.s1_point_spec(axes, None).local(mesh, host), DEV)
    ell = float(cands.shape[0])
    with comm.stage("init"):
        mind, _, psi = sweep(x, cands, mind, u, psi_prev, ell=ell, weights=w)
        psi = comm.all_reduce(psi, grp)
        drawn = torch.zeros(-(-int(ell) // comm.size(grp)),
                            dtype=torch.int64, device=DEV)
        _gather_ids(drawn, grp)
    return mind, psi


def check_s1_summaries(coll: dict, depth: int, n_dev: int) -> int:
    """The reference's hard check on the sharded S1: every collective but
    the all-to-all (the pack, which moves each point once) carries O(R *
    256) summaries, within 4x ``io_model.s1_histogram_dcn_bytes``; raises
    ``RuntimeError`` otherwise.  ``coll``: ``dryrun.collective_bytes()``.
    -> the summaries' bytes."""
    summary = sum(v for op, v in coll.items()
                  if op not in ("all-to-all", "_counts"))
    bound = 4 * io_model.s1_histogram_dcn_bytes(depth, n_dev)
    if summary > bound:
        raise RuntimeError(
            f"sharded S1 reduction collectives move {summary} bytes > 4x "
            f"the histogram model ({bound}): a sort/gather-shaped "
            f"exchange leaked into the sharded build")
    return summary


def _card_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type != "cpu")


def trace(fn, make_args):
    """Run ``fn(*make_args())`` traced, the collective counts set to 0
    first -> ``(tally, output bytes, seconds, collective_bytes, counts by
    stage)``."""
    tally = dryrun.Tally()
    comm.reset()
    t0 = time.perf_counter()
    with dryrun.traced(tally):
        args = make_args()
        tally.argument(args)
        out_bytes = _card_bytes(fn(*args))
    return (tally, out_bytes, time.perf_counter() - t0,
            dryrun.collective_bytes(), comm.read())


def _record(name, mesh_tag, shape: Shape, traced, extra):
    tally, out_bytes, secs, coll, stages = traced
    counts = coll.pop("_counts", {})
    total_coll = sum(coll.values())
    rec = {
        "arch": f"kmeans-{name}",
        "shape": f"n{shape.n}_d{shape.d}_k{shape.k}_m{shape.m}",
        "mesh": mesh_tag, "status": "ok",
        "flops": tally.flops, "bytes_accessed": tally.bytes,
        "collective_bytes": coll, "collective_counts": counts,
        "roofline": {
            "compute_s": tally.flops / dryrun.PEAK_FLOPS,
            "memory_s": tally.bytes / dryrun.HBM_BW,
            "collective_s": total_coll / dryrun.LINK_BW,
        },
        "argument_size_in_bytes": tally.arguments,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": tally.peak,
        "trace_s": round(secs, 3),
        "kernel_launches": dict(tally.launches),
        "comm_by_stage": stages,
    }
    rec["roofline"]["dominant"] = max(
        ("compute_s", "memory_s", "collective_s"), key=rec["roofline"].get)
    rec.update(extra)
    return rec


def _mesh_names(shape) -> tuple[str, ...]:
    return {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]


def lower_all(multi_pod: bool = False, backend: str = "eager",
              reseed_empty: bool = False, prune: str = "none",
              init_round: bool = False, pods: int = 0,
              reduce: str = "exact", *, shape: Shape = Shape(),
              mesh_shape: tuple[int, ...] | None = None,
              xpod_pack: str = "a2a", out_dir: Path | None = None,
              verbose: bool = True) -> list[dict]:
    """Trace the dry-run cells, write their records to ``out_dir``
    (default ``dryrun.OUT_DIR``) and return them; ``verbose`` prints each
    record's roofline terms.

    ``backend`` is the Lloyd engine of ``pkmeans-iter`` and the S2 cells
    (``engine.available()``; the reference's ``jnp`` and ``pallas`` are
    ``eager`` and ``twopass``).  The ``eager`` baseline writes no backend
    suffix and alone traces the S1 cells; ``reseed_empty`` suffixes
    ``__reseed`` and ``prune="bounds"`` ``__prune``, as in the reference.
    ``init_round`` adds the k-means|| round, ``pods >= 2`` the cross-pod
    cells with ``reduce`` ("exact" | "int8ef").  ``shape`` and
    ``mesh_shape`` (default: the production mesh; axes ``("data",)``,
    ``("data", "model")`` or ``("pod", "data", "model")`` by rank)
    shrink the problem; ``xpod_pack`` is the cross-pod S1's pack (the
    reference's ``"a2a"``, the only one the S1 bound check applies to)."""
    backend = {"jnp": "eager", "pallas": "twopass"}.get(backend, backend)
    engines.get_engine(backend)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_tag = "x".join(map(str, mesh_shape))
    file_tag = mesh_tag if backend == "eager" else f"{mesh_tag}__{backend}"
    file_tag += "__reseed" if reseed_empty else ""
    file_tag += "__prune" if prune != "none" else ""
    n_dev = math.prod(mesh_shape)
    n, d, k, m = shape.n, shape.d, shape.k, shape.m
    if m % n_dev or n % n_dev:
        raise ValueError(f"m={m} and n={n} must divide over {n_dev} ranks")
    params = KMeansParams(max_iters=shape.max_iters, tol=TOL,
                          backend=backend, reseed_empty=reseed_empty,
                          prune=prune)
    depth = kdtree.required_depth(n, m)
    results = []

    def host():
        return torch.empty((n, d), device=HOST)

    def card(*dims, dtype=torch.float32):
        return torch.empty(dims, dtype=dtype, device=DEV)

    with world.fake(n_dev):
        if mesh_shape == (16, 16) or mesh_shape == (2, 16, 16):
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3)
        else:
            mesh = sharding.make_mesh(tuple(mesh_shape),
                                      _mesh_names(mesh_shape))
        axes = tuple(mesh.mesh_dim_names)

        def cell(name, fn, make_args, extra, tag=mesh_tag):
            rec = _record(name, tag, shape, trace(fn, make_args), extra)
            results.append(rec)
            return rec

        cell("pkmeans-iter",
             lambda h, c: pkmeans_trip(h, c, mesh, axes, backend),
             lambda: (host(), card(k, d)),
             {"note": f"PKMeans on the rank's N/P rows: {TRIP}"})

        if backend == "eager":
            for builder, pack, name, note in (
                    ("sort", "scatter", "ipkmeans-s1",
                     "one-off preprocessing: the sort build and labeler on "
                     "the whole array on every rank (the port's flat path), "
                     "scatter pack"),
                    ("histogram", "scatter", "ipkmeans-s1-hist",
                     "perf C1: histogram build and labeler on row blocks, "
                     "ids all-gathered, scatter pack"),
                    ("histogram", "sorted", "ipkmeans-s1-opt",
                     "perf C2: C1 with the sorted pack"),
                    ("histogram", "a2a", "ipkmeans-s1-a2a",
                     "perf C3: C1 with the all-to-all pack")):
                cell(name, lambda h, b=builder, p=pack: s1_stage(
                         h, shape, mesh, axes, builder=b, pack=p),
                     lambda: (host(),),
                     {"kd_depth": depth,
                      "note": f"{note}; balanced subsets of n/M points "
                              f"(the k-d medians'), every point packed"})

        cap = 2 ** depth
        m_loc = m // n_dev
        rec = cell(
            "ipkmeans-s2s3",
            lambda s_, w_, c_, h: s2s3_stage(s_, w_, c_, h, mesh, axes,
                                             params),
            lambda: (card(m_loc, cap, d), card(m_loc, cap, dtype=torch.bool),
                     card(k, d), host()),
            {"note": f"M={m} reducers, M/P a rank, + gather, min-ASSE merge "
                     f"and S3 SSE; "
                     + ("the whole solve counts one score pass a lane"
                        if _whole_solve(backend, cap, d, k, prune) else TRIP)})
        rec["collectives_in_solver_loop"] = rec["comm_by_stage"].get(
            "s2", {}).get("calls", 0)

        if pods >= 2:
            if n_dev % pods:
                raise ValueError(f"pods={pods} must divide {n_dev} ranks")
            pmesh = sharding.kmeans_pod_mesh(pods, n_dev // pods)
            ptag = f"{pods}x{n_dev // pods}"
            xcfg = IPKMeansConfig(num_clusters=k, num_subsets=m,
                                  reduce=reduce, kmeans=params)
            xcap = cap + -cap % pods
            rec = cell(
                f"ipkmeans-s2-xpod{pods}-{reduce}",
                lambda s_, w_, c_, h: s2_xpod_stage(s_, w_, c_, h, pmesh,
                                                    xcfg),
                lambda: (card(m // (n_dev // pods), xcap // pods, d),
                         card(m // (n_dev // pods), xcap // pods,
                              dtype=torch.bool),
                         card(k, d), host()),
                {"pods": pods, "reduce": reduce,
                 "dcn_bytes_per_pod_modeled":
                     io_model.dcn_reduce_bytes_ipkmeans(
                         m, k, d, shape.max_iters, pods, reduce),
                 "note": f"cross-pod S2 ({reduce}): the in-loop collective "
                         f"IS the per-trip stats reduction (expected "
                         f"nonzero); {TRIP}"}, tag=ptag)
            rec["collectives_in_solver_loop"] = rec["comm_by_stage"].get(
                "s2", {}).get("calls", 0)
            if backend == "eager":
                traced = trace(
                    lambda h: s1_stage(
                        h, shape, pmesh, (sharding.KMEANS_DATA_AXIS,),
                        sharding.KMEANS_POD_AXIS, builder="histogram",
                        pack=xpod_pack),
                    lambda: (host(),))
                extra = {"pods": pods, "kd_depth": depth, "pack": xpod_pack,
                         "s1_histogram_model_bytes":
                             io_model.s1_histogram_dcn_bytes(depth, pods),
                         "note": "cross-pod S1: histogram build + label on "
                                 "row blocks over (pods, data), "
                                 f"{xpod_pack} pack; reductions bounded by "
                                 "the O(R*256) summary model"}
                if xpod_pack == "a2a":
                    extra["s1_summary_collective_bytes"] = \
                        check_s1_summaries(dict(traced[3]), depth, n_dev)
                results.append(_record(f"ipkmeans-s1-xpod{pods}", ptag,
                                       shape, traced, extra))

        if init_round:
            c_tile = 2 * k
            n_loc = n // n_dev
            cell("ipkmeans-init-round",
                 lambda h, *a: init_round_stage(h, *a, mesh, axes, backend),
                 lambda: (host(), card(c_tile, d), card(n_loc), card(n_loc),
                          card(n_loc), card()),
                 {"candidate_tile": c_tile,
                  "note": "ONE k-means|| round: the sweep a shard, the "
                          "potential's all-reduce and the drawn rows' "
                          "gather (ell/P rows a rank, the expected draw); "
                          "seeding = (rounds+1) x this"})

    for rec in results:
        rec["backend"] = backend
        rec["reseed_empty"] = reseed_empty
        rec["prune"] = prune
    _write(results, file_tag,
           dryrun.OUT_DIR if out_dir is None else Path(out_dir), verbose)
    return results


def _write(results, file_tag, out_dir: Path, verbose: bool):
    out_dir.mkdir(parents=True, exist_ok=True)
    for rec in results:
        path = out_dir / f"{rec['arch']}__{file_tag}.json"
        path.write_text(json.dumps(rec, indent=2))
        if verbose:
            rf = rec["roofline"]
            print(f"{rec['arch']:30s} {rec['mesh']}: dom={rf['dominant']:12s}"
                  f" comp={rf['compute_s']:.3e} mem={rf['memory_s']:.3e} "
                  f"coll={rf['collective_s']:.3e} arg="
                  f"{rec['argument_size_in_bytes']:.3e} peak="
                  f"{rec['temp_size_in_bytes']:.3e} B "
                  f"{rec.get('note', '')}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--backend", default="eager",
                    choices=list(engines.available()),
                    help="Lloyd engine traced in the cells")
    ap.add_argument("--reseed-empty", action="store_true",
                    help="S2 with the reseed of empty clusters")
    ap.add_argument("--prune", default="none", choices=["none", "bounds"])
    ap.add_argument("--init", action="store_true",
                    help="also trace ONE k-means|| seeding round")
    ap.add_argument("--pods", type=int, default=0,
                    help="also trace the cross-pod cells on a (pods x "
                         "ranks) pod mesh")
    ap.add_argument("--reduce", default="exact", choices=["exact", "int8ef"],
                    help="the cross-pod S2's stats reduction")
    ap.add_argument("--out-dir", type=Path, default=None,
                    help="where the records go (default "
                         "experiments/dryrun_torch/)")
    args = ap.parse_args(argv)
    lower_all(args.multi_pod, backend=args.backend,
              reseed_empty=args.reseed_empty, prune=args.prune,
              init_round=args.init, pods=args.pods, reduce=args.reduce,
              out_dir=args.out_dir)


if __name__ == "__main__":
    main()
