"""The rank side of ``tests/test_torch_distributed.py``: what each rank of
the test's world runs.  Imports only torch, numpy and ``repro_torch`` (the
ranks never import JAX); the test compares what comes back with the JAX
reference in the parent process.

``run(rank, world_size, device, path)`` reads the inputs the test wrote to
``path`` (an ``.npz``), runs every scenario on a flat ``(4,)`` mesh and a
``(2, 2)`` pod mesh, and returns a dict of CPU tensors, numbers and error
messages, one entry a scenario.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import kdtree
from repro_torch.core.init import KMeansParallelDraws, kmeans_parallel_init
from repro_torch.core.ipkmeans import (IPKMeansConfig,
                                       _partition_and_pack_distributed,
                                       _s2_cross_pod_solve,
                                       ipkmeans_distributed)
from repro_torch.core.kmeans import KMeansParams
from repro_torch.core.pkmeans import pkmeans_sharded
from repro_torch.distributed import comm, compress, sharding

K, M_FLAT, M_POD = 5, 24, 8
SORTED_N = 2048
PK_PARAMS = KMeansParams(max_iters=30)


def flat_cfg(**kw) -> IPKMeansConfig:
    return IPKMeansConfig(num_clusters=K, num_subsets=M_FLAT, **kw)


def sorted_cfg() -> IPKMeansConfig:
    """M = 8 subsets of exactly 256 of the first SORTED_N points (depth 8),
    so the sorted pack applies; seeds drawn by ``init="sample"``."""
    return IPKMeansConfig(num_clusters=K, num_subsets=M_POD, pack="sorted",
                          kmeans=KMeansParams(init="sample"))


def pod_cfg(reduce: str = "exact") -> IPKMeansConfig:
    return IPKMeansConfig(num_clusters=K, num_subsets=M_POD, reduce=reduce)


def _cpu(res) -> dict:
    return {f: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for f, v in res._asdict().items()}


def _solve(pts, init, cfg, mesh, axes, pod=None, **kw) -> dict:
    comm.reset()
    res = ipkmeans_distributed(pts, init, cfg, mesh, axes, pod, device="cpu",
                               **kw)
    return {**_cpu(res), "comm": comm.read()}


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _s1_cases(z, mesh, axes) -> list:
    out = []
    for case in ("ties", "equal"):
        pts = torch.from_numpy(z[f"s1_{case}"])
        for depth in (0, 3):
            r = kdtree.build_kdtree_histogram_sharded(pts, depth, mesh, axes)
            lab = kdtree.label_regions_histogram_sharded(
                pts, torch.from_numpy(z[f"s1_{case}_region{depth}"])[
                    sharding.Layout(axes).slices(mesh, pts.shape)[0]],
                2 ** depth, 4, mesh, axes)
            out.append((case, depth, r, lab))
    return out


def run(rank: int, world_size: int, device, path: str) -> dict:
    z = np.load(path)
    pts, init = z["pts"], z["init"]
    out = {}

    flat = sharding.kmeans_data_mesh(world_size)
    axes = (sharding.KMEANS_DATA_AXIS,)
    out["flat"] = _solve(pts, init, flat_cfg(), flat, axes)
    out["flat_a2a"] = _solve(pts, init, flat_cfg(pack="a2a", s1="histogram"),
                             flat, axes)
    draws = KMeansParallelDraws(*(torch.from_numpy(z[f"kpar_{f}"])
                                  for f in KMeansParallelDraws._fields))
    out["flat_kpar"] = _solve(pts, None, flat_cfg().with_init("kmeans||"),
                              flat, axes, draws=draws)
    out["flat_sorted"] = _solve(pts[:SORTED_N], None, sorted_cfg(), flat,
                                axes, draws=z["sample_u"])
    seeds, stats = kmeans_parallel_init(
        torch.from_numpy(pts), K, backend="plain", draws=draws,
        return_stats=True, mesh=flat, axis_names=axes)
    out["kpar_seeds"] = dict(seeds=seeds, psi=stats["psi"],
                             candidates=stats["candidates"])
    comm.reset()
    pk = pkmeans_sharded(flat, axes, PK_PARAMS)(
        pts, init, z["pk_mask"], device="cpu")
    out["pkmeans"] = {**_cpu(pk), "comm": comm.read()}
    out["errors"] = {
        "subsets": _error(lambda: ipkmeans_distributed(
            pts, init, IPKMeansConfig(num_clusters=K, num_subsets=6), flat,
            axes, device="cpu")),
        "pod_in_axes": _error(lambda: ipkmeans_distributed(
            pts, init, flat_cfg(), flat, axes, pod_axis="data",
            device="cpu")),
        "pod_missing": _error(lambda: ipkmeans_distributed(
            pts, init, flat_cfg(), flat, axes, pod_axis="pods",
            device="cpu")),
        "reduce": _error(lambda: ipkmeans_distributed(
            pts, init, flat_cfg(reduce="int8ef"), flat, axes,
            device="cpu")),
        "pk_reseed": _error(lambda: pkmeans_sharded(
            flat, axes, KMeansParams(reseed_empty=True))),
    }

    pod = sharding.kmeans_pod_mesh(2, world_size // 2)
    pod_axis = sharding.KMEANS_POD_AXIS
    out["pod_coord"] = tuple(pod.get_coordinate())
    for reduce in ("exact", "int8ef"):
        out[f"pod_{reduce}"] = _solve(pts, init, pod_cfg(reduce), pod, axes,
                                      pod_axis)
    out["errors"]["pod_reseed"] = _error(lambda: ipkmeans_distributed(
        pts, init, dataclasses.replace(pod_cfg(), kmeans=KMeansParams(
            reseed_empty=True)), pod, axes, pod_axis, device="cpu"))
    # this rank's slice of the pod a2a pack, and the cross-pod solve of it
    # in both modes, for the reference's _s2_cross_pod_solve on the same
    # slices
    comm.reset()
    with comm.stage("s1"):
        _, sub, msk = _partition_and_pack_distributed(
            torch.from_numpy(pts), None, IPKMeansConfig(
                num_clusters=K, num_subsets=M_POD, pack="a2a"), pod, axes,
            pod_axis, torch.device("cpu"))
    out["a2a_pod"] = dict(sub=sub, msk=msk, comm=comm.read())
    for reduce in ("exact", "int8ef"):
        comm.reset()
        c, sse, asse, iters, conv = _s2_cross_pod_solve(
            sub, msk, torch.from_numpy(init), pod_cfg(reduce),
            comm.group(pod, pod_axis))
        out[f"s2_{reduce}"] = dict(c=c, sse=sse, asse=asse, iters=iters,
                                   conv=conv, comm=comm.read())
    out["s1_cases"] = _s1_cases(z, pod, (pod_axis,) + axes)

    # ef_allreduce over the pods, twice, the residual carried
    stats = {"sums": torch.from_numpy(z["ef_sums"][out["pod_coord"][0]]),
             "counts": torch.from_numpy(z["ef_counts"][out["pod_coord"][0]])}
    state = compress.init_ef(stats)
    calls = []
    for _ in range(2):
        comm.reset()
        red, state, err = compress.ef_allreduce(
            stats, state, comm.group(pod, pod_axis),
            axes={"sums": -1, "counts": -1}, return_error_bound=True)
        calls.append(dict(red=red, residual=state.residual, err=err,
                          comm=comm.read()))
    out["ef"] = calls
    return out
