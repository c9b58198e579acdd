"""The k-means mesh and its row-block layouts, the counterpart of the
k-means part of ``repro.distributed.sharding``.

The IPKMeans mesh is ``(pods x devices)``: the subset ("reducer") axis
shards over the fast in-pod axis ``"data"``, while each subset's POINTS
shard over the pod axis ``"pods"``.  Cross-host traffic is then two kinds of
summary, never the data: S1's O(R * 256) radix histograms per tree round,
and S2's per-iteration (sums, counts) reduction (``compress.ef_allreduce``
compresses it).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the whole
world, ranks in row-major order, so a rank's linear index over the mesh
axes (major to minor) is its global rank.  A :class:`Layout` plays the part
of the reference's ``PartitionSpec``: for each dimension of an array, the
mesh axes that cut it into contiguous blocks (``None``: every rank holds the
whole dimension).  A block is ``ceil(size / parts)`` long, the last ones
shorter or empty, as the reference pads a dimension to a multiple of the
shard count and masks the padding.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

KMEANS_POD_AXIS = "pods"      # the slow (cross-host) axis of a pod mesh
KMEANS_DATA_AXIS = "data"     # the fast in-pod axis: shards the subset dim


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type=None):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the whole
    world, ranks in row-major order.  ``device_type`` defaults to the
    backend's: ``"cuda"`` under NCCL, else ``"cpu"`` (gloo, and the fake
    world of the dry run)."""
    if not dist.is_initialized():
        raise RuntimeError("a k-means mesh needs an initialised process "
                           "group (distributed/world.py starts one)")
    size = 1
    for s in shape:
        size *= s
    if size != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} needs {size} ranks, the world "
                         f"has {dist.get_world_size()}")
    if device_type is None:
        # the device type of the collectives: a gloo world communicates
        # through host memory, whatever device the rank computes on
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=names)


def kmeans_pod_mesh(pods: int, devices_per_pod: int, device_type=None):
    """A ``(pods, devices_per_pod)`` mesh with axes ``("pods", "data")``
    over the whole world (``pods * devices_per_pod`` ranks).  Every rank
    calls it.  ``device_type`` defaults to the backend's: ``"cuda"`` under
    NCCL, ``"cpu"`` under gloo."""
    if pods < 1 or devices_per_pod < 1:
        raise ValueError(f"pods={pods} x devices_per_pod={devices_per_pod} "
                         f"must both be >= 1")
    return make_mesh((pods, devices_per_pod),
                     (KMEANS_POD_AXIS, KMEANS_DATA_AXIS), device_type)


def kmeans_data_mesh(devices: int, device_type=None):
    """The flat ``(devices,)`` mesh, its one axis named ``"data"``."""
    if devices < 1:
        raise ValueError(f"devices={devices} must be >= 1")
    return make_mesh((devices,), (KMEANS_DATA_AXIS,), device_type)


def axis_size(mesh, axes) -> int:
    """Ranks along the mesh axes ``axes`` together."""
    names = mesh.mesh_dim_names
    size = 1
    for a in _as_axes(axes):
        size *= mesh.shape[names.index(a)]
    return size


def axis_index(mesh, axes) -> int:
    """This rank's linear index over ``axes``, major to minor (the
    reference's ``_shard_linear_index``)."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    idx = 0
    for a in _as_axes(axes):
        i = names.index(a)
        idx = idx * mesh.shape[i] + coord[i]
    return idx


def _as_axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def block(size: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``parts`` of a dimension of ``size``: blocks of
    ``ceil(size / parts)``, the last ones shorter or empty."""
    per = -(-size // parts)
    return slice(min(index * per, size), min((index + 1) * per, size))


class Layout(tuple):
    """The reference's ``PartitionSpec`` as row blocks: one entry a
    dimension, ``None`` or the mesh axes (a name or a tuple of names, major
    to minor) that cut it."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def slices(self, mesh, shape) -> tuple[slice, ...]:
        """This rank's block of an array of ``shape``."""
        out = []
        for i, size in enumerate(shape):
            axes = _as_axes(self[i] if i < len(self) else None)
            if not axes:
                out.append(slice(0, size))
            else:
                out.append(block(size, axis_size(mesh, axes),
                                 axis_index(mesh, axes)))
        return tuple(out)

    def local(self, mesh, t):
        """This rank's block of ``t``, a view (numpy or torch)."""
        return t[self.slices(mesh, t.shape)]


def subset_specs(subset_axes, pod_axis: str | None):
    """Layouts of IPKMeans S2 operands on a pod mesh -> ``(subsets, masks,
    out)`` for the ``(M, S, d)`` packed subsets, their ``(M, S)`` masks and
    the per-subset outputs: the subset axis over ``subset_axes``, the
    in-subset point axis over ``pod_axis`` (whole when ``None``, the flat
    layout); every per-subset output is whole along ``pod_axis``, because
    the cross-pod reduction hands every pod the same stats.  The packs
    (``kdtree.pack_local``) cut the subsets and their capacity by the
    first."""
    axes = _as_axes(subset_axes)
    return (Layout(axes, pod_axis, None), Layout(axes, pod_axis),
            Layout(axes))


def s1_point_spec(subset_axes, pod_axis: str | None) -> Layout:
    """Layout of the raw ``(n, d)`` points entering S1: rows over ALL the
    mesh axes, ``(pod_axis,) + subset_axes`` (``subset_axes`` alone without
    a pod axis), so no rank holds the dataset; coordinates whole.  Every
    stage that holds the points in row blocks takes its block from it: the
    sharded S1, the a2a pack, the k-means|| sweeps, the S3 SSE and
    ``pkmeans_sharded``."""
    axes = _as_axes(subset_axes)
    return Layout(((pod_axis,) + axes) if pod_axis else axes, None)
