"""Weighted centroid accumulation (segment-sum by label), the counterpart
of ``repro.kernels.centroid_update``.

``sums[j] = sum of w_i x_i`` and ``counts[j] = sum of w_i`` over the points
labelled ``j``, for one subset (``(n,d)`` points, ``(n,)`` labels and
weights) or for the lanes ``lanes`` of a stack (``(M,S,d)`` points, ``(M,S)``
weights, ``(L,S)`` labels whose row ``g`` belongs to lane ``lanes[g]``).  A
label outside ``[0, k)`` contributes nothing, as the reference's one-hot
does.  It is the second half of the ``twopass`` engine's step.

On a CUDA tensor :func:`centroid_update` launches the hand-written kernel in
``csrc/sweeps.cu`` (built at first use): a stable counting sort of each
lane's rows by label spread over the whole card, then one warp per (lane,
cluster) summing its rows in increasing point order.  :func:`chunk_plan`
cuts each lane into chunks of C rows so that lanes x chunks gives every SM
at least four blocks; a histogram pass, three integer prefix passes, a
scatter pass and a sum pass run on the caller's stream.  A stable sort by
label is unique, so the order, and the sums, are the fused pass's bit for
bit given the same labels, and a repeat launch gives the same bits.  A cluster that
holds most of a lane is summed by one warp: the bits require it.  A build
or launch failure raises.  On a CPU tensor it runs the plain version,
``ref.centroid_update_ref`` over chunks of lanes and rows.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused import _SMEM_PER_BLOCK

# Kernel launches since the last reset; only the CUDA path counts.
launches = 0

SOURCE = "sweeps.cu"
# the largest chunk: one warp scatters it, 32 rows a step
CHUNK_ROWS = 2048
# chunks per segment of the kernel's prefix pass (CHUNK_SEG in sweeps.cu)
CHUNK_SEG = 16
# blocks of the histogram and scatter passes per SM the plan aims at (the
# scatter is one warp's chain of steps a chunk, so more chunks, shorter
# chains)
BLOCKS_PER_SM = 4


class ChunkPlan(NamedTuple):
    rows: int       # C, the rows of a chunk (a multiple of 32)
    chunks: int     # chunks per lane, ceil(S / C)
    segs: int       # segments of the prefix pass, ceil(chunks / CHUNK_SEG)


def chunk_plan(n_lanes: int, s: int, sms: int,
               rows: int | None = None) -> ChunkPlan:
    """How each of ``n_lanes`` lanes of ``s`` rows is cut into chunks for a
    card of ``sms`` SMs, so that n_lanes x chunks is at least
    ``BLOCKS_PER_SM`` blocks an SM where 32-row chunks allow that many: C
    is ``s`` over the chunks a lane needs for that, rounded down to a
    multiple of 32, and between 32 and ``CHUNK_ROWS``.  ``rows`` forces C;
    it changes no bit of the result."""
    if rows is None:
        per_lane = -(-BLOCKS_PER_SM * sms // max(n_lanes, 1))
        rows = min(CHUNK_ROWS, max(32, s // per_lane // 32 * 32))
    if rows < 32 or rows % 32:
        raise ValueError(f"a chunk of {rows} rows: chunks are a positive "
                         f"multiple of 32 rows")
    chunks = max(1, -(-s // rows))
    return ChunkPlan(rows, chunks, -(-chunks // CHUNK_SEG))


def _check(x, labels, w, k, lanes):
    if x.dim() != 3 or labels.dim() != 2 or w.dim() != 2:
        raise ValueError(f"expected points (M,S,d), labels (L,S) and weights "
                         f"(M,S), got {tuple(x.shape)}, "
                         f"{tuple(labels.shape)} and {tuple(w.shape)}")
    m, s, _ = x.shape
    if tuple(w.shape) != (m, s):
        raise ValueError(f"weights {tuple(w.shape)} do not fit points "
                         f"{tuple(x.shape)}")
    if lanes.dim() != 1 or lanes.dtype != torch.int32:
        raise TypeError("lanes must be a 1-D int32 tensor")
    if tuple(labels.shape) != (lanes.numel(), s):
        raise ValueError(f"labels {tuple(labels.shape)} do not fit "
                         f"{lanes.numel()} lanes of {s} points")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if any(t.device != x.device for t in (labels, w, lanes)):
        raise ValueError("points, labels, weights and lanes must share one "
                         "device")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("the centroid update takes float32 points and "
                        "weights")
    if labels.dtype != torch.int32:
        raise TypeError("the centroid update takes int32 labels")


def centroid_update_plain(x, labels, w, k, lanes):
    """The kernel's function in plain PyTorch: the reference's one-hot
    product, over chunks of lanes that bound the ``(lanes, S, k)`` one-hot,
    and over chunks of rows, their sums added in row order, where one
    lane's ``(S, k)`` one-hot alone would pass that bound."""
    _, s, d = x.shape
    rows = max(1, ref.PLAIN_SCORE_ELEMS // k)
    if s > rows:
        parts = [centroid_update_plain(x[:, lo:lo + rows],
                                       labels[:, lo:lo + rows],
                                       w[:, lo:lo + rows], k, lanes)
                 for lo in range(0, s, rows)]
        sums, counts = parts[0]
        for part_sums, part_counts in parts[1:]:
            sums, counts = sums + part_sums, counts + part_counts
        return sums, counts
    sel = lanes.long()
    step = max(1, ref.PLAIN_SCORE_ELEMS // max(1, s * k))
    outs = [ref.centroid_update_ref(x[sel[lo:lo + step]],
                                    labels[lo:lo + step],
                                    w[sel[lo:lo + step]], k)
            for lo in range(0, sel.numel(), step)]
    if not outs:
        return x.new_zeros((0, k, d)), x.new_zeros((0, k))
    return tuple(torch.cat(parts) for parts in zip(*outs))


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load(SOURCE).centroid_update
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 7 + [p] * 7
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x, labels, w, k, lanes, chunk_rows):
    global launches
    _, s, d = x.shape
    n_l = lanes.numel()
    if not all(t.is_contiguous() for t in (x, labels, w, lanes)):
        raise ValueError("the centroid-update kernel takes contiguous tensors")
    if k * 4 > _SMEM_PER_BLOCK:
        raise ValueError(f"k={k} clusters exceed the centroid update's "
                         f"shared-memory budget (a chunk's k counts)")
    dev = x.device
    sums = torch.empty((n_l, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((n_l, k), dtype=torch.float32, device=dev)
    if n_l == 0:
        return sums, counts
    if s == 0:
        return sums.zero_(), counts.zero_()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = chunk_plan(n_l, s, sms, chunk_rows)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    hist, seg = i32(n_l, plan.chunks, k), i32(n_l, plan.segs, k)
    start, order = i32(n_l, k + 1), i32(n_l, s)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(x.data_ptr(), w.data_ptr(), lanes.data_ptr(),
                        labels.data_ptr(), n_l, s, d, k, plan.rows,
                        plan.chunks, plan.segs, hist.data_ptr(),
                        seg.data_ptr(), start.data_ptr(), order.data_ptr(),
                        sums.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"centroid-update kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return sums, counts


def centroid_update(points, labels, weights, k: int, lanes=None, *,
                    chunk_rows: int | None = None):
    """Weighted per-cluster sums and counts.

    One subset: ``points (n,d)``, ``labels (n,)`` int32, ``weights (n,)`` ->
    ``(sums (k,d), counts (k,))``.  A stack: ``points (M,S,d)``, ``labels
    (L,S)``, ``weights (M,S)``, ``lanes (L,)`` int32 (all lanes when
    ``None``) -> ``(sums (L,k,d), counts (L,k))``.

    On a CUDA tensor the kernel's six passes run on the current stream,
    and ``launches`` goes up by one once every pass has been launched
    without error.  Its int32 workspaces come from the caching allocator:
    the histograms (L, chunks, k), the segment bases (L, segs, k), the
    starts (L, k + 1) and the order (L, S).  On 132 SMs the main stack (512
    lanes of 16384 rows, k = 1024, 8 chunks a lane) takes 16.8 MB of
    histograms and 33.6 MB of order; one lane of 2^20 rows at k = 4100 (529
    chunks of 1984 rows) 8.7 MB and 4.2 MB; one lane of 2^23 rows at k =
    4100 (4096 chunks of 2048 rows) 67.2 MB and 33.6 MB.  ``chunk_rows``
    forces the chunk size C of :func:`chunk_plan` (a multiple of 32); it
    changes no bit.  k is at most 58,112: the histogram and scatter passes
    keep k counts in one block's shared memory.
    """
    k = int(k)
    if points.dim() == 2:
        if lanes is not None:
            raise ValueError("lanes apply to a (M,S,d) stack only")
        sums, counts = centroid_update(points.unsqueeze(0),
                                       labels.unsqueeze(0),
                                       weights.unsqueeze(0), k,
                                       chunk_rows=chunk_rows)
        return sums[0], counts[0]
    if lanes is None:
        lanes = torch.arange(points.shape[0], dtype=torch.int32,
                             device=points.device)
    _check(points, labels, weights, k, lanes)
    if points.device.type == "cpu":
        return centroid_update_plain(points, labels, weights, k, lanes)
    if points.device.type != "cuda":
        raise ValueError(f"the centroid update runs on cuda or cpu, not "
                         f"{points.device.type}")
    return _launch(points, labels, weights, k, lanes, chunk_rows)
