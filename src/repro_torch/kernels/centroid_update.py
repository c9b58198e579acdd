"""Weighted centroid accumulation (segment-sum by label), the counterpart
of ``repro.kernels.centroid_update``.

``sums[j] = sum of w_i x_i`` and ``counts[j] = sum of w_i`` over the points
labelled ``j``, for one subset (``(n,d)`` points, ``(n,)`` labels and
weights) or for the lanes ``lanes`` of a stack (``(M,S,d)`` points, ``(M,S)``
weights, ``(L,S)`` labels whose row ``g`` belongs to lane ``lanes[g]``).  A
label outside ``[0, k)`` contributes nothing, as the reference's one-hot
does.  It is the second half of the ``twopass`` engine's step.

On a CUDA tensor :func:`centroid_update` launches the hand-written kernel in
``csrc/sweeps.cu`` (built at first use), the fused pass's own accumulate
code without its SSE: given the same labels, its sums are the fused pass's
bit for bit, and a repeat launch gives the same bits.  A build or launch
failure raises.  On a CPU tensor it runs the plain version,
``ref.centroid_update_ref`` over chunks of lanes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused import _SMEM_PER_BLOCK

# Kernel launches since the last reset; only the CUDA path counts.
launches = 0

SOURCE = "sweeps.cu"


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
    product, over chunks of lanes that bound the ``(lanes, S, k)`` one-hot."""
    _, s, d = x.shape
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
        fn.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x, labels, w, k, lanes):
    global launches
    _, s, d = x.shape
    n_l = lanes.numel()
    if not all(t.is_contiguous() for t in (x, labels, w, lanes)):
        raise ValueError("the centroid-update kernel takes contiguous tensors")
    if (2 * k + 1) * 4 > _SMEM_PER_BLOCK:
        raise ValueError(f"k={k} clusters exceed the centroid update's "
                         f"shared-memory budget")
    dev = x.device
    sums = torch.empty((n_l, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((n_l, k), dtype=torch.float32, device=dev)
    if n_l == 0:
        return sums, counts
    if s == 0:
        return sums.zero_(), counts.zero_()
    order = torch.empty((n_l, s), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(x.data_ptr(), w.data_ptr(), lanes.data_ptr(),
                        labels.data_ptr(), n_l, s, d, k, order.data_ptr(),
                        sums.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"centroid-update kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return sums, counts


def centroid_update(points, labels, weights, k: int, lanes=None):
    """Weighted per-cluster sums and counts.

    One subset: ``points (n,d)``, ``labels (n,)`` int32, ``weights (n,)`` ->
    ``(sums (k,d), counts (k,))``.  A stack: ``points (M,S,d)``, ``labels
    (L,S)``, ``weights (M,S)``, ``lanes (L,)`` int32 (all lanes when
    ``None``) -> ``(sums (L,k,d), counts (L,k))``.
    """
    k = int(k)
    if points.dim() == 2:
        if lanes is not None:
            raise ValueError("lanes apply to a (M,S,d) stack only")
        sums, counts = centroid_update(points.unsqueeze(0),
                                       labels.unsqueeze(0),
                                       weights.unsqueeze(0), k)
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
    return _launch(points, labels, weights, k, lanes)
