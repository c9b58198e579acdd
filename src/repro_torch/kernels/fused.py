"""Fused single-pass Lloyd iteration over a stack of subsets.

Counterpart of ``repro.kernels.fused``.  One pass scores every point against
every centroid (``||c||^2 - 2 x.c``, lowest index on ties), then reduces the
weighted points into per-cluster ``sums``, ``counts`` and the lane's SSE; the
``assign_only`` mode stops at ``labels`` and ``mind``.  The pass runs over a
lane dimension, ``x (M,S,d)``, ``c (M,k,d)``, ``w (M,S)``, restricted to the
lanes listed in ``lanes``: one launch serves a whole S2 reducer stack, and
M = 1 is the single-solve case.

On a CUDA tensor :func:`fused_lloyd` launches the hand-written kernel in
``csrc/fused_lloyd.cu`` (built at first use) or raises; on a CPU tensor it
runs :func:`fused_lloyd_plain`, the same function in plain PyTorch.  Unlike
the TPU kernel nothing is padded: the kernel masks the ragged edges itself.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import PLAIN_SCORE_ELEMS

# Kernel launches since the last reset; only the CUDA path counts.
launches = 0

SOURCE = "fused_lloyd.cu"
# one block's shared memory on Hopper (bytes), and the accumulate pass's
# fixed share of it (its 1024-float reduction buffer)
_SMEM_PER_BLOCK = 232448
_SMEM_FIXED = 1024 * 4


class StepOut(NamedTuple):
    sums: torch.Tensor        # (L, k, d) f32
    counts: torch.Tensor      # (L, k) f32
    sse: torch.Tensor         # (L,) f32


class AssignOut(NamedTuple):
    labels: torch.Tensor      # (L, S) i32
    mind: torch.Tensor        # (L, S) f32


def _check(x, c, w, lanes, assign_only, what="the fused pass"):
    if x.dim() != 3 or c.dim() != 3:
        raise ValueError(f"expected x (M,S,d) and c (M,k,d), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    m, s, d = x.shape
    if c.shape[0] != m or c.shape[2] != d or c.shape[1] < 1:
        raise ValueError(f"centroids {tuple(c.shape)} do not fit points "
                         f"{tuple(x.shape)}")
    if assign_only and w is not None:
        raise ValueError("assign_only sweeps take no weights: the "
                         "accumulators that would consume them are exactly "
                         "what the mode elides")
    if w is not None and tuple(w.shape) != (m, s):
        raise ValueError(f"weights {tuple(w.shape)} do not fit points "
                         f"{tuple(x.shape)}")
    tensors = [x, c] + ([] if w is None else [w]) + [lanes]
    if any(t.device != x.device for t in tensors):
        raise ValueError("points, centroids, weights and lanes must share "
                         "one device")
    if any(t.dtype != torch.float32 for t in tensors[:-1]):
        raise TypeError(f"{what} takes float32 points, centroids and "
                        f"weights")
    if lanes.dim() != 1 or lanes.dtype != torch.int32:
        raise TypeError("lanes must be a 1-D int32 tensor")


def fused_lloyd_plain(x, c, w=None, lanes=None, *, assign_only=False):
    """The kernel's function in plain PyTorch: same score formula, same
    tie-break (``torch.argmin`` returns the first minimum), one-hot sums."""
    m, s, d = x.shape
    k = c.shape[1]
    if lanes is None:
        lanes = torch.arange(m, dtype=torch.int32, device=x.device)
    if w is None and not assign_only:
        w = torch.ones((m, s), dtype=torch.float32, device=x.device)
    step = max(1, PLAIN_SCORE_ELEMS // max(1, s * k))
    outs = []
    for lo in range(0, lanes.numel(), step):
        sel = lanes[lo:lo + step].long()
        xs, cs = x[sel], c[sel]
        cn = torch.sum(cs * cs, dim=-1)
        scores = cn.unsqueeze(1) - 2.0 * (xs @ cs.transpose(1, 2))
        labels = torch.argmin(scores, dim=-1)
        best = torch.gather(scores, -1, labels.unsqueeze(-1)).squeeze(-1)
        mind = torch.clamp(best + torch.sum(xs * xs, dim=-1), min=0.0)
        if assign_only:
            outs.append((labels.to(torch.int32), mind))
            continue
        ws = w[sel]
        onehot = torch.nn.functional.one_hot(labels, k).float()
        onehot = onehot * ws.unsqueeze(-1)
        outs.append((onehot.transpose(1, 2) @ xs, torch.sum(onehot, dim=1),
                     torch.sum(ws * mind, dim=-1)))
    if not outs:
        if assign_only:
            return AssignOut(torch.empty((0, s), dtype=torch.int32,
                                         device=x.device),
                             x.new_empty((0, s)))
        return StepOut(x.new_empty((0, k, d)), x.new_empty((0, k)),
                       x.new_empty((0,)))
    cat = [torch.cat(parts) for parts in zip(*outs)]
    return AssignOut(*cat) if assign_only else StepOut(*cat)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load(SOURCE).fused_lloyd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p, p, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x, c, w, lanes, assign_only):
    global launches
    m, s, d = x.shape
    k = c.shape[1]
    n_l = lanes.numel()
    if not all(t.is_contiguous() for t in (x, c, lanes)) or (
            w is not None and not w.is_contiguous()):
        raise ValueError("the fused kernel takes contiguous tensors")
    if not assign_only and (2 * k + 1) * 4 + _SMEM_FIXED > _SMEM_PER_BLOCK:
        raise ValueError(f"k={k} clusters exceed the accumulate pass's "
                         f"shared-memory budget")
    if n_l > 65535:
        raise ValueError(f"{n_l} lanes exceed one launch's grid")
    dev = x.device
    labels = torch.empty((n_l, s), dtype=torch.int32, device=dev)
    mind = torch.empty((n_l, s), dtype=torch.float32, device=dev)
    if assign_only:
        out = AssignOut(labels, mind)
    else:
        out = StepOut(torch.empty((n_l, k, d), dtype=torch.float32,
                                  device=dev),
                      torch.empty((n_l, k), dtype=torch.float32, device=dev),
                      torch.empty((n_l,), dtype=torch.float32, device=dev))
    if n_l == 0 or s == 0:
        if not assign_only:
            for t in out:
                t.zero_()
        return out
    if w is None and not assign_only:
        w = torch.ones((m, s), dtype=torch.float32, device=dev)
    cn = torch.empty((n_l, k), dtype=torch.float32, device=dev)
    order = (None if assign_only
             else torch.empty((n_l, s), dtype=torch.int32, device=dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(x), ptr(c), ptr(w), ptr(lanes), n_l, s, d, k, ptr(cn),
                 ptr(labels), ptr(mind), ptr(order),
                 None if assign_only else ptr(out.sums),
                 None if assign_only else ptr(out.counts),
                 None if assign_only else ptr(out.sse),
                 int(assign_only), stream)
    if err != 0:
        raise RuntimeError(f"fused_lloyd kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out


def fused_lloyd(x, c, w=None, lanes=None, *, assign_only=False):
    """One fused Lloyd pass over the lanes ``lanes`` of a subset stack.

    ``x (M,S,d)``, ``c (M,k,d)``, ``w (M,S)`` (all-ones when ``None``),
    ``lanes (L,)`` int32 (all lanes when ``None``) ->
    ``StepOut(sums (L,k,d), counts (L,k), sse (L,))``, or with
    ``assign_only=True`` (which takes no weights)
    ``AssignOut(labels (L,S) i32, mind (L,S))``.  Output row ``g`` belongs
    to lane ``lanes[g]``.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel,
    and a build or launch failure raises.
    """
    if lanes is None:
        lanes = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    _check(x, c, w, lanes, assign_only)
    if x.device.type == "cpu":
        return fused_lloyd_plain(x, c, w, lanes, assign_only=assign_only)
    if x.device.type != "cuda":
        raise ValueError(f"the fused pass runs on cuda or cpu, not "
                         f"{x.device.type}")
    return _launch(x, c, w, lanes, assign_only)
