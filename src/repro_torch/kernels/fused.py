"""Fused single-pass Lloyd iteration over a stack of subsets.

Counterpart of ``repro.kernels.fused``.  One pass scores every point against
every centroid (``||c||^2 - 2 x.c``, lowest index on ties), then reduces the
weighted points into per-cluster ``sums``, ``counts`` and the lane's SSE; the
``assign_only`` mode stops at ``labels`` and ``mind``, and ``return_labels``
returns them beside the step's outputs.  The pass runs over a lane
dimension, ``x (M,S,d)``, ``c (M,k,d)``, ``w (M,S)``, restricted to the
lanes listed in ``lanes``: one call serves a whole S2 reducer stack, and
M = 1 is the single-solve case.

On a CUDA tensor :func:`fused_lloyd` launches the hand-written kernel in
``csrc/fused_lloyd.cu`` (built at first use) or raises; on a CPU tensor it
runs :func:`fused_lloyd_plain`, the same function in plain PyTorch.  Unlike
the TPU kernel nothing is padded: the kernel masks the ragged edges itself.
The reduction over points is the centroid-update kernel's chunked sort over
the whole card (``csrc/segment_sort.cuh``, chunk plan and workspaces from
``centroid_update``), so its sums and counts are that kernel's bit for bit
on the same labels, and one lane spreads over every SM.

Points, centroids and weights may be float32 or bfloat16; outputs are
float32.  ``spec`` (a :class:`~repro_torch.kernels.specs.KernelSpec`,
``DEFAULT_SPEC`` when ``None``) with ``acc_dtype="bfloat16"`` gives the
reference's bf16 kernel: the score of ``ref.bf16_scores``, ``||x||^2`` of
the rounded points, the SSE weighted by rounded weights, and the
accumulate's partial sums over blocks of ``bn`` rows rounded
(``ref.bf16_block_sums``, ``bn`` the spec's ``tile_shapes`` block).
``spec.block_k`` picks the score pass's centroid tile
(``specs.BLOCK_KS``), which changes no bit of the result.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import ref, specs
from repro_torch.kernels import work as work_
from repro_torch.kernels.ref import PLAIN_SCORE_ELEMS

# Kernel launches since the last reset; only the CUDA path counts.
launches = 0

SOURCE = "fused_lloyd.cu"


class StepOut(NamedTuple):
    sums: torch.Tensor        # (L, k, d) f32
    counts: torch.Tensor      # (L, k) f32
    sse: torch.Tensor         # (L,) f32


class AssignOut(NamedTuple):
    labels: torch.Tensor      # (L, S) i32
    mind: torch.Tensor        # (L, S) f32


class StepLabelsOut(NamedTuple):
    sums: torch.Tensor        # (L, k, d) f32
    counts: torch.Tensor      # (L, k) f32
    sse: torch.Tensor         # (L,) f32
    labels: torch.Tensor      # (L, S) i32
    mind: torch.Tensor        # (L, S) f32


def _step_out(sums, counts, sse, labels, mind, return_labels):
    if return_labels:
        return StepLabelsOut(sums, counts, sse, labels, mind)
    return StepOut(sums, counts, sse)


def work(lanes: int, s: int, d: int, k: int, *, assign_only: bool = False,
         return_labels: bool = False) -> work_.Work:
    """One launch over ``lanes`` lanes of ``s`` rows against ``k``
    centroids a lane: 2 s k d f32 operations a lane (the score product);
    the points and the lane's centroids read, then either the labels and
    distances written (``assign_only``) or the weights read and the sums,
    counts and SSE written (and with ``return_labels`` the labels and
    distances too)."""
    ops = 2.0 * lanes * s * k * d
    read = lanes * (s * d + k * d)
    labels = 2 * lanes * s
    if assign_only:
        return work_.Work(ops, work_.F32 * (read + labels))
    out = lanes * (k * d + k + 1) + (labels if return_labels else 0)
    return work_.Work(ops, work_.F32 * (read + lanes * s + out))


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
    if any(t.dtype not in (torch.float32, torch.bfloat16)
           for t in tensors[:-1]):
        raise TypeError(f"{what} takes float32 or bfloat16 points, "
                        f"centroids and weights")
    if lanes.dim() != 1 or lanes.dtype != torch.int32:
        raise TypeError("lanes must be a 1-D int32 tensor")


def plain_assign(x, c, bf16: bool, x2_rows=None):
    """Labels and distances of ``x (L,S,d)`` against ``c (L,k,d)`` in plain
    PyTorch -> ``(labels (L,S) int64, mind (L,S) f32, rows)``: the kernel's
    score (float32 ``||c||^2 - 2 x.c``, the dots from ``ref.row_dots``, so
    that on the CPU a row's result does not depend on the rows beside it;
    or ``ref.bf16_scores``), the first minimum, ``||x||^2`` of ``x2_rows``
    (default: the rows the product read, which come back as ``rows``)
    added back and clamped at 0."""
    if bf16:
        rows = ref.round_bf16(x)
        scores = ref.bf16_scores(rows, c)
    else:
        rows, cs = x.float(), c.float()
        cn = torch.sum(cs * cs, dim=-1)
        scores = cn.unsqueeze(1) - 2.0 * ref.row_dots(rows, cs)
    labels = torch.argmin(scores, dim=-1)
    best = torch.gather(scores, -1, labels.unsqueeze(-1)).squeeze(-1)
    xn = rows if x2_rows is None else x2_rows.float()
    mind = torch.clamp(best + torch.sum(xn * xn, dim=-1), min=0.0)
    return labels, mind, rows


def fused_lloyd_plain(x, c, w=None, lanes=None, *, assign_only=False,
                      return_labels=False, spec=None):
    """The kernel's function in plain PyTorch: same score formula, same
    tie-break (``torch.argmin`` returns the first minimum), one-hot sums
    (with a bfloat16 ``spec``: ``ref.bf16_block_sums``); the outputs of
    :func:`fused_lloyd` in each mode."""
    spec = specs.coerce(spec)
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
        labels, mind, xs = plain_assign(x[sel], c[sel], spec.bf16)
        if assign_only:
            outs.append((labels.to(torch.int32), mind))
            continue
        ws = w[sel].float()
        if spec.bf16:
            bn = spec.tile_shapes(s, d, k)[0]
            sums, counts = ref.bf16_block_sums(xs, labels, ws, k, bn)
            outs.append((sums, counts,
                         torch.sum(ref.round_bf16(ws) * mind, dim=-1),
                         labels.to(torch.int32), mind))
            continue
        onehot = torch.nn.functional.one_hot(labels, k).float()
        onehot = onehot * ws.unsqueeze(-1)
        outs.append((onehot.transpose(1, 2) @ xs, torch.sum(onehot, dim=1),
                     torch.sum(ws * mind, dim=-1), labels.to(torch.int32),
                     mind))
    if not outs:
        labels = torch.empty((0, s), dtype=torch.int32, device=x.device)
        f32 = dict(dtype=torch.float32, device=x.device)
        if assign_only:
            return AssignOut(labels, torch.empty((0, s), **f32))
        return _step_out(torch.empty((0, k, d), **f32),
                         torch.empty((0, k), **f32), torch.empty((0,), **f32),
                         labels, torch.empty((0, s), **f32), return_labels)
    cat = [torch.cat(parts) for parts in zip(*outs)]
    return AssignOut(*cat) if assign_only else _step_out(*cat,
                                                         return_labels)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load(SOURCE).fused_lloyd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 4 + [p] * 3 + [i] * 3 + [p] * 7 + [
            i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x, c, w, lanes, assign_only, return_labels, spec,
            shape_only=False):
    global launches
    from repro_torch.kernels import centroid_update
    m, s, d = x.shape
    k = c.shape[1]
    n_l = lanes.numel()
    if not all(t.is_contiguous() for t in (x, c, lanes)) or (
            w is not None and not w.is_contiguous()):
        raise ValueError("the fused kernel takes contiguous tensors")
    if not assign_only:
        centroid_update.check_k(k, "the fused step", x.device)
    # the kernel reads float32 operands (bfloat16 ones widened) and rounds
    # them itself in the bfloat16 mode, its partials over blocks of bn rows
    bn = spec.tile_shapes(s, d, k)[0] if spec.bf16 else 0
    x, c = x.float(), c.float()
    if w is not None:
        w = w.float()
    if n_l > 65535:
        raise ValueError(f"{n_l} lanes exceed one launch's grid")
    dev = x.device
    labels = torch.empty((n_l, s), dtype=torch.int32, device=dev)
    mind = torch.empty((n_l, s), dtype=torch.float32, device=dev)
    if assign_only:
        out = AssignOut(labels, mind)
    else:
        out = _step_out(torch.empty((n_l, k, d), dtype=torch.float32,
                                    device=dev),
                        torch.empty((n_l, k), dtype=torch.float32,
                                    device=dev),
                        torch.empty((n_l,), dtype=torch.float32, device=dev),
                        labels, mind, return_labels)
    if n_l == 0 or s == 0:
        if not assign_only:
            for t in out[:3]:
                t.zero_()
        return out
    if shape_only:
        work_.record("fused_lloyd", work(
            n_l, s, d, k, assign_only=assign_only,
            return_labels=return_labels))
        return out
    # the assign-only mode takes no chunk plan, workspaces or step outputs
    plan, hist, seg, start, order = (0, 0, 0), None, None, None, None
    step = (None, None, None)
    if not assign_only:
        step = out[:3]
        if w is None:
            w = torch.ones((m, s), dtype=torch.float32, device=dev)
        plan, hist, seg, start, order = centroid_update.workspaces(
            n_l, s, k, dev)
    cn = torch.empty((n_l, k), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(x), ptr(c), ptr(w), ptr(lanes), n_l, s, d,
                 k, ptr(cn), ptr(labels), ptr(mind), *plan, ptr(hist),
                 ptr(seg), ptr(start), ptr(order), *map(ptr, step),
                 int(assign_only), bn, spec.block_k, stream)
    if err != 0:
        raise RuntimeError(f"fused_lloyd kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out


def fused_lloyd(x, c, w=None, lanes=None, *, assign_only=False,
                return_labels=False, spec=None):
    """One fused Lloyd pass over the lanes ``lanes`` of a subset stack.

    ``x (M,S,d)``, ``c (M,k,d)``, ``w (M,S)`` (all-ones when ``None``),
    ``lanes (L,)`` int32 (all lanes when ``None``) ->
    ``StepOut(sums (L,k,d), counts (L,k), sse (L,))``; with
    ``return_labels=True`` ``StepLabelsOut``, the same plus the step's own
    ``labels (L,S) i32`` and ``mind (L,S)``; with ``assign_only=True``
    (which takes no weights) ``AssignOut(labels (L,S) i32, mind (L,S))``,
    the same labels and distances bit for bit.  Output row ``g`` belongs to
    lane ``lanes[g]``.

    ``x``, ``c`` and ``w`` may be float32 or bfloat16; ``spec`` is the
    kernel's ``KernelSpec`` (``DEFAULT_SPEC`` when ``None``; with
    ``acc_dtype="bfloat16"``, the bf16 kernel of the module docstring).
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel,
    and a build or launch failure raises; a fake or meta tensor takes the
    shape-only route (``kernels/work.py``).  The step's k is at most the
    card's shared memory per block over 4 (58,112 on the H100: the
    accumulate keeps k counts in one block's shared memory; the assign-only
    mode has no such limit).
    """
    spec = specs.coerce(spec)
    if lanes is None:
        lanes = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    _check(x, c, w, lanes, assign_only)
    if work_.is_fake(x):
        return _launch(x, c, w, lanes, assign_only, return_labels, spec, True)
    if x.device.type == "cpu":
        return fused_lloyd_plain(x, c, w, lanes, assign_only=assign_only,
                                 return_labels=return_labels, spec=spec)
    if x.device.type == "cuda":
        return _launch(x, c, w, lanes, assign_only, return_labels, spec)
    if x.is_meta:
        return _launch(x, c, w, lanes, assign_only, return_labels, spec, True)
    raise ValueError(f"the fused pass runs on cuda or cpu, not "
                     f"{x.device.type}")
