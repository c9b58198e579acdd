"""Nearest-centroid assignment, the counterpart of ``repro.kernels.assign``.

Labels ``argmin_j (||c_j||^2 - 2 x.c_j)`` (lowest ``j`` on ties) and the
minimum squared distances ``max(best + ||x||^2, 0)`` of one subset, ``(n,d)``
points against ``(k,d)`` centroids, or of the lanes ``lanes`` of a stack,
``(M,S,d)`` against ``(M,k,d)``.  It is the first half of the ``twopass``
engine's step and the weighting pass of k-means|| seeding.

On a CUDA tensor :func:`assign` launches the hand-written kernel in
``csrc/sweeps.cu`` (built at first use), whose scoring is the fused pass's
own device code, so its labels are the fused pass's bit for bit; a build or
launch failure raises.  On a CPU tensor it runs the plain version,
:func:`assign_plain`: the fused pass's assign-only mode in plain PyTorch
(the same score formula and tie-break).  Nothing is padded: the kernel
masks the ragged edges itself.

Points and centroids may be float32 or bfloat16.  ``spec`` with
``acc_dtype="bfloat16"`` gives the reference's bf16 kernel: the score of
``ref.bf16_scores``, and ``||x||^2`` of the points as given added back (the
reference's assign adds it outside its kernel, unrounded).  ``spec.
block_k`` picks the kernel's centroid tile (``specs.BLOCK_KS``), which
changes no bit of the result.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import fused, ref, specs
from repro_torch.kernels import work as work_
from repro_torch.kernels.fused import AssignOut

# Kernel launches since the last reset; only the CUDA path counts.
launches = 0

SOURCE = "sweeps.cu"


def work(lanes: int, s: int, d: int, k: int) -> work_.Work:
    """One launch over ``lanes`` lanes of ``s`` rows against ``k``
    centroids a lane: the fused pass's assign-only mode (2 s k d f32
    operations a lane; points and centroids read, labels and distances
    written)."""
    return fused.work(lanes, s, d, k, assign_only=True)


def assign_plain(x, c, lanes, spec=None) -> AssignOut:
    """The kernel's function in plain PyTorch: the fused pass's assign-only
    plain version (f32), or ``fused.plain_assign`` with ``||x||^2`` of the
    points as given (bfloat16 ``spec``), over row chunks
    (``ref.by_row_chunks``) that bound its ``(lanes, rows, k)`` scores."""
    spec = specs.coerce(spec)
    if not spec.bf16:
        return AssignOut(*ref.by_row_chunks(
            lambda xs: fused.fused_lloyd_plain(xs, c, lanes=lanes,
                                               assign_only=True),
            x, c.shape[1]))
    sel = lanes.long()

    def block(xs):
        labels, mind, _ = fused.plain_assign(xs, c[sel], True, x2_rows=xs)
        return labels.to(torch.int32), mind

    return AssignOut(*ref.by_row_chunks(block, x[sel], c.shape[1]))


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load(SOURCE).assign
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 3 + [i] * 6 + [p] * 4
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x, c, lanes, spec, shape_only=False) -> AssignOut:
    global launches
    _, s, d = x.shape
    k = c.shape[1]
    n_l = lanes.numel()
    if not all(t.is_contiguous() for t in (x, c, lanes)):
        raise ValueError("the assign kernel takes contiguous tensors")
    # the kernel reads float32 operands (bfloat16 ones widened) and rounds
    # them itself in the bfloat16 mode
    x, c = x.float(), c.float()
    if n_l > 65535:
        raise ValueError(f"{n_l} lanes exceed one launch's grid")
    dev = x.device
    out = AssignOut(torch.empty((n_l, s), dtype=torch.int32, device=dev),
                    torch.empty((n_l, s), dtype=torch.float32, device=dev))
    if n_l == 0 or s == 0:
        return out
    cn = torch.empty((n_l, k), dtype=torch.float32, device=dev)
    if shape_only:
        work_.record("assign", work(n_l, s, d, k))
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(x.data_ptr(), c.data_ptr(), lanes.data_ptr(), n_l,
                        s, d, k, int(spec.bf16), spec.block_k,
                        cn.data_ptr(), out.labels.data_ptr(),
                        out.mind.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"assign kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return out


def assign(points, centroids, lanes=None, *, spec=None) -> AssignOut:
    """Labels and minimum squared distances.

    One subset: ``points (n,d)``, ``centroids (k,d)`` -> ``AssignOut(labels
    (n,) i32, mind (n,) f32)``.  A stack: ``points (M,S,d)``, ``centroids
    (M,k,d)``, ``lanes (L,)`` int32 (all lanes when ``None``) ->
    ``AssignOut(labels (L,S), mind (L,S))``, row ``g`` for lane
    ``lanes[g]``.  ``spec``: the kernel's ``KernelSpec`` (``DEFAULT_SPEC``
    when ``None``).  A fake or meta tensor takes the shape-only route
    (``kernels/work.py``).
    """
    spec = specs.coerce(spec)
    if points.dim() == 2:
        if lanes is not None:
            raise ValueError("lanes apply to a (M,S,d) stack only")
        out = assign(points.unsqueeze(0), centroids.unsqueeze(0), spec=spec)
        return AssignOut(out.labels[0], out.mind[0])
    if lanes is None:
        lanes = torch.arange(points.shape[0], dtype=torch.int32,
                             device=points.device)
    fused._check(points, centroids, None, lanes, True, what="assign")
    if work_.is_fake(points):
        return _launch(points, centroids, lanes, spec, True)
    if points.device.type == "cpu":
        return assign_plain(points, centroids, lanes, spec)
    if points.device.type == "cuda":
        return _launch(points, centroids, lanes, spec)
    if points.is_meta:
        return _launch(points, centroids, lanes, spec, True)
    raise ValueError(f"assign runs on cuda or cpu, not "
                     f"{points.device.type}")
