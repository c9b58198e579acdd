"""One k-means|| seeding round in one sweep over the points, the counterpart
of ``repro.kernels.init``.

A round scores every point against the round's NEW candidates only and
folds the result into the running minimum squared distance ``old_mind``,
reduces the new potential ``psi = sum(w * new_mind)``, and draws the
Bernoulli oversample ``u * psi_prev < ell * new_mind`` (gated on ``w > 0``
and ``psi_prev > 0``) against host-fed uniforms, so the kernel and its plain
version draw the same points.  Invalid candidates (``cand_valid``) never
win; a round with no valid candidate leaves ``mind`` as it was and still
draws.

On a CUDA tensor :func:`init_sweep` launches the hand-written kernel in
``csrc/sweeps.cu`` (built at first use): the fused pass's scoring tile with
a per-row epilogue, and the potential as per-block partial sums reduced in
a fixed order by a second launch, so a repeat launch gives the same bits.
``psi_prev`` may be a device tensor, which the kernel reads from device
memory, so the launch needs no host copy of it; the seeding loop
(``core/init.py``) still waits once a round, for the rows it drew.  A build
or launch failure raises.  On a CPU tensor it runs the plain version,
``ref.init_sweep_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

# Kernel launches since the last reset; only the CUDA path counts.
launches = 0

SOURCE = "sweeps.cu"
# rows one block of the kernel scores (lloyd::BM): one potential partial each
_BLOCK_ROWS = 128


def _check(x, c, old_mind, u, w, valid):
    if x.dim() != 2 or c.dim() != 2 or c.shape[1] != x.shape[1]:
        raise ValueError(f"expected points (n,d) and candidates (c,d), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    n = x.shape[0]
    for name, t in (("old_mind", old_mind), ("uniforms", u), ("weights", w)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"{name} {tuple(t.shape)} does not fit {n} "
                             f"points")
    if valid is not None and (tuple(valid.shape) != (c.shape[0],)
                              or valid.dtype != torch.bool):
        raise ValueError(f"cand_valid must be a ({c.shape[0]},) bool tensor")
    tensors = [t for t in (x, c, old_mind, u, w, valid) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("every input of the init sweep must share one "
                         "device")
    if any(t.dtype != torch.float32 for t in (x, c, old_mind, u)) or (
            w is not None and w.dtype != torch.float32):
        raise TypeError("the init sweep takes float32 points, candidates, "
                        "distances, uniforms and weights")


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load(SOURCE).init_sweep
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, i, i, i, p, p, p,
                       p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x, c, old_mind, u, pp, ell, w, valid):
    global launches
    n, d = x.shape
    nc = c.shape[0]
    dev = x.device
    if w is None:
        w = torch.ones((n,), dtype=torch.float32, device=dev)
    tensors = [t for t in (x, c, old_mind, u, w, valid) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the init-sweep kernel takes contiguous tensors")
    new_mind = torch.empty((n,), dtype=torch.float32, device=dev)
    sampled = torch.empty((n,), dtype=torch.bool, device=dev)
    psi = torch.empty((), dtype=torch.float32, device=dev)
    if n == 0:
        return new_mind, sampled, psi.zero_()
    cn = torch.empty((nc,), dtype=torch.float32, device=dev)
    partial = torch.empty((-(-n // _BLOCK_ROWS),), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(x.data_ptr(), c.data_ptr(),
                        None if valid is None else valid.data_ptr(),
                        old_mind.data_ptr(), u.data_ptr(), w.data_ptr(),
                        pp.data_ptr(), ell, n, d, nc, cn.data_ptr(),
                        new_mind.data_ptr(), sampled.data_ptr(),
                        partial.data_ptr(), psi.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"init-sweep kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return new_mind, sampled, psi


def init_sweep(points, cands, old_mind, uniforms, psi_prev, *, ell: float,
               cand_valid=None, weights=None):
    """One k-means|| round: ``points (n,d)``, the round's new candidates
    ``cands (c,d)``, the running minimum ``old_mind (n,)`` (``+inf`` before
    the first round), the round's uniforms ``(n,)`` and the previous
    round's potential ``psi_prev`` (a number or a 0-dim tensor; 0 draws
    nothing) -> ``(new_mind (n,) f32, sampled (n,) bool, psi () f32)``.

    ``ell`` is the oversampling factor (used as float32), ``cand_valid (c,)``
    bool masks candidates out (``None``: all valid), ``weights (n,)`` weight
    the potential and gate the draw (``None``: all ones).
    """
    _check(points, cands, old_mind, uniforms, weights, cand_valid)
    dev = points.device
    pp = torch.as_tensor(psi_prev, dtype=torch.float32, device=dev).reshape(())
    if dev.type == "cpu":
        return ref.init_sweep_ref(points, cands, old_mind, uniforms, pp,
                                  ell=ell, cand_valid=cand_valid,
                                  weights=weights)
    if dev.type != "cuda":
        raise ValueError(f"the init sweep runs on cuda or cpu, not "
                         f"{dev.type}")
    return _launch(points, cands, old_mind, uniforms, pp, float(ell),
                   weights, cand_valid)
