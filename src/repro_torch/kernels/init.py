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
``ref.init_sweep_ref`` (:func:`init_sweep_plain` with a bfloat16 spec).

Points and candidates may be float32 or bfloat16.  ``spec``
(``DEFAULT_SPEC`` when ``None``) with ``acc_dtype="bfloat16"`` gives the
reference's bf16 kernel: the score of ``ref.bf16_scores`` against the
candidates' norms as given (``+inf`` for invalid ones), and ``||x||^2`` of
the rounded points added back; the rest of the round is float32.
``spec.block_k`` picks the kernel's candidate tile (``specs.BLOCK_KS``),
which changes no bit of the result.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref, specs

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
    if any(t.dtype != torch.float32 for t in (old_mind, u)) or any(
            t is not None and t.dtype not in (torch.float32, torch.bfloat16)
            for t in (x, c, w)):
        raise TypeError("the init sweep takes float32 or bfloat16 points, "
                        "candidates and weights, and float32 distances and "
                        "uniforms")


def init_sweep_plain(points, cands, old_mind, uniforms, psi_prev, *,
                     ell: float, cand_valid=None, weights=None, spec=None):
    """The kernel's function in plain PyTorch: ``ref.init_sweep_ref``, or
    with a bfloat16 ``spec`` the same round on ``ref.bf16_scores`` (in row
    chunks) with ``||x||^2`` of the rounded points."""
    spec = specs.coerce(spec)
    if not spec.bf16:
        return ref.init_sweep_ref(points, cands, old_mind, uniforms,
                                  psi_prev, ell=ell, cand_valid=cand_valid,
                                  weights=weights)
    x = ref.round_bf16(points)
    n, nc = x.shape[0], cands.shape[0]
    best = torch.full((n,), torch.inf, dtype=torch.float32, device=x.device)
    if n and nc:
        valid = (torch.ones(nc, dtype=torch.bool, device=x.device)
                 if cand_valid is None else cand_valid)

        def block(xs):
            sc = ref.bf16_scores(xs, cands)
            return (torch.amin(torch.where(valid, sc, torch.inf), dim=-1),)

        best, = ref.by_row_chunks(block, x, nc)
    cand_min = torch.clamp(best + torch.sum(x * x, dim=-1), min=0.0)
    mind = torch.minimum(old_mind.float(), cand_min)
    w = ref._as_weights(x, weights)
    pp = torch.as_tensor(psi_prev, dtype=torch.float32, device=x.device)
    take = (uniforms.float() * pp < ell * mind) & (w > 0.0) & (pp > 0.0)
    return mind, take, torch.sum(w * mind)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load(SOURCE).init_sweep
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [ctypes.c_float] + [i] * 5 + [p] * 6
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x, c, old_mind, u, pp, ell, w, valid, spec):
    global launches
    n, d = x.shape
    nc = c.shape[0]
    dev = x.device
    if w is None:
        w = torch.ones((n,), dtype=torch.float32, device=dev)
    # the kernel reads float32 operands (bfloat16 ones widened) and rounds
    # them itself in the bfloat16 mode
    x, c = x.float(), c.float()
    w = w.float()
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
                        pp.data_ptr(), ell, n, d, nc, int(spec.bf16),
                        spec.block_k, cn.data_ptr(),
                        new_mind.data_ptr(), sampled.data_ptr(),
                        partial.data_ptr(), psi.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"init-sweep kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return new_mind, sampled, psi


def init_sweep(points, cands, old_mind, uniforms, psi_prev, *, ell: float,
               cand_valid=None, weights=None, spec=None):
    """One k-means|| round: ``points (n,d)``, the round's new candidates
    ``cands (c,d)``, the running minimum ``old_mind (n,)`` (``+inf`` before
    the first round), the round's uniforms ``(n,)`` and the previous
    round's potential ``psi_prev`` (a number or a 0-dim tensor; 0 draws
    nothing) -> ``(new_mind (n,) f32, sampled (n,) bool, psi () f32)``.

    ``ell`` is the oversampling factor (used as float32), ``cand_valid (c,)``
    bool masks candidates out (``None``: all valid), ``weights (n,)`` weight
    the potential and gate the draw (``None``: all ones).  ``spec``: the
    kernel's ``KernelSpec`` (``DEFAULT_SPEC`` when ``None``).
    """
    spec = specs.coerce(spec)
    _check(points, cands, old_mind, uniforms, weights, cand_valid)
    dev = points.device
    pp = torch.as_tensor(psi_prev, dtype=torch.float32, device=dev).reshape(())
    if dev.type == "cpu":
        return init_sweep_plain(points, cands, old_mind, uniforms, pp,
                                ell=ell, cand_valid=cand_valid,
                                weights=weights, spec=spec)
    if dev.type != "cuda":
        raise ValueError(f"the init sweep runs on cuda or cpu, not "
                         f"{dev.type}")
    return _launch(points, cands, old_mind, uniforms, pp, float(ell),
                   weights, cand_valid, spec)
