"""int8 error-feedback compression for the cross-pod reduction, the
counterpart of ``repro.distributed.compress``.

Each rank quantizes its local contribution to int8 with a symmetric scale,
keeps the quantization residual and adds it back at the next call, so the
error does not build up (Seide et al.; the 1-bit Adam lineage).  Two kinds
of tree, dicts of tensors, ride it:

  * gradient trees: one scale a tensor (``compress_grads`` /
    ``decompress_grads``);
  * k-means reduction stats, ``{"sums": (M, k, d), "counts": (M, k)}``,
    whose residual is carried across Lloyd iterations by the solver loop;
    ``ef_allreduce`` quantizes, all-gathers the int8 payload and its f32
    scales over a process group, and dequantize-sums them on every rank.
    Per-row scales (``axis=-1``) keep empty clusters' rows from taking a
    large cluster's scale.

The arithmetic is the reference's compiled program's bit for bit (XLA on
the CPU, where the tests hold the two): the scale is ``amax * f32(1/127)``
(XLA's form of the division by 127), ``torch.round`` rounds half to even as
``jnp.round`` does, and the two sums XLA fuses with a product, the residual
``(g + r) - q * scale`` and the dequantize-sum over ranks, round once, as a
fused multiply-add does (``ref.fma_f32``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed import comm
from repro_torch.kernels.ref import fma_f32


# 1 / 127 rounded to float32 (0.00787401572)
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


class EFState(NamedTuple):
    residual: Any        # a tree like the compressed one, f32


def _map(fn, *trees):
    """``fn`` over the leaves of (nested) dicts; a payload's ``(int8,
    scale)`` pair is one leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: _map(fn, *(t[key] for t in trees)) for key in first}
    return fn(*trees)


def _leaves(tree) -> list:
    """The tensors of a tree, a payload's pairs flattened, in dict order."""
    if isinstance(tree, dict):
        return [x for key in tree for x in _leaves(tree[key])]
    if isinstance(tree, tuple):
        return list(tree)
    return [tree]


def init_ef(tree_like) -> EFState:
    return EFState(residual=_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), tree_like))


def quantize_int8(x: torch.Tensor, axis=None):
    """x -> (int8 values, f32 scale), symmetric.  ``axis=None`` is one
    scale for the tensor, an int or tuple the scales of each slice along
    it, kept as dimensions so that dequantization broadcasts.  A slice whose
    largest magnitude is 0 takes scale 1.0 and round-trips to exact zeros
    (empty clusters' rows, every iteration)."""
    x = x.float()
    if axis is None:
        amax = torch.amax(torch.abs(x)) if x.numel() else \
            torch.zeros((), device=x.device)
    else:
        amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    # the reference's compiled program multiplies by f32(1 / 127): XLA
    # turns its division by the constant 127 into that product
    scale = torch.where(amax > 0.0, amax, 127.0) * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(tree, state: EFState, axes=None):
    """EF-quantize a tree -> ``((int8, scale) payload tree, new EFState)``.
    The residual (what int8 could not hold) stays and is added back next
    call.  ``axes``: a tree like ``tree`` of each leaf's ``quantize_int8``
    axis (``None``: one scale a tensor everywhere)."""
    if axes is None:
        payload = _map(lambda g, r: quantize_int8(g.float() + r), tree,
                       state.residual)
    else:
        payload = _map(lambda g, r, a: quantize_int8(g.float() + r, axis=a),
                       tree, state.residual, axes)
    residual = _map(lambda g, r, p: fma_f32(-p[0].float(), p[1],
                                         g.float() + r),
                    tree, state.residual, payload)
    return payload, EFState(residual=residual)


def compress_grads(grads, state: EFState):
    """The gradient entry point: one scale a tensor."""
    return compress_tree(grads, state)


def decompress_grads(payload, dtype=torch.float32):
    return _map(lambda p: dequantize_int8(*p).to(dtype), payload)


def ef_allreduce(tree, state: EFState, grp=None, axes=None,
                 return_error_bound: bool = False):
    """int8 error-feedback all-reduce of a stats tree over the process
    group ``grp`` (``None``: the world).

    Each rank quantizes its ``tree`` plus its carried residual; the int8
    payload and its scales are all-gathered (int8 is what crosses the
    wire: one all-gather of every leaf's values, one of every scale) and
    every rank dequantize-sums them in rank order (each product after the
    first fused into the sum), so all ranks hold the same reduced f32
    tree.  Returns ``(reduced tree, new EFState)``; with
    ``return_error_bound`` also the tree of the worst-case elementwise
    dequantization error (each rank rounds by at most ``scale / 2``: the
    gathered scales summed and halved, shaped as each leaf's scale).
    """
    payload, state = compress_tree(tree, state, axes=axes)
    parts = _leaves(payload)
    qs, scales = parts[0::2], parts[1::2]
    q_all = comm.all_gather(torch.cat([q.reshape(-1) for q in qs]), grp)
    s_all = comm.all_gather(torch.cat([s.reshape(-1) for s in scales]), grp)
    red, err = [], []
    q_off = s_off = 0
    for q, s in zip(qs, scales):
        qg = q_all[:, q_off:q_off + q.numel()].reshape((-1,) + q.shape)
        sg = s_all[:, s_off:s_off + s.numel()].reshape((-1,) + s.shape)
        q_off += q.numel()
        s_off += s.numel()
        acc = dequantize_int8(qg[0], sg[0])
        half = sg[0]
        for r in range(1, qg.shape[0]):
            acc = fma_f32(qg[r].float(), sg[r], acc)
            half = half + sg[r]
        red.append(acc)
        err.append(0.5 * half)
    it_red, it_err = iter(red), iter(err)
    reduced = _map(lambda p: next(it_red), payload)
    if not return_error_bound:
        return reduced, state
    return reduced, state, _map(lambda p: next(it_err), payload)


def payload_bytes(tree) -> int:
    """Bytes a tree of tensors occupies on the wire."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))
