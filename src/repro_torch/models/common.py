"""Model substrate: parameters with logical axes, norms, RoPE, SwiGLU.

The port of ``repro.models.common``.  The reference boxes every parameter
with a tuple of *logical axis names* (``'embed'``, ``'heads'``, ``'ff'``,
...) that its sharding rules map to mesh axes.  Here a parameter is an
``nn.Parameter`` of an ``nn.Module``, and each module class names its
parameters' axes in a class attribute ``AXES``; :func:`param_axes` reads
them back for a whole model, as the reference's ``unbox`` does.  The
reference's ``shard`` (a sharding constraint on an activation) has no
counterpart: the serving path runs on one device, where that call does
nothing in the reference either.

The norms, RoPE and the attention scores compute in float32 and cast back to
the input's dtype, at the reference's points.
"""
from __future__ import annotations

import torch
from torch import nn

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg) -> torch.dtype:
    """The dtype of a config's embeddings and projections (norm weights
    stay float32)."""
    return _TORCH_DTYPES[cfg.dtype]


def param_axes(model: nn.Module) -> dict[str, tuple]:
    """``{parameter name: logical axes}`` for every parameter of ``model``,
    from the ``AXES`` of the module that holds it.  A layer group's
    parameters are one module a layer, so their axes lack the reference's
    leading ``'layers'`` axis of the stacked group."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            out[full] = tuple(type(mod).AXES[name])
    return out


def new_param(shape, dtype, device, generator, *, init="normal",
              scale=None) -> nn.Parameter:
    """One parameter, drawn as the reference's ``param`` draws it:
    'normal' a normal truncated to [-2, 2] times ``scale`` (default: the
    first dim's fan-in ** -0.5), 'embed' the same times 0.02, 'zeros',
    'ones'.  The draw is in float32 from ``generator``, then cast to
    ``dtype``.  On the ``meta`` device nothing is drawn or allocated."""
    t = torch.empty(shape, dtype=torch.float32 if init not in ("zeros", "ones")
                    else dtype, device=device)
    if t.is_meta:
        return nn.Parameter(t.to(dtype), requires_grad=False)
    with torch.no_grad():
        if init == "zeros":
            t.zero_()
        elif init == "ones":
            t.fill_(1.0)
        else:
            if scale is None:
                fan_in = shape[0] if len(shape) >= 2 else shape[-1]
                scale = fan_in ** -0.5 if init == "normal" else 0.02
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            t = t.mul_(scale).to(dtype)
    return nn.Parameter(t, requires_grad=False)


def norm_param(d, kind, device) -> nn.Parameter:
    """A norm's float32 weight: zeros for RMSNorm (it scales by 1 + w),
    ones for LayerNorm."""
    return new_param((d,), torch.float32, device, None,
                     init="zeros" if kind == "rmsnorm" else "ones")


# ----------------------------- norms -----------------------------

def rmsnorm(x, weight, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layernorm(x, weight, eps=1e-5):
    """Bias-free LayerNorm (command-r style)."""
    dtype = x.dtype
    x = x.float()
    x = x - torch.mean(x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dtype)


def apply_norm(x, w, kind):
    return rmsnorm(x, w) if kind == "rmsnorm" else layernorm(x, w)


# ----------------------------- RoPE -----------------------------

def rope_freqs(head_dim, theta=10_000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta=10_000.0):
    """x: (..., S, H, Dh) with positions (..., S) — interleaved-pair RoPE:
    the pairs are ``x[..., 0::2]`` and ``x[..., 1::2]``."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    angles = positions[..., None].float() * freqs           # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ----------------------------- misc -----------------------------

def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: silu(x @ Wg) * (x @ Wu) @ Wd."""
    g = torch.nn.functional.silu(torch.einsum("...d,df->...f", x, w_gate))
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", g * u, w_down)
