"""Where the port's entry points run.

Every entry point takes ``device=``.  Left out, it means the first CUDA
card, and the call raises when there is none: the port never carries on
quietly on the CPU (under a ``FakeTensorMode`` it is a fake card instead,
which the dry run traces on).  ``device="cpu"`` runs the plain PyTorch
versions of the kernels, as the tests do.  Inputs keep their dtype, float32
or bfloat16 (``as_float``), as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device`` (``None``: CUDA).  CUDA on a host
    without a card raises, except while a ``FakeTensorMode`` is active (the
    dry run, ``launch/kmeans_dryrun.py``): there it is the fake card
    ``cuda:0``, whose tensors hold no memory."""
    if device is None:
        if not torch.cuda.is_available():
            if _fake_mode():
                return torch.device("cuda", 0)
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        if _fake_mode():
            return torch.device("cuda", 0 if dev.index is None else dev.index)
        raise RuntimeError(f"device {str(dev)!r} asked for, but no CUDA "
                           f"device is available")
    return dev


def _fake_mode() -> bool:
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None


# the float dtypes the port carries as they are, as the reference keeps its
# inputs' dtype
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def _from_numpy(a) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes, such as a JAX array)
    as a tensor.  A bfloat16 array (``ml_dtypes.bfloat16``, which
    ``torch.as_tensor`` refuses) crosses bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:       # torch keeps no read-only tensors
            a = a.copy()
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def as_float(t, device: torch.device) -> torch.Tensor:
    """A contiguous float32 or bfloat16 tensor on ``device`` in the input's
    own dtype (numpy and JAX arrays accepted; integer and bool inputs become
    float32).  Any other float dtype raises ``TypeError``: the port computes
    in float32, carrying bfloat16 inputs as the reference does, and never
    converts a float input quietly."""
    if not isinstance(t, torch.Tensor):
        t = (torch.as_tensor(t) if isinstance(t, (list, tuple, float, int))
             else _from_numpy(t))
    if not t.is_floating_point():
        t = t.float()
    elif t.dtype not in FLOAT_DTYPES:
        raise TypeError(f"the port takes float32 or bfloat16 inputs, got "
                        f"{t.dtype}")
    return t.to(device).contiguous()


def as_weights(t, device: torch.device) -> torch.Tensor:
    """A mask or weights as a contiguous float32 tensor on ``device`` (0/1
    masks are exact in every dtype; the reference casts them to the points'
    dtype, the port keeps its weights in float32)."""
    if not isinstance(t, torch.Tensor):
        t = _from_numpy(t)
    return t.to(device=device, dtype=torch.float32).contiguous()

