"""Where the port's entry points run.

Every entry point takes ``device=``.  Left out, it means the first CUDA
card, and the call raises when there is none: the port never carries on
quietly on the CPU.  ``device="cpu"`` runs the plain PyTorch versions of the
kernels, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} asked for, but no CUDA "
                           f"device is available")
    return dev


def as_f32(t, device: torch.device) -> torch.Tensor:
    """A contiguous float32 tensor on ``device`` (numpy arrays accepted)."""
    return torch.as_tensor(t, dtype=torch.float32, device=device).contiguous()
