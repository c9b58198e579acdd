"""The port's kernels and the engines that run them.

``fused`` holds the hand-written CUDA fused Lloyd pass (``csrc/
fused_lloyd.cu``) and its plain PyTorch version; ``ops`` wraps it for one
subset or a stack; ``engine`` is the backend registry (``eager`` | ``fused``).
Importing this package needs no GPU and no compiler: the CUDA source is built
at the first launch on a CUDA tensor (``_build``).
"""
from repro_torch.kernels import engine, fused, ops, ref

__all__ = ["engine", "fused", "ops", "ref"]
