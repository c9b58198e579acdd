"""The port's kernels and the engines that run them.

``fused`` holds the hand-written CUDA fused Lloyd pass (``csrc/
fused_lloyd.cu``) and its plain PyTorch version; ``batch_resident`` the
whole-solve kernel (``csrc/lloyd_solve.cu``) over a stack and its plain
version, and ``resident`` the same kernel on one subset; ``ops`` wraps them;
``engine`` is the backend registry (``eager`` | ``fused`` | ``resident`` |
``batched``).  Importing this package needs no GPU and no compiler: the
CUDA sources are built at the first launch on a CUDA tensor (``_build``).
"""
from repro_torch.kernels import (batch_resident, engine, fused, ops, ref,
                                 resident)

__all__ = ["batch_resident", "engine", "fused", "ops", "ref", "resident"]
