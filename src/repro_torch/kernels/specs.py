"""Kernel geometry and what the card gives a launch, the counterpart of
``repro.kernels.specs``.

  * :class:`KernelSpec`: the frozen tile policy the wrappers take as
    ``spec=`` (``block_n``, ``block_k``, ``acc_dtype``, ``group_t``), with
    the reference's validation, ``tile_shapes`` and ``update_tile_shapes``.
    The port's CUDA kernels have their own fixed tiles (``lloyd_device.cuh``),
    so the geometry does not change how they walk the data, and ``coerce``
    refuses a spec whose ``block_k`` or ``group_t`` is not the default,
    which no port kernel would read.  What a spec changes is the
    arithmetic: with ``acc_dtype="bfloat16"`` the score
    kernels (assign, init sweep, the fused pass) round the operands, each
    dot product and each score to bfloat16 where the reference's bf16
    kernels do, and the accumulating kernels (centroid update, the fused
    pass) round each cluster's weighted partial sum over a block of
    ``bn`` rows of the point order to bfloat16, ``bn`` being the clamped
    ``block_n`` of ``tile_shapes`` / ``update_tile_shapes``.
  * :class:`DeviceProfile` / :func:`get_profile`: the card's name
    (``device_kind``, which keys the tuning cache, ``kernels/tuning.py``)
    and one block's opt-in shared memory, the budget the feasibility guards
    read (``batch_resident.batched_feasible``, ``centroid_update.check_k``).
    On a card it is queried from the card; on the CPU it is the H100's row,
    so the plain versions take the same fallback decisions, and resolve the
    same cache entries, as the kernels.

The reference's VMEM pricing (``*_vmem_bytes``, ``batched_group_size``)
prices TPU memory for its tuner's sweep, which the port does not have yet
(``kernels/tuning.py`` holds the cache's lookup half).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

_ACC_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel launch geometry: frozen and hashable, never mutated
    (``replace``).  ``acc_dtype`` is the on-chip compute dtype
    (``"float32"`` or ``"bfloat16"``); ``group_t`` the reference's
    batched-kernel group size (``None``: budget-derived).  ``block_k`` and
    ``group_t`` are validated as the reference's; no port kernel reads
    them yet, and :func:`coerce` refuses values other than the defaults."""

    block_n: int = 256
    block_k: int = 128
    acc_dtype: str = "float32"
    group_t: int | None = None

    def __post_init__(self):
        for name in ("block_n", "block_k"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 8 or v % 8:
                raise ValueError(
                    f"{name}={v!r}: block sizes must be ints, >= 8 and "
                    f"sublane-aligned (multiples of 8)")
        if self.acc_dtype not in _ACC_DTYPES:
            raise ValueError(f"acc_dtype={self.acc_dtype!r}: "
                             f"expected one of {_ACC_DTYPES}")
        if self.group_t is not None and (
                not isinstance(self.group_t, int) or self.group_t < 1):
            raise ValueError(f"group_t={self.group_t!r}: group sizes must "
                             f"be ints >= 1 (or None for budget-derived)")

    def replace(self, **kw) -> "KernelSpec":
        return dataclasses.replace(self, **kw)

    @property
    def bf16(self) -> bool:
        return self.acc_dtype == "bfloat16"

    def tile_shapes(self, n: int, d: int, k: int):
        """(bn, bk, n_pad, k_pad, d_pad) of the reference's (n x k)-gridded
        kernels (assign, fused, init sweep): blocks clamp to the problem,
        n and k pad to block multiples, d to the 128-lane boundary."""
        bn = min(self.block_n, max(8, n))
        bk = min(self.block_k, max(8, k))
        n_pad = -(-n // bn) * bn
        k_pad = -(-k // bk) * bk
        d_pad = max(-(-d // 128) * 128, 128)
        return bn, bk, n_pad, k_pad, d_pad

    def update_tile_shapes(self, n: int, d: int, k: int):
        """(bn, n_pad, k_pad, d_pad) of the reference's n-gridded
        segment-sum kernel (centroid update): k pads to 8 plus one trash
        row."""
        bn = min(self.block_n, max(8, n))
        n_pad = -(-n // bn) * bn
        d_pad = max(-(-d // 128) * 128, 128)
        k_pad = max(-(-(k + 1) // 8) * 8, 8)
        return bn, n_pad, k_pad, d_pad

    @property
    def acc_bytes(self) -> int:
        return 2 if self.bf16 else 4

    # ---- tuning-cache (de)serialisation, the reference's schema ----

    def to_json(self) -> dict:
        out = {"block_n": self.block_n, "block_k": self.block_k,
               "acc_dtype": self.acc_dtype}
        if self.group_t is not None:       # absent: budget-derived
            out["group_t"] = self.group_t
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "KernelSpec":
        group_t = obj.get("group_t")
        return cls(block_n=int(obj["block_n"]), block_k=int(obj["block_k"]),
                   acc_dtype=str(obj.get("acc_dtype", "float32")),
                   group_t=None if group_t is None else int(group_t))


# the module defaults of the reference's kernels
DEFAULT_SPEC = KernelSpec(block_n=256, block_k=128)
UPDATE_DEFAULT_SPEC = KernelSpec(block_n=512, block_k=128)


def coerce(spec: KernelSpec | None = None, *,
           default: KernelSpec = DEFAULT_SPEC) -> KernelSpec:
    """``spec``, or the kernel's module default when ``None``.  A spec that
    sets ``block_k`` or ``group_t`` away from the default raises
    ``ValueError``: the port's kernels read ``block_n`` and ``acc_dtype``
    only, and would ignore them."""
    if spec is None:
        return default
    if not isinstance(spec, KernelSpec):
        raise TypeError(f"spec must be a KernelSpec, got {type(spec)!r}")
    if spec.block_k != default.block_k or spec.group_t is not None:
        raise ValueError(
            f"block_k={spec.block_k!r}, group_t={spec.group_t!r}: the port's "
            f"kernels read block_n and acc_dtype only; leave block_k at "
            f"{default.block_k} and group_t at None")
    return spec


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """What one block of a launch gets on a card: ``device_kind``, the
    card's name (``torch.cuda.get_device_name``), and ``smem_per_block``,
    the opt-in shared memory per block in bytes (what a kernel may ask for
    with ``cudaFuncAttributeMaxDynamicSharedMemorySize``)."""

    device_kind: str
    smem_per_block: int

    def fits(self, nbytes: int) -> bool:
        return nbytes <= self.smem_per_block


# what a CPU tensor's plain version budgets with: the H100's name and opt-in
# shared memory per block, so it takes the kernels' fallback decisions and
# reads their tuning-cache entries
CPU_PROFILE = DeviceProfile("NVIDIA H100 80GB HBM3", 232448)


@functools.lru_cache(maxsize=None)
def _card_profile(index: int) -> DeviceProfile:
    props = torch.cuda.get_device_properties(index)
    return DeviceProfile(torch.cuda.get_device_name(index),
                         int(props.shared_memory_per_block_optin))


def get_profile(device: torch.device | str | None = None) -> DeviceProfile:
    """The profile of ``device``: a CUDA device's is queried from the card
    once (``None``: the current CUDA device, or the CPU's without one); the
    CPU's is the H100's (``CPU_PROFILE``)."""
    if device is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = torch.device(device)
    if dev.type != "cuda":
        return CPU_PROFILE
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _card_profile(index)
