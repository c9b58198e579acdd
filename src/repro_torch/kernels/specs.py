"""Kernel geometry and what the card gives a launch, the counterpart of
``repro.kernels.specs``.

  * :class:`KernelSpec`: the frozen tile policy the wrappers take as
    ``spec=`` (``block_n``, ``block_k``, ``acc_dtype``, ``group_t``), with
    the reference's validation, ``tile_shapes`` and ``update_tile_shapes``.
    What each field does to the port's CUDA kernels:

      - ``block_k``: the centroids of one score tile (``BN`` in
        ``csrc/lloyd_device.cuh``) of the assign, init-sweep and fused
        kernels, which are built for each width of :data:`BLOCK_KS`.  Every
        width gives the same bits; it only changes the speed.  ``coerce``
        refuses any other width.  The centroid update has no centroid tile,
        and the whole-solve kernel scores in tiles of 128.
      - ``group_t``: the lanes of one launch of the whole-solve kernel
        (``batch_resident.solve_stack``), the reference's subsets per grid
        step; the per-step kernels ignore it, as the reference's do.
      - ``acc_dtype="bfloat16"``: the score kernels (assign, init sweep,
        the fused pass) round the operands, each dot product and each score
        to bfloat16 where the reference's bf16 kernels do, and the
        accumulating kernels (centroid update, the fused pass) round each
        cluster's weighted partial sum over a block of ``bn`` rows of the
        point order to bfloat16, ``bn`` being the clamped ``block_n`` of
        ``tile_shapes`` / ``update_tile_shapes``.  In float32 ``block_n``
        changes nothing.

    The ``*_smem_bytes`` methods price one block of a kernel at a spec in
    shared memory, in place of the reference's ``*_vmem_bytes``: the
    tuner's sweep prunes with them (``kernels/tuning.py``).
  * :class:`DeviceProfile` / :func:`get_profile`: the card's name
    (``device_kind``, which keys the tuning cache, ``kernels/tuning.py``)
    and one block's opt-in shared memory, the budget the feasibility guards
    read (``batch_resident.batched_feasible``, ``centroid_update.check_k``,
    the tuner's pruning).  On a card it is queried from the card; on the
    CPU it is the H100's row, so the plain versions take the same fallback
    decisions, and resolve the same cache entries, as the kernels.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

_ACC_DTYPES = ("float32", "bfloat16")
F32 = 4                      # bytes per float32

# the centroid tile widths the score kernels are built for (block_k;
# lloyd::tile_width_known in csrc/lloyd_device.cuh), the reference's
# tuning.BLOCK_KS
BLOCK_KS = (64, 128, 256)
# the score kernels' tiles: 128 point rows, 16-wide feature chunks, rows
# padded by 4 floats, two buffers
_TILE_ROWS, _CHUNK, _PAD = 128, 16, 4
# the init sweep's own shared memory beside the tiles: one float a thread
# of its 256 for the potential's tree
_INIT_STATIC = 256 * F32


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel launch geometry: frozen and hashable, never mutated
    (``replace``).  ``acc_dtype`` is the on-chip compute dtype
    (``"float32"`` or ``"bfloat16"``); ``block_k`` the score kernels'
    centroid tile (one of :data:`BLOCK_KS` for a launch: :func:`coerce`);
    ``group_t`` the lanes of one whole-solve launch (``None``: the whole
    stack).  Validated as the reference's."""

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

    # ---- shared memory of one block (what the tuner prunes with) ----

    def score_tile_bytes(self) -> int:
        """The score tiles of one block at this ``block_k``
        (``lloyd::ScoreTiles<BN>``): two buffers of a 16-wide feature chunk
        of 128 point rows and of ``block_k`` centroid rows, each row padded
        by 4 floats.  Float32 in both modes: the bfloat16 mode rounds the
        values in place."""
        return 2 * _CHUNK * (_TILE_ROWS + _PAD + self.block_k + _PAD) * F32

    def assign_smem_bytes(self, n: int, d: int, k: int) -> int:
        """One block of the assign kernel (``csrc/sweeps.cu``): its score
        tiles, whatever the shape.  The reference's ``assign_vmem_bytes``
        prices its x, c and norm tiles."""
        del n, d, k
        return self.score_tile_bytes()

    def fused_smem_bytes(self, n: int, d: int, k: int) -> int:
        """The largest block of one fused step (``csrc/fused_lloyd.cu``):
        the score pass's tiles, or the accumulate's k counts
        (``update_smem_bytes``), whichever is larger.  The reference's
        ``fused_vmem_bytes`` prices its tiles and its resident (k, d)
        sums, which live in device memory here."""
        return max(self.score_tile_bytes(),
                   self.update_smem_bytes(n, d, k))

    def init_smem_bytes(self, n: int, d: int, c: int) -> int:
        """One block of the init-sweep kernel (``csrc/sweeps.cu``): its
        score tiles and the potential's 256-float tree.  The reference's
        ``init_vmem_bytes`` prices its tiles and streamed vectors."""
        del n, d, c
        return self.score_tile_bytes() + _INIT_STATIC

    def update_smem_bytes(self, n: int, d: int, k: int) -> int:
        """The largest block of the centroid update
        (``csrc/segment_sort.cuh``): the histogram and scatter passes keep
        k int32 counts.  The reference's ``update_vmem_bytes`` prices its
        tiles, one-hot and resident (k, d) block."""
        del n, d
        return k * F32

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
    """``spec``, or the kernel's module default when ``None``.  A
    ``block_k`` the score kernels are not built for (:data:`BLOCK_KS`)
    raises ``ValueError``: no kernel would launch it.  Any valid
    ``group_t`` passes; only the whole solve reads it."""
    if spec is None:
        return default
    if not isinstance(spec, KernelSpec):
        raise TypeError(f"spec must be a KernelSpec, got {type(spec)!r}")
    if spec.block_k not in BLOCK_KS:
        raise ValueError(
            f"block_k={spec.block_k!r}: the port's score kernels are built "
            f"for block_k in {BLOCK_KS}")
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

    def max_resident_points(self, d: int, k: int,
                            prune: str = "none") -> int:
        """The largest subset a whole solve of (d, k) takes in this
        profile's shared memory (``resident.max_resident_points``)."""
        from repro_torch.kernels import resident     # deferred: no cycle
        return resident.max_resident_points(d, k, prune,
                                            budget=self.smem_per_block)

    def batched_group_size(self, m: int, s: int, d: int, k: int,
                           prune: str = "none") -> int:
        """Lanes one whole-solve launch takes of an (m, s, d, k) stack in
        this profile's shared memory, 0 when one lane does not fit
        (``batch_resident.batched_group_size``)."""
        from repro_torch.kernels import batch_resident
        return batch_resident.batched_group_size(
            m, s, d, k, prune, budget=self.smem_per_block)


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
