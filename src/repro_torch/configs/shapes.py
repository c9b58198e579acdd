"""The four assigned input shapes and per-arch applicability.

  train_4k     seq 4096,   global batch 256   -> train_step
  prefill_32k  seq 32768,  global batch 32    -> prefill (serve)
  decode_32k   seq 32768,  global batch 128   -> serve_step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524288, global batch 1     -> serve_step; requires
                                                 sub-quadratic attention
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-not).  long_500k needs sub-quadratic attention
    (see DESIGN.md §Arch-applicability)."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 524k-token decode is "
                       "quadratic/O(S) KV — structurally skipped")
    return True, ""


def grid_cells(configs: dict[str, ModelConfig]):
    """All (arch, shape) cells with applicability flags."""
    cells = []
    for arch, cfg in configs.items():
        for shape in SHAPES:
            ok, why = shape_applicable(cfg, shape)
            cells.append({"arch": arch, "shape": shape,
                          "runnable": ok, "skip_reason": why})
    return cells
