"""Model registry: config -> init / decode entry points + param math.

The port of ``repro.models.registry`` for the serving path.  Every kind the
port does not build yet (``moe``, ``mla_*``, ``griffin*``, ``mlstm``,
``slstm`` and the encoder-decoder) raises ``NotImplementedError`` naming
ROADMAP queue 1 item 3.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> transformer.Transformer:
    return transformer.init_params(cfg, generator, device)


def decode_step_fn(cfg: ModelConfig):
    transformer.check_ported(cfg)
    return lambda m, caches, tok, pos: transformer.decode_step(
        m, caches, tok, pos, cfg)


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device=None):
    return transformer.init_decode_caches(cfg, batch, max_len, device)


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the model built on the ``meta`` device
    (no allocation), the counterpart of the reference's
    ``count_params_abstract``.  Its ``active_only`` count, which weighs MoE
    experts, comes with the MoE slice."""
    model = transformer.init_params(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())
