"""Architecture config schema — one frozen dataclass drives every model.

The port's copy of ``repro.configs.base``, field for field, so that a config
means the same model in both packages.  Each architecture has a
``configs/<id>.py`` exporting ``CONFIG`` (the exact published shape) and
``SMOKE_CONFIG`` (same family, tiny dims).  The smoke configs run on the CPU
in the tests; the dense full configs serve on the card (``chip_smoke.py``
[lm]).  ``remat`` and the sharding-related fields are kept for parity and
read by nothing on the serving path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int                    # per-expert hidden width
    num_shared_experts: int = 0         # DeepSeek-V3 shared expert(s)
    d_ff_shared: int = 0
    router_score: str = "softmax"       # 'softmax' | 'sigmoid_norm' (DSv3)
    capacity_factor: float = 1.25
    dispatch: str = "gather"            # 'dense' | 'gather' | 'einsum'
    first_dense_layers: int = 0         # leading layers use a dense FFN
    routed_scaling: float = 1.0         # DSv3 gate scaling


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    """Griffin/RG-LRU (recurrentgemma) hybrid settings."""
    lru_width: int = 0                  # 0 -> d_model
    conv_width: int = 4
    pattern: tuple[str, ...] = ("rglru", "rglru", "attn")   # repeating unit
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_layers: tuple[int, ...] = ()  # indices using sLSTM blocks
    num_heads: int = 4
    proj_factor: float = 2.0            # mLSTM block up-projection
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 256               # mLSTM chunkwise-parallel chunk


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # default d_model // num_heads
    # attention flavor
    attention: str = "full"             # 'full' | 'sliding'
    window: Optional[int] = None
    qk_norm: bool = False               # chameleon
    rope_theta: float = 10_000.0
    # block flavor
    norm: str = "rmsnorm"               # 'rmsnorm' | 'layernorm'
    parallel_block: bool = False        # command-r: attn + FFN in parallel
    tie_embeddings: bool = False
    logit_scale: float = 1.0            # command-r logit scaling
    embed_scale: float = 1.0            # minicpm scale_emb
    residual_scale: float = 1.0         # minicpm scale_depth / sqrt(L)
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # enc-dec (seamless): encoder_layers > 0 => encoder-decoder model
    encoder_layers: int = 0
    # modality frontend stub: 'none' | 'audio_frames' (precomputed embeddings)
    frontend: str = "none"
    # numerics
    dtype: str = "bfloat16"
    # remat policy for the layer scan: 'none' | 'full' | 'dots'
    remat: str = "full"
    # chunked-attention sizes (perf-tunable; see EXPERIMENTS.md §Perf)
    q_chunk: int = 512
    kv_chunk: int = 1024
    # can this arch run the 500k-token decode shape?
    supports_long_context: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Exact parameter count (embeddings + blocks), from the port's
        init on the ``meta`` device (nothing allocated).  Raises
        ``NotImplementedError`` for a model kind the port does not build
        yet."""
        from repro_torch.models.registry import count_params
        return count_params(self)
