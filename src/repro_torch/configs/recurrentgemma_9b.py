"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1) d_ff=12288
vocab=256000.  Griffin: repeating (RG-LRU, RG-LRU, local-attention-2048)
pattern — 12 full units + 2 trailing recurrent layers.  O(1) recurrent
state + ring local-attn cache => runs long_500k.  [arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    norm="rmsnorm",
    recurrent=RecurrentConfig(lru_width=4096, conv_width=4,
                              pattern=("rglru", "rglru", "attn"),
                              local_window=2048),
    supports_long_context=True,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    num_layers=4, d_model=48, num_heads=4, num_kv_heads=1,
    d_ff=96, vocab_size=503, head_dim=12,
    norm="rmsnorm",
    recurrent=RecurrentConfig(lru_width=48, conv_width=4,
                              pattern=("rglru", "rglru", "attn"),
                              local_window=16),
    supports_long_context=True, dtype="float32", remat="none",
)
