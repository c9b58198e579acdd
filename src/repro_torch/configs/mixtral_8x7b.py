"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8), 8 experts top-2
(expert d_ff=14336), vocab=32000, sliding-window attention (4096).

SWA makes the 500k-token decode cell runnable (ring KV cache of window
size).  Gather-based MoE dispatch: 8 experts, replicated over the model
axis with d_ff sharded.  [arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    attention="sliding", window=4096,
    norm="rmsnorm", rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336,
                  router_score="softmax", capacity_factor=1.25,
                  dispatch="gather"),
    supports_long_context=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=160, vocab_size=503, head_dim=8,
    attention="sliding", window=32,
    norm="rmsnorm",
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=48,
                  router_score="softmax", capacity_factor=8.0,
                  dispatch="gather"),
    supports_long_context=True, dtype="float32", remat="none",
)
