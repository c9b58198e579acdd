"""command-r-plus-104b [dense]: 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab=256000.  Same Cohere family as command-r-35b (parallel block, tied
embeddings, no bias).  [hf:CohereForAI/c4ai-command-r-plus; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000, head_dim=128,
    norm="layernorm", parallel_block=True, tie_embeddings=True,
    logit_scale=0.0625, rope_theta=8_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense",
    num_layers=2, d_model=96, num_heads=12, num_kv_heads=2,
    d_ff=256, vocab_size=503, head_dim=8,
    norm="layernorm", parallel_block=True, tie_embeddings=True,
    logit_scale=0.0625, dtype="float32", remat="none",
)
