"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.

Cohere Command R: parallel attention+FFN block off a single bias-free
LayerNorm, tied embeddings, logit scaling.  [hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, head_dim=128,
    norm="layernorm", parallel_block=True, tie_embeddings=True,
    logit_scale=0.0625, rope_theta=8_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="command-r-35b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=160, vocab_size=503, head_dim=8,
    norm="layernorm", parallel_block=True, tie_embeddings=True,
    logit_scale=0.0625, rope_theta=8_000_000.0, dtype="float32",
    remat="none",
)
