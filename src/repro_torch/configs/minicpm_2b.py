"""minicpm-2b [dense]: 40L d=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.

Llama-like with muP-style scaling: embeddings scaled by scale_emb=12,
residual branches by scale_depth/sqrt(L) = 1.4/sqrt(40), logits by
1/(d_model/dim_base) with dim_base=256; tied embeddings; trained with the
WSD schedule (implemented in repro.optim.schedules).  [arXiv:2404.06395]
"""
import math

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, head_dim=64,
    norm="rmsnorm", tie_embeddings=True,
    embed_scale=12.0,
    residual_scale=1.4 / math.sqrt(40),
    logit_scale=256.0 / 2304.0,
)

SMOKE_CONFIG = ModelConfig(
    name="minicpm-2b-smoke", family="dense",
    num_layers=2, d_model=72, num_heads=6, num_kv_heads=6,
    d_ff=180, vocab_size=503, head_dim=12,
    norm="rmsnorm", tie_embeddings=True,
    embed_scale=12.0, residual_scale=1.4 / math.sqrt(2),
    logit_scale=256.0 / 2304.0, dtype="float32", remat="none",
)
