"""chameleon-34b [vlm]: 48L d=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.

Early-fusion multimodal: VQ-VAE image tokens share the text vocabulary, so
the backbone is a plain decoder over fused token streams (the VQ frontend
is the stub; IPKMeans trains the VQ codebook — examples/cluster_embeddings).
QK-norm per Chameleon's training-stability fix.  [arXiv:2405.09818]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, head_dim=128,
    norm="rmsnorm", qk_norm=True, rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="chameleon-34b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=160, vocab_size=503, head_dim=8,
    norm="rmsnorm", qk_norm=True, dtype="float32", remat="none",
)
