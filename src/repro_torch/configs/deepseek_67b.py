"""deepseek-67b [dense]: 95L d=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.

Llama-architecture: RMSNorm, RoPE, SwiGLU, untied embeddings.
[arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400, head_dim=128,
    norm="rmsnorm", rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-67b-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=160, vocab_size=503, head_dim=8,
    norm="rmsnorm", dtype="float32", remat="none",
)
