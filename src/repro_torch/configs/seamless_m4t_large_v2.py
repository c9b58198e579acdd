"""seamless-m4t-large-v2 [audio]: enc-dec, 24L encoder + 24L decoder,
d=1024 16H (MHA kv=16) d_ff=8192 vocab=256206.

The speech frontend (w2v-BERT conformer feature extractor) is a STUB per
the assignment: input_specs() supplies precomputed (B, frames, d) frame
embeddings to the encoder; the decoder is a standard causal transformer
with cross-attention.  [arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, encoder_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    norm="layernorm", frontend="audio_frames",
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-large-v2-smoke", family="audio",
    num_layers=2, encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=503, head_dim=16,
    norm="layernorm", frontend="audio_frames",
    dtype="float32", remat="none",
)
