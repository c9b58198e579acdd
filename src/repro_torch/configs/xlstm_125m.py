"""xlstm-125m [ssm]: 12L d=768 4H vocab=50304, d_ff=0 (FFN folded into the
mLSTM block's 2x up-projection).  xLSTM[10:2]-style mix: sLSTM blocks at
layers {3, 9}, mLSTM elsewhere.  Chunkwise-parallel mLSTM (chunk 256);
O(1) matrix-memory state => runs long_500k.  [arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=192,
    norm="rmsnorm", tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_layers=(3, 9), num_heads=4,
                      proj_factor=2.0, chunk_size=256),
    supports_long_context=True,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-125m-smoke", family="ssm",
    num_layers=4, d_model=48, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab_size=503, head_dim=24,
    norm="rmsnorm", tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_layers=(1,), num_heads=2,
                      proj_factor=2.0, chunk_size=16),
    supports_long_context=True, dtype="float32", remat="none",
)
