"""deepseek-v3-671b [moe]: 61L d=7168 128H, MoE 256 routed experts top-8 +
1 shared, expert d_ff=2048, vocab=129280, MLA attention.

First 3 layers are dense (d_ff=18432); layers 4-61 are MoE.  Router is
sigmoid-scored with normalized top-8 and routed_scaling=2.5.  MLA:
q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128.  MTP (multi-token
prediction) is a training objective, not an architecture change — noted as
out of scope in DESIGN.md.  [arXiv:2412.19437]
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432,                       # dense (first_dense_layers) FFN width
    vocab_size=129280,
    norm="rmsnorm", rope_theta=10_000.0,
    # gather (sort-based) dispatch: the GShard einsum one-hot is (T, E, C)
    # = O(1e13) elements at 1M tokens x 256 experts — the sort-based path
    # keeps dispatch state at O(T*top_k) indices + an (E, C, d) buffer.
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, d_ff_shared=2048,
                  router_score="sigmoid_norm", routed_scaling=2.5,
                  capacity_factor=1.25, dispatch="gather",
                  first_dense_layers=3),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=144, vocab_size=503,
    norm="rmsnorm",
    # capacity_factor 8 = drop-free at smoke scale, so teacher-forced and
    # incremental decode are bit-comparable in tests (capacity dropping is
    # load-dependent and legitimately differs between the two)
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=48,
                  num_shared_experts=1, d_ff_shared=48,
                  router_score="sigmoid_norm", routed_scaling=2.5,
                  capacity_factor=8.0, dispatch="einsum",
                  first_dense_layers=1),
    mla=MLAConfig(q_lora_rank=24, kv_lora_rank=16,
                  qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8),
    dtype="float32", remat="none",
)
