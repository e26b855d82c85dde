"""Kimi-K2 1T-A32B [arXiv:2501 Kimi K2] — trillion-parameter MoE.

61L, d_model=7168, 64 heads (GQA kv=8), per-expert d_ff=2048, 384 experts
top-8 + 1 shared expert, first layer dense (d_ff 18432), vocab 163840.
~1.04T total params, ~32B active per token.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7_168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18_432,  # dense layers (first_k_dense) width
    vocab_size=163_840,
    activation="swiglu",
    num_experts=384,
    top_k=8,
    moe_d_ff=2_048,
    num_shared_experts=1,
    first_k_dense=1,
    rope_theta=50_000.0,
)
