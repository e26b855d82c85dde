"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B] — 128-expert top-8 MoE.

94L, d_model=4096, 64 heads (GQA kv=4), per-expert d_ff=1536, 128 experts
top-8, vocab 151936, qk_norm, no shared experts.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4_096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=12_288,  # unused (no dense layers); kept for the cost model's MLP bound
    vocab_size=151_936,
    activation="swiglu",
    qk_norm=True,
    num_experts=128,
    top_k=8,
    moe_d_ff=1_536,
    num_shared_experts=0,
    first_k_dense=0,
    rope_theta=1_000_000.0,
)
