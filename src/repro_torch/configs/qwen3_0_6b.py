"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B family] — dense GQA with qk-norm.

28L, d_model=1024, 16 heads (GQA kv=8), head_dim=128 (decoupled from d_model),
d_ff=3072, vocab 151936, SwiGLU, RMSNorm on Q/K per head (qk_norm).
This is the natural *edge-tier* model in the MoA-Off pairing.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,  # qwen3 decouples head_dim from d_model/num_heads
    d_ff=3_072,
    vocab_size=151_936,
    activation="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
