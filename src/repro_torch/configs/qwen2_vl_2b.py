"""Qwen2-VL-2B [arXiv:2409.12191] — the paper's EDGE model (§4.1).

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab 151936, ViT frontend
(stubbed patch embeddings per the assignment).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1_536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8_960,
    vocab_size=151_936,
    activation="swiglu",
    frontend="vision_stub",
    num_patches=256,
    frontend_dim=1_280,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
