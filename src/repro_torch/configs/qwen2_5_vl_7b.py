"""Qwen2.5-VL-7B [arXiv:2502.13923] — the paper's CLOUD model (§4.1).

28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab 152064, ViT frontend
(stubbed patch embeddings per the assignment).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3_584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    activation="swiglu",
    frontend="vision_stub",
    num_patches=256,
    frontend_dim=1_280,
    rope_theta=1_000_000.0,
)
