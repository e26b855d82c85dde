"""Yi-34B [arXiv:2403.04652] — llama-arch dense GQA.

60L, d_model=7168, 56 heads (GQA kv=8), d_ff=20480, vocab 64000, SwiGLU.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    activation="swiglu",
    rope_theta=5_000_000.0,
)
