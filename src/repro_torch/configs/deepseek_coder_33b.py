"""DeepSeek-Coder-33B [arXiv:2401.14196] — llama-arch dense GQA.

62L, d_model=7168, 56 heads (GQA kv=8), d_ff=19200, vocab 32256, SwiGLU.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19_200,
    vocab_size=32_256,
    activation="swiglu",
    rope_theta=100_000.0,
)
