"""Nemotron-4-340B [arXiv:2402.16819] — dense GQA, squared-ReLU MLP.

96L, d_model=18432, 96 heads (GQA kv=8), d_ff=73728, vocab 256000.
Nemotron-4 uses squared-ReLU activation and no gated MLP.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18_432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,  # 18432 / 96
    d_ff=73_728,
    vocab_size=256_000,
    activation="squared_relu",
    rope_theta=10_000.0,
)
