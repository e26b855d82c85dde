"""Mamba2-2.7B [arXiv:2405.21060] — pure SSM (state-space duality / SSD).

64L, d_model=2560, attention-free, d_ff=0 (no MLP; the Mamba block IS the
mixer), vocab 50280, ssm_state=128, expand=2 (d_inner=5120), head_dim=64
(80 SSD heads), conv4, chunk=256.

Sub-quadratic: ``long_500k`` decode runs (O(1) state per step).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2_560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
