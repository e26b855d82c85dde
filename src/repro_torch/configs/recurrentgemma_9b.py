"""RecurrentGemma-9B [arXiv:2402.19427 Griffin] — RG-LRU + local attention 2:1.

38L, d_model=4096, 16 heads MQA (kv=1), d_ff=12288 (GeGLU), vocab 256000,
block pattern (rglru, rglru, local_attn) repeating, window 2048,
lru_width=4096.

Sub-quadratic (bounded-window attention + recurrent state): ``long_500k`` runs.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,  # rounded to full pattern repeats at build time (36 + 2)
    d_model=4_096,
    num_heads=16,
    num_kv_heads=1,  # MQA
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    activation="geglu",
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2_048,
    lru_width=4_096,
    rope_theta=10_000.0,
)
