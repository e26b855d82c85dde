"""Phi-3-Vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct] — VLM.

phi3-mini backbone: 32L, d_model=3072, 32 heads (kv=32 -> MHA), d_ff=8192,
vocab 32064, SwiGLU. CLIP ViT-L/14-336 frontend is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings (576 patches, 1024-d)
which a linear projector maps into the backbone embedding space.

This is the *most paper-representative* arch: a true image+text MLLM whose
modalities are routed independently by the MoA-Off policy.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3_072,
    num_heads=32,
    num_kv_heads=32,  # MHA
    head_dim=96,
    d_ff=8_192,
    vocab_size=32_064,
    activation="swiglu",
    frontend="vision_stub",
    num_patches=576,  # ViT-L/14 @ 336px
    frontend_dim=1_024,  # CLIP ViT-L hidden
    rope_theta=10_000.0,
)
