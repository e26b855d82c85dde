"""Whisper-small [arXiv:2212.04356] — encoder-decoder audio model.

12L encoder + 12L decoder, d_model=768, 12 heads (MHA, kv=12), d_ff=3072,
vocab 51865. The conv1d+mel frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (1500 frames x 80 mel features) projected by a
linear layer. Encoder context fixed at 1500 frames (30 s of audio).

Enc-dec: decode shapes lower the decoder step with self-attn KV cache at the
assigned seq_len plus cross-attn KV over the encoder output.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,  # decoder layers
    encoder_layers=12,
    encoder_seq=1_500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3_072,
    vocab_size=51_865,
    activation="gelu",
    frontend="audio_stub",
    frontend_dim=80,  # mel bins
    rope_theta=10_000.0,  # decoder uses learned pos in the original; RoPE here
)
