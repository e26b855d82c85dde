"""Model zoo entry point. Counterpart of ``repro/models/__init__.py``."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.config import ModelConfig


def build_model(cfg: ModelConfig, attn_impl: str = "auto",
                param_dtype: str = "", decode_impl: str = "auto",
                device: Union[str, torch.device] = "cuda"):
    """Construct the family-appropriate model on ``device`` (default
    ``cuda``; raises when no card is present)."""
    from repro_torch.models.transformer import FAMILIES, DecoderLM

    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP queue 1, "
            f"item 11 (remaining families: moe next, then encdec)")

    return DecoderLM(cfg, attn_impl=attn_impl, param_dtype=param_dtype,
                     decode_impl=decode_impl, device=device)
