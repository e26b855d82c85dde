"""Plain PyTorch oracles for every kernel of the port (the allclose
targets). Counterpart of ``repro/kernels/ref.py``; they define the
semantics the CUDA kernels must match."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_paged_plain, decode_attention_plain)
from repro_torch.kernels.image_complexity import image_stats_plain


def image_stats_ref(img: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Raw statistics of one (H, W) image in [0, 255]: Sobel magnitude
    sum, Laplacian sum and sum of squares, 256-bin histogram."""
    return {k: v[0] for k, v in image_stats_plain(img[None]).items()}


def image_stats_batch_ref(imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """imgs: (B, H, W) -> dict of stacked stats."""
    return image_stats_plain(imgs)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,S,K,hd) -> (B,S,H,hd). Self-attention layout
    (query position i == key position i)."""
    from repro_torch.models.attention import dense_attention

    pos = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    return dense_attention(q, k, v, pos, pos, causal=causal, window=window)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos_q: torch.Tensor,
                         pos_cache: torch.Tensor, *,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B,1,H,hd); caches (B,T,K,hd); pos_q (B,); pos_cache (B,T)."""
    return decode_attention_plain(q, k_cache, v_cache, pos_q, pos_cache,
                                  window=window)


def decode_attention_paged_ref(q, k_pool, v_pool, pages, pos_q, pos_cache, *,
                               window: Optional[int] = None) -> torch.Tensor:
    """Paged decode: k/v_pool (P, page, K, hd); pages (B, NP)."""
    return decode_attention_paged_plain(q, k_pool, v_pool, pages, pos_q,
                                        pos_cache, window=window)
