"""Public wrappers around the CUDA kernels. Counterpart of
``repro/kernels/ops.py``.

Each wrapper picks by the device of the tensors it is given: a CPU tensor
runs the plain PyTorch version, a CUDA tensor launches the kernel (or the
kernel wrapper raises on what it does not take); any other device raises.
Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, once the launch has returned without error, so a
run can show that its path went through the kernel. The kernels take head dims 32/64/128 unpadded and scale scores by
the true head dim, so the JAX package's ``_pad_head`` has no counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import ComplexityConfig
from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_paged_cuda,
    decode_attention_paged_plain, decode_attention_plain)
from repro_torch.kernels.image_complexity import (image_stats_cuda,
                                                  image_stats_plain)


def _route(x: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no version for device {x.device}")


# ---------------------------------------------------------------------------
# image complexity
# ---------------------------------------------------------------------------


def image_stats(imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Raw stats per image. imgs: (B, H, W) float32 in [0, 255]."""
    if _route(imgs, "image_stats"):
        out = image_stats_cuda(imgs)
        image_stats.launches += 1
        return out
    return image_stats_plain(imgs)


image_stats.launches = 0


def image_complexity_from_stats(stats: dict, h: int, w: int,
                                cc: ComplexityConfig) -> dict:
    """Scalar post-processing of kernel stats -> Eq. 2/3/4 + c_img."""
    n = float(h * w)
    g_mean = stats["sobel_sum"] / n
    c_edge = torch.clamp((g_mean - cc.edge_p5)
                         / (cc.edge_p95 - cc.edge_p5 + cc.eps), 0.0, 1.0)
    lap_mean = stats["lap_sum"] / n
    lap_var = stats["lap_sq_sum"] / n - lap_mean ** 2
    c_lap = torch.clamp((lap_var - cc.lap_p5)
                        / (cc.lap_p95 - cc.lap_p5 + cc.eps), 0.0, 1.0)
    p = stats["hist"] / n
    safe = torch.where(p > 0, p, torch.ones_like(p))
    ent = -torch.sum(torch.where(p > 0, p * torch.log(safe),
                                 torch.zeros_like(p)), dim=-1)
    c_ent = ent / torch.log(torch.tensor(256.0, device=p.device))
    c_res = torch.full_like(c_edge, min(1.0, n / float(cc.ref_h * cc.ref_w)))
    c_img = (cc.w_res * c_res + cc.w_edge * c_edge
             + cc.w_ent * c_ent + cc.w_lap * c_lap)
    return {"c_res": c_res, "c_edge": c_edge, "c_ent": c_ent, "c_lap": c_lap,
            "c_img": c_img}


def image_complexity(imgs: torch.Tensor,
                     cc: ComplexityConfig = ComplexityConfig()) -> dict:
    """End-to-end §3.1.1: (B,H,W) images -> complexity components + c_img."""
    stats = image_stats(imgs)
    return image_complexity_from_stats(stats, imgs.shape[1], imgs.shape[2], cc)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, pos_q, pos_cache, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Decode against a dense (B, T, K, hd) cache (strided views allowed)."""
    if _route(q, "decode_attention"):
        out = decode_attention_cuda(q, k_cache, v_cache, pos_q, pos_cache,
                                    window=window)
        decode_attention.launches += 1
        return out
    return decode_attention_plain(q, k_cache, v_cache, pos_q, pos_cache,
                                  window=window)


decode_attention.launches = 0


def decode_attention_paged(q, k_pool, v_pool, pages, pos_q, pos_cache, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """Decode through a page table: k/v_pool (P, page, K, hd) physical
    pages, pages (B, NP) int32 page-table rows, pos_cache (B, T)."""
    if _route(q, "decode_attention_paged"):
        out = decode_attention_paged_cuda(q, k_pool, v_pool, pages, pos_q,
                                          pos_cache, window=window)
        decode_attention_paged.launches += 1
        return out
    return decode_attention_paged_plain(q, k_pool, v_pool, pages, pos_q,
                                        pos_cache, window=window)


decode_attention_paged.launches = 0

#: every counted wrapper, by name (for resetting and reading the counts)
COUNTED = {"image_stats": image_stats,
           "decode_attention": decode_attention,
           "decode_attention_paged": decode_attention_paged}


def reset_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in COUNTED.items()}
