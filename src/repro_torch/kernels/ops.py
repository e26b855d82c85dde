"""Public wrappers around the CUDA kernels. Counterpart of
``repro/kernels/ops.py``.

Each wrapper picks by the device of the tensors it is given: a CPU tensor
runs the plain PyTorch version, a CUDA tensor launches the kernel (or the
kernel wrapper raises on what it does not take); any other device raises.
Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, once the launch has returned without error, so a
run can show that its path went through the kernel; the attention wrappers
also count by shape, ``<wrapper>.by_shape[(hd, group)]``. A decode call
counts as one launch though it is two device launches (split and combine)
when the context is split; a CUDA graph's replay counts the launches its
capture recorded (``add_launches``). The kernels take head dims 32/64/96/128/192/256 unpadded
(``supports`` in each kernel module; decode takes groups of up to 16 query
heads per KV head, flash any group) and scale scores by the true head dim,
so the JAX package's ``_pad_head`` has no counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import ComplexityConfig
from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_paged_cuda,
    decode_attention_paged_plain, decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.image_complexity import (image_complexity_cuda,
                                                  image_stats_cuda,
                                                  image_stats_plain)


def _count_shape(fn, q: torch.Tensor, k: torch.Tensor) -> None:
    key = (int(q.shape[-1]), int(q.shape[-2]) // int(k.shape[-2]))
    fn.by_shape[key] = fn.by_shape.get(key, 0) + 1


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
    """End-to-end §3.1.1: (B,H,W) images -> complexity components + c_img,
    with the raw stats. On a CUDA tensor one launch of the statistics kernel
    computes both (counted in ``image_stats.launches``)."""
    if _route(imgs, "image_complexity"):
        out = image_complexity_cuda(imgs, cc)
        image_stats.launches += 1
        return out
    stats = image_stats_plain(imgs)
    return {**stats, **image_complexity_from_stats(
        stats, imgs.shape[1], imgs.shape[2], cc)}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Prefill self-attention: q (B, S, H, hd), k/v (B, S, K, hd), any S."""
    if _route(q, "flash_attention"):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        flash_attention.launches += 1
        _count_shape(flash_attention, q, k)
        return out
    return flash_attention_plain(q, k, v, causal=causal, window=window)


flash_attention.launches = 0
flash_attention.by_shape = {}


def decode_attention(q, k_cache, v_cache, pos_q, pos_cache, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Decode against a dense (B, T, K, hd) cache (strided views allowed)."""
    if _route(q, "decode_attention"):
        out = decode_attention_cuda(q, k_cache, v_cache, pos_q, pos_cache,
                                    window=window)
        decode_attention.launches += 1
        _count_shape(decode_attention, q, k_cache)
        return out
    return decode_attention_plain(q, k_cache, v_cache, pos_q, pos_cache,
                                  window=window)


decode_attention.launches = 0
decode_attention.by_shape = {}


def decode_attention_paged(q, k_pool, v_pool, pages, pos_q, pos_cache, *,
                           window: Optional[int] = None,
                           lens: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Decode through a page table: k/v_pool (P, page, K, hd) physical
    pages, pages (B, NP) int32 page-table rows, pos_cache (B, T); ``lens``
    (B,) int32, optional: the rows each slot attends (0: none, zeros out;
    ``kernels.decode_attention``'s docstring)."""
    if _route(q, "decode_attention_paged"):
        out = decode_attention_paged_cuda(q, k_pool, v_pool, pages, pos_q,
                                          pos_cache, window=window, lens=lens)
        decode_attention_paged.launches += 1
        _count_shape(decode_attention_paged, q, k_pool)
        return out
    return decode_attention_paged_plain(q, k_pool, v_pool, pages, pos_q,
                                        pos_cache, window=window, lens=lens)


decode_attention_paged.launches = 0
decode_attention_paged.by_shape = {}

#: every counted wrapper, by name (for resetting and reading the counts)
COUNTED = {"image_stats": image_stats,
           "flash_attention": flash_attention,
           "decode_attention": decode_attention,
           "decode_attention_paged": decode_attention_paged}


def reset_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
        if hasattr(fn, "by_shape"):
            fn.by_shape = {}


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in COUNTED.items()}


def launch_counts() -> Dict[str, tuple]:
    """Every counter, ``{wrapper: (launches, by_shape)}``, for
    :func:`take_launches_since`."""
    return {name: (fn.launches, dict(getattr(fn, "by_shape", {})))
            for name, fn in COUNTED.items()}


def take_launches_since(before: Dict[str, tuple]) -> Dict[str, tuple]:
    """The launches counted since ``before`` (:func:`launch_counts`), taken
    back out of the counters. A CUDA graph capture launches nothing: the
    wrappers it ran count through :func:`add_launches` once a replay."""
    taken = {}
    for name, fn in COUNTED.items():
        n0, shapes0 = before[name]
        shapes = getattr(fn, "by_shape", None)
        grown = {key: n - shapes0.get(key, 0)
                 for key, n in (shapes or {}).items()
                 if n != shapes0.get(key, 0)}
        if fn.launches != n0 or grown:
            taken[name] = (fn.launches - n0, grown)
        fn.launches = n0
        if shapes is not None:
            fn.by_shape = shapes0
    return taken


def add_launches(counts: Dict[str, tuple]) -> None:
    """Count launches made outside the wrappers (a graph replay): ``counts``
    as :func:`take_launches_since` returns them."""
    for name, (n, shapes) in counts.items():
        fn = COUNTED[name]
        fn.launches += n
        for key, m in shapes.items():
            fn.by_shape[key] = fn.by_shape.get(key, 0) + m


def launches_by_shape() -> Dict[str, Dict[tuple, int]]:
    """``{wrapper: {(hd, group): launches}}`` of the attention wrappers."""
    return {name: dict(fn.by_shape) for name, fn in COUNTED.items()
            if hasattr(fn, "by_shape")}
