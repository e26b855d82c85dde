"""One-token decode attention: the CUDA kernel ``csrc/decode_attention.cu``
(dense and paged cache) and its plain PyTorch versions.

Replaces ``repro/kernels/decode_attention.py``: ``decode_attention_pallas``
(dense, possibly ring-buffer cache) and ``decode_attention_pallas_paged``
(page-table pool). The plain versions port the XLA paths
``decode_attention_xla`` / ``decode_attention_paged_xla`` of
``repro/models/attention.py`` and define the semantics, masked rows
included: a row whose attended entries are all masked returns the mean of
its value rows (the fill is the finite -1e30).

Decode attention is bound by the bytes of the KV context it reads; the
kernel reads each row once, staged through shared memory, for all query
heads of a KV group (see the note in the CUDA source).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import runtime

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8  # query heads per KV head the kernel holds


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos_q: torch.Tensor,
                           pos_cache: torch.Tensor, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k/v_cache: (B, T, K, hd); pos_q: (B,) absolute
    position of the query; pos_cache: (B, T) absolute position per entry
    (-1 = empty). Returns (B, 1, H, hd) in q's dtype.

    Scores and the probability-weighted sum accumulate in f32 over the
    cache's own values (the products of bf16 values are exact in f32)."""
    b, _, h, d = q.shape
    num_kv = k_cache.shape[2]
    qg = q[:, 0].reshape(b, num_kv, h // num_kv, d)
    scale = d ** -0.5
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(k_cache.dtype).float(),
                     k_cache.float()) * scale
    dd = pos_q[:, None] - pos_cache
    ok = (pos_cache >= 0) & (dd >= 0)
    if window is not None:
        ok = ok & (dd < window)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    w = (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype).float()
    o = torch.einsum("bkgt,btkd->bkgd", w, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_paged_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, pages: torch.Tensor,
                                 pos_q: torch.Tensor, pos_cache: torch.Tensor,
                                 *, window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Decode through a page table. k/v_pool: (P, page, K, hd) physical
    pages (page 0 is the engine's null page); pages: (B, NP) int page table
    covering the attended context; pos_cache: (B, T <= NP*page) absolute
    position per logical row. Gathers each row's context and defers to the
    dense version sliced to T, so paged and dense decode see the same
    operands."""
    b, np_ = pages.shape
    page = k_pool.shape[1]
    t = pos_cache.shape[1]
    idx = pages.long()
    k_ctx = k_pool[idx].reshape(b, np_ * page, *k_pool.shape[2:])[:, :t]
    v_ctx = v_pool[idx].reshape(b, np_ * page, *v_pool.shape[2:])[:, :t]
    return decode_attention_plain(q, k_ctx, v_ctx, pos_q, pos_cache,
                                  window=window)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_argtypes_set = False
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = runtime.load("decode_attention")
    if not _argtypes_set:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.decode_attention_launch.argtypes = (
            [i] + [p] * 7 + [i] * 7 + [i64] * 8 + [ctypes.c_float, p])
        lib.decode_attention_launch.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def _check_int(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride on its last dim")


def _check_common(q, k, v, pos_q, pos_cache):
    for name, x in (("q", q), ("k", k), ("v", v), ("pos_q", pos_q),
                    ("pos_cache", pos_cache)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device "
                             f"({q.device}), got {x.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (B, 1, H, hd), got "
                         f"{tuple(q.shape)}")
    b, _, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    for name, x in (("k", k), ("v", v)):
        if x.dim() != 4 or x.shape[3] != hd or x.stride(3) != 1:
            raise ValueError(f"{name} must be (., ., K, {hd}) with unit "
                             f"stride on its last dim, got {tuple(x.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    kh = k.shape[2]
    if h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"{h} query heads over {kh} KV heads: the kernel "
                         f"takes groups of at most {MAX_GROUP}")
    _check_int("pos_q", pos_q, 1)
    _check_int("pos_cache", pos_cache, 2)
    if pos_q.shape[0] != b or pos_cache.shape[0] != b:
        raise ValueError("pos_q / pos_cache batch differs from q's")
    if pos_cache.shape[1] < 1:
        raise ValueError("empty context")
    return b, h, kh, hd


def _launch(q, k, v, pos_q, pos_cache, pages, window, b, h, kh, hd, page):
    out = torch.empty_like(q)
    t = pos_cache.shape[1]
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    pg_ptr = pages.data_ptr() if pages is not None else None
    pg_sb = pages.stride(0) if pages is not None else 0
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos_q.data_ptr(), pos_cache.data_ptr(), pg_ptr, out.data_ptr(),
        b, h, kh, hd, t, page, 0 if window is None else int(window),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        pos_cache.stride(0), pg_sb, float(hd ** -0.5), stream)
    runtime.check(err, "decode_attention")
    return out


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos_q: torch.Tensor,
                          pos_cache: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Kernel launch for the dense cache. k/v_cache may be strided views
    (a context-bucket slice or a layer of the stacked cache)."""
    b, h, kh, hd = _check_common(q, k_cache, v_cache, pos_q, pos_cache)
    if k_cache.shape[0] != b or k_cache.shape[1] < pos_cache.shape[1]:
        raise ValueError(f"dense cache {tuple(k_cache.shape)} does not cover "
                         f"pos_cache {tuple(pos_cache.shape)}")
    return _launch(q, k_cache, v_cache, pos_q, pos_cache, None, window,
                   b, h, kh, hd, 1)


def decode_attention_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, pages: torch.Tensor,
                                pos_q: torch.Tensor, pos_cache: torch.Tensor,
                                *, window: Optional[int] = None
                                ) -> torch.Tensor:
    """Kernel launch for the paged pool; rows are found through ``pages``."""
    b, h, kh, hd = _check_common(q, k_pool, v_pool, pos_q, pos_cache)
    if pages.device != q.device:
        raise ValueError(f"pages must lie on {q.device}, got {pages.device}")
    _check_int("pages", pages, 2)
    page = k_pool.shape[1]
    if pages.shape[0] != b or pages.shape[1] * page < pos_cache.shape[1]:
        raise ValueError(f"page table {tuple(pages.shape)} x page {page} does "
                         f"not cover pos_cache {tuple(pos_cache.shape)}")
    return _launch(q, k_pool, v_pool, pos_q, pos_cache, pages, window,
                   b, h, kh, hd, page)
