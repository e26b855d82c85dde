"""Prefill self-attention: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``:
blocked online-softmax self-attention with GQA (query head h reads KV head
``h // (H // K)``), causal or not, an optional sliding window
(``row - col < window``), position == index. The plain version defines the
semantics: f32 scores scaled by the true ``hd ** -0.5``, masked scores at
the finite -1e30, f32 probabilities into the PV product, output
``acc / max(l, 1e-30)`` in q's dtype.

Unlike the Pallas kernel, which asserts ``S % 128 == 0`` once S passes 128
(``flash_attention.py:96-98``), both versions take any S: the vlm prompts
of the serving path are 256 patches plus a power-of-two text bucket. Both
take only the self-attention layout (``Sq == Skv``); a K/V of cached rows
with absolute positions (chunk mode) needs a position-aware path.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import HEAD_DIMS, NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, S, H, hd) and k/v (B, S, K, hd) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[1] != s:
        raise ValueError(f"self-attention only: Sq {s} != Skv {k.shape[1]} "
                         f"(chunk mode needs a position-aware path)")
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    kh = k.shape[2]
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} KV heads")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    return b, s, h, kh, hd


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, K, hd) -> (B, S, H, hd) in q's dtype."""
    b, s, h, kh, hd = _check_shapes(q, k, v, window)
    qg = q.reshape(b, s, kh, h // kh, hd)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * hd ** -0.5
    idx = torch.arange(s, device=q.device)
    diff = idx[:, None] - idx[None, :]  # row - col
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (diff >= 0)
    if window is not None:
        ok = ok & (diff < window)
    sc = torch.where(ok, sc, NEG_INF)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = runtime.load("flash_attention")
    if not _argtypes_set:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.flash_attention_launch.argtypes = (
            [i] + [p] * 4 + [i] * 7 + [i64] * 9 + [ctypes.c_float, i, p])
        lib.flash_attention_launch.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Kernel launch. q, k and v may be strided views with unit stride on
    hd; the output is a new contiguous (B, S, H, hd) tensor."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device "
                             f"({q.device}), got {x.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, kh, hd = _check_shapes(q, k, v, window)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q, k and v need unit stride on the head dim")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # 16-byte vector loads need every row start 16-byte aligned
    per16 = 16 // q.element_size()
    vec = all(x.data_ptr() % 16 == 0
              and all(st % per16 == 0 for st in x.stride()[:3])
              for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, h, kh, hd, int(causal),
        0 if window is None else int(window),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(hd ** -0.5), int(vec), stream)
    runtime.check(err, "flash_attention")
    return out
