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
import math
from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import HEAD_DIMS, NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: query rows and key rows of the kernel's tiles (``kBlockQ``/``kBlockK``)
BLOCK_Q = BLOCK_K = 64
#: query rows a block of ``flash_bf16_ws_kernel`` (``kWsBlockQ``: two
#: consumer warpgroups of 64 rows each over shared K/V tiles)
WS_BLOCK_Q = 128
#: the bf16 kernel's softmax runs in base 2: scores scaled by hd^-0.5 *
#: log2(e), masked scores and the running max start at -1e30 * log2(e)
LOG2E = math.log2(math.e)


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


def _tile_range(q0: torch.Tensor, s: int, causal: bool,
                window: Optional[int], block_q: int, block_k: int):
    """The key tiles [lo, hi] that the query tile starting at q0 reads
    (``tile_range`` in the CUDA source): tiles wholly above the diagonal
    (causal) or wholly before the window of every row are skipped."""
    n_k = -(-s // block_k)
    q_last = torch.clamp(q0 + block_q, max=s) - 1
    hi = q_last // block_k if causal else torch.full_like(q0, n_k - 1)
    lo = torch.zeros_like(q0)
    if window is not None:
        t = q0 - window - (block_k - 1)
        lo = torch.where(t >= 0, torch.div(t, block_k, rounding_mode="floor")
                         + 1, lo)
    return lo, hi


def flash_attention_tiled_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: Optional[int] = None,
                                block_q: int = BLOCK_Q,
                                block_k: int = BLOCK_K,
                                p_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """The bf16 CUDA kernel's tile loop in plain PyTorch (the tests use it;
    the main path does not). Same arguments and result as
    :func:`flash_attention_plain`.

    Each query tile of ``block_q`` rows walks the key tiles of
    :func:`_tile_range` in order. Scores are scaled by
    f32(hd^-0.5) * f32(log2 e); a masked score takes -1e30 * log2(e), the
    running max starts there, and keys past S are excluded outright (the
    ragged last tile is narrower). The online softmax runs in base 2:
    m' = max(m, max t), l' = l 2^(m - m') + sum 2^(t - m'), acc' =
    acc 2^(m - m') + P V with P = 2^(t - m') rounded to ``p_dtype`` (the
    kernel feeds bf16 P to the tensor cores; l sums the unrounded P). The
    output is acc / max(l, 1e-30) in q's dtype.

    The mirror computes 2^x exactly. ``flash_bf16_ws_kernel`` (bf16 hd 192
    and 256) takes ``ex2.approx.ftz`` instead: 2 ulp, and a weight below
    2^-126 of its row's largest flushes to 0. The other kernels use exact
    exp2f. The difference stays inside the 8e-3 that the card holds the
    kernel to its mirror."""
    b, s, h, kh, hd = _check_shapes(q, k, v, window)
    g = h // kh
    f32 = torch.float32
    scale = (torch.tensor(hd ** -0.5, dtype=f32)
             * torch.tensor(LOG2E, dtype=f32)).to(q.device)
    masked = torch.tensor(NEG_INF * LOG2E, dtype=f32, device=q.device)
    qf = q.float().transpose(1, 2)  # (B, H, S, hd)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    rows = torch.arange(s, device=q.device)
    lo, hi = _tile_range(rows - rows % block_q, s, causal, window, block_q,
                         block_k)
    m = masked.expand(b, h, s).clone()
    l = torch.zeros((b, h, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, s, hd), dtype=f32, device=q.device)
    for kt in range(-(-s // block_k)):
        live = (lo <= kt) & (kt <= hi)  # rows whose query tile reads tile kt
        if not bool(live.any()):
            continue
        k0, k1 = kt * block_k, min((kt + 1) * block_k, s)
        t = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        diff = rows[:, None] - torch.arange(k0, k1, device=q.device)[None]
        ok = torch.ones_like(diff, dtype=torch.bool)
        if causal:
            ok = ok & (diff >= 0)
        if window is not None:
            ok = ok & (diff < window)
        t = torch.where(ok, t, masked)
        m_new = torch.maximum(m, t.amax(dim=-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new[..., None])
        pv = p.to(p_dtype).float() @ vf[:, :, k0:k1]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l * corr + p.sum(dim=-1), l)
        acc = torch.where(live[:, None], acc * corr[..., None] + pv, acc)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = runtime.load("flash_attention")
    if not _argtypes_set:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        args = [i] + [p] * 4 + [i] * 7 + [i64] * 9 + [ctypes.c_float, i, p]
        lib.flash_attention_launch.argtypes = args
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_launch_as.argtypes = [i] + args
        lib.flash_attention_launch_as.restype = ctypes.c_int
        lib.flash_attention_blocks_per_sm.argtypes = [i, i, i]
        lib.flash_attention_blocks_per_sm.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_kernel_of.argtypes = [i, i]
        lib.flash_attention_kernel_of.restype = ctypes.c_int
        _argtypes_set = True
    return lib


_KERNELS = ("flash_f32_kernel", "flash_bf16_kernel",
            "flash_bf16_wgmma_kernel", "flash_bf16_ws_kernel")


def _kernel_id(kernel: Optional[str]) -> int:
    if kernel is None:
        return -1
    if kernel not in _KERNELS:
        raise ValueError(f"flash_attention: no kernel {kernel!r}")
    return _KERNELS.index(kernel)


def tiles(kernel: str) -> tuple:
    """(block_q, block_k) of ``kernel``'s tile loop: the arguments under
    which :func:`flash_attention_tiled_plain` mirrors it."""
    _kernel_id(kernel)
    return (WS_BLOCK_Q if kernel == "flash_bf16_ws_kernel" else BLOCK_Q,
            BLOCK_K)


def blocks_per_sm(dtype: torch.dtype, hd: int) -> int:
    """Resident blocks an SM of the kernel for (dtype, hd), from the CUDA
    occupancy calculator on the current device."""
    n = _lib().flash_attention_blocks_per_sm(_DTYPES[dtype], hd, -1)
    if n < 0:
        raise RuntimeError(f"flash_attention: no occupancy for {dtype}, "
                           f"hd {hd}")
    return n


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory a launch of the kernel for (dtype, hd) asks
    for, in bytes."""
    n = _lib().flash_attention_smem_bytes(_DTYPES[dtype], hd, -1)
    if n < 0:
        raise ValueError(f"flash_attention: no kernel for {dtype}, hd {hd}")
    return n


def kernel_of(dtype: torch.dtype, hd: int) -> str:
    """The kernel a (dtype, hd) call launches, as the library routes it:
    bf16 hd 64, 96 and 128 run ``flash_bf16_wgmma_kernel``, bf16 hd 192 and
    256 ``flash_bf16_ws_kernel`` (warp-specialised: two consumer
    warpgroups over TMA-fed K/V tiles), bf16 hd 32 ``flash_bf16_kernel``
    (mma.sync), f32 ``flash_f32_kernel``."""
    n = _lib().flash_attention_kernel_of(_DTYPES[dtype], hd)
    if n < 0:
        raise ValueError(f"flash_attention: no kernel for {dtype}, hd {hd}")
    return _KERNELS[n]


def supports(hd: int, group: int) -> bool:
    """True when the kernel takes head dim ``hd`` with ``group`` query heads
    per KV head (float32 and bfloat16; any group): the wrapper raises on
    anything else and never falls back to the plain version."""
    return hd in HEAD_DIMS and group >= 1


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Kernel launch. q, k and v may be strided views with unit stride on
    hd; the output is a new contiguous (B, S, H, hd) tensor."""
    return _launch(q, k, v, causal, window, None)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], kernel: Optional[str]) -> torch.Tensor:
    """:func:`flash_attention_cuda`'s body. ``kernel`` None takes the
    route; a name pins another kernel the head dim is built for
    (``flash_bf16_ws_kernel`` at bf16 hd 128, off the route: a timing
    record only), and the library refuses one it does not have."""
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
    if not supports(hd, h // kh):
        raise ValueError(f"flash attention kernel: head dim {hd} is not "
                         f"taken (head dims {HEAD_DIMS})")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q, k and v need unit stride on the head dim")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # 16-byte vector loads and TMA need every row start 16-byte aligned
    # (and so every stride a multiple of 16 bytes)
    per16 = 16 // q.element_size()
    vec = all(x.data_ptr() % 16 == 0
              and all(st % per16 == 0 for st in x.stride()[:3])
              for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, h, kh, hd, int(causal),
            0 if window is None else int(window),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(hd ** -0.5), int(vec), stream)
    lib = _lib()
    err = (lib.flash_attention_launch(*args) if kernel is None
           else lib.flash_attention_launch_as(_kernel_id(kernel), *args))
    runtime.check(err, "flash_attention")
    return out
