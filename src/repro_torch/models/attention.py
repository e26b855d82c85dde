"""Attention implementations in plain PyTorch: dense oracle, chunked
online-softmax ("flash"), exact block-local sliding window, and cache
decode. All GQA-aware. Counterpart of ``repro/models/attention.py``, whose
XLA paths these port (``flash_attention_xla`` -> :func:`flash_attention_torch`,
``decode_attention_xla`` -> :func:`decode_attention_torch`, and so on).

The decode dispatchers choose between the CUDA kernels of
``repro_torch.kernels`` and these plain versions (``impl``: ``auto`` = the
kernel for CUDA tensors and the plain version for CPU tensors, ``torch`` =
plain, ``cuda`` = kernel, raising on CPU tensors). The prefill dispatcher
takes ``cuda`` (the flash-attention kernel) and ``torch`` (its plain
version), the port's counterpart of the JAX ``pallas``; both refuse
``Sq != Skv``. Its ``auto`` picks among ``dense``, ``local`` and ``flash``
exactly as the JAX dispatcher does, never the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import (NEG_INF,
                                                  decode_attention_paged_plain,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import flash_attention_plain

decode_attention_torch = decode_attention_plain
decode_attention_paged_torch = decode_attention_paged_plain


def _split_gqa(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, K, G, hd)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, d)


def _merge_gqa(o: torch.Tensor) -> torch.Tensor:
    b, s, k, g, d = o.shape
    return o.reshape(b, s, k * g, d)


def _largest_divisor_leq(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (for ragged VLM sequences)."""
    target = min(target, n)
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return 1


def _mask_ok(pos_q: torch.Tensor, pos_kv: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """Boolean mask (B, Sq, Skv) from absolute positions; kv positions < 0
    are empty cache slots and always masked."""
    if pos_q.dim() == 1:
        pos_q = pos_q[None]
    if pos_kv.dim() == 1:
        pos_kv = pos_kv[None]
    d = pos_q[:, :, None] - pos_kv[:, None, :]
    ok = (pos_kv[:, None, :] >= 0).expand_as(d)
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    return ok


def _mask_bias(pos_q, pos_kv, causal, window) -> torch.Tensor:
    ok = _mask_ok(pos_q, pos_kv, causal, window)
    return torch.where(ok, 0.0, NEG_INF).float()


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos_q: torch.Tensor, pos_kv: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """Reference attention, fully materialized f32 scores. GQA via K
    grouping. q: (B, Sq, H, hd); k/v: (B, Skv, K, hd)."""
    num_kv = k.shape[2]
    qg = _split_gqa(q, num_kv)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    bias = _mask_bias(pos_q, pos_kv, causal, window)
    s = s + bias[:, None, None, :, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return _merge_gqa(o).to(q.dtype)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos_q: torch.Tensor, pos_kv: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          q_chunk: int = 2048, kv_chunk: int = 2048
                          ) -> torch.Tensor:
    """Online-softmax attention, O(q_chunk*kv_chunk) score memory; causal
    chunk skipping is static, as in the JAX package's XLA path."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    num_kv = k.shape[2]
    g = h // num_kv
    scale = d ** -0.5
    q_chunk = _largest_divisor_leq(sq, q_chunk)
    kv_chunk = _largest_divisor_leq(skv, kv_chunk)
    n_q, n_kv = sq // q_chunk, skv // kv_chunk
    if pos_q.dim() == 1:
        pos_q = pos_q[None].expand(b, sq)
    if pos_kv.dim() == 1:
        pos_kv = pos_kv[None].expand(b, skv)
    qg = _split_gqa(q, num_kv)
    outs = []
    for qi in range(n_q):
        q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk]
        pq_blk = pos_q[:, qi * q_chunk:(qi + 1) * q_chunk]
        hi = (qi + 1) if causal else n_kv
        lo = 0
        if window is not None and causal and sq == skv and q_chunk == kv_chunk:
            lo = max(0, qi - (window + q_chunk - 1) // kv_chunk)
        acc = torch.zeros((b, num_kv, g, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, num_kv, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, num_kv, g, q_chunk), dtype=torch.float32,
                        device=q.device)
        for ki in range(lo, hi):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            k_blk, v_blk, pkv_blk = k[:, sl], v[:, sl], pos_kv[:, sl]
            # scores accumulate in f32 over the model-dtype operands;
            # probabilities travel to the PV product in the model dtype
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.to(k.dtype).float(),
                             k_blk.float()) * scale
            s = s + _mask_bias(pq_blk, pkv_blk, causal, window)[:, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v_blk.float())
            l = l * corr + p.sum(dim=-1)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4))
    return _merge_gqa(torch.cat(outs, dim=1)).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos: torch.Tensor, *, window: int) -> torch.Tensor:
    """Exact causal sliding-window self-attention via block-local
    computation: blocks of ``window`` tokens attend to (self, previous)
    block only."""
    b, s, h, d = q.shape
    num_kv = k.shape[2]
    w = min(window, s)
    pad = (-s) % w
    if pos.dim() == 1:
        pos = pos[None].expand(b, s)
    if pad:
        zpad = lambda x: torch.cat(
            [x, x.new_zeros((b, pad) + tuple(x.shape[2:]))], dim=1)
        q, k, v = zpad(q), zpad(k), zpad(v)
        pos = torch.cat([pos, pos.new_full((b, pad), -1)], dim=1)
    sp = q.shape[1]
    nb = sp // w
    qb = _split_gqa(q, num_kv).reshape(b, nb, w, num_kv, h // num_kv, d)
    kb = k.reshape(b, nb, w, num_kv, d)
    vb = v.reshape(b, nb, w, num_kv, d)
    pb = pos.reshape(b, nb, w)

    def prev(x, fill):
        first = torch.full_like(x[:, :1], fill)
        return torch.cat([first, x[:, :-1]], dim=1)

    k2 = torch.cat([prev(kb, 0.0), kb], dim=2)
    v2 = torch.cat([prev(vb, 0.0), vb], dim=2)
    p2 = torch.cat([prev(pb, -1), pb], dim=2)
    scale = d ** -0.5
    sco = torch.einsum("bnqkgd,bnskd->bnkgqs", qb.float(), k2.float()) * scale
    diff = pb[:, :, :, None] - p2[:, :, None, :]
    ok = (p2[:, :, None, :] >= 0) & (diff >= 0) & (diff < w)
    sco = sco + torch.where(ok, 0.0, NEG_INF)[:, :, None, None]
    prob = torch.softmax(sco, dim=-1)
    o = torch.einsum("bnkgqs,bnskd->bnqkgd", prob, v2.float())
    return o.reshape(b, sp, h, d)[:, :s].to(q.dtype)


def _kernel_or_raise(q: torch.Tensor, impl: str,
                     what: str = "decode") -> None:
    if impl == "cuda" and q.device.type != "cuda":
        raise ValueError(f"{what} impl 'cuda' needs CUDA tensors, got "
                         f"{q.device}")


def decode_attention_paged(q, k_pool, v_pool, pages, pos_q, pos_cache, *,
                           window: Optional[int] = None, impl: str = "auto",
                           lens: Optional[torch.Tensor] = None):
    """Paged decode dispatcher. impl: auto | torch | cuda. ``lens``: the
    optional (B,) extents (``kernels.ops.decode_attention_paged``)."""
    if impl in ("auto", "cuda"):
        from repro_torch.kernels import ops as kops

        _kernel_or_raise(q, impl)
        return kops.decode_attention_paged(q, k_pool, v_pool, pages, pos_q,
                                           pos_cache, window=window,
                                           lens=lens)
    if impl == "torch":
        return decode_attention_paged_torch(q, k_pool, v_pool, pages, pos_q,
                                            pos_cache, window=window,
                                            lens=lens)
    raise ValueError(impl)


def decode_attention(q, k_cache, v_cache, pos_q, pos_cache, *,
                     window: Optional[int] = None, impl: str = "auto"):
    """Decode dispatcher. impl: auto | torch | cuda."""
    if impl in ("auto", "cuda"):
        from repro_torch.kernels import ops as kops

        _kernel_or_raise(q, impl)
        return kops.decode_attention(q, k_cache, v_cache, pos_q, pos_cache,
                                     window=window)
    if impl == "torch":
        return decode_attention_torch(q, k_cache, v_cache, pos_q, pos_cache,
                                      window=window)
    raise ValueError(impl)


def attention(q, k, v, pos_q, pos_kv, *, causal=True, window=None,
              impl="auto", q_chunk=2048, kv_chunk=2048):
    """Prefill dispatcher. impl: auto | dense | flash | local | cuda | torch.

    ``cuda`` and ``torch`` are the self-attention kernel and its plain
    version: position == index, so they ignore ``pos_q``/``pos_kv`` and
    raise on a K/V of other length than q (a cached context)."""
    if impl == "torch":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        _kernel_or_raise(q, impl, "prefill")
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "auto":
        sq, skv = q.shape[1], k.shape[1]
        if window is not None and causal and sq == skv and sq > window:
            impl = "local"
        elif sq * skv <= 4096 * 4096 // 4:
            impl = "dense"
        else:
            impl = "flash"
    if impl == "dense":
        return dense_attention(q, k, v, pos_q, pos_kv, causal=causal,
                               window=window)
    if impl == "local":
        return local_attention(q, k, v, pos_q, window=window)
    if impl == "flash":
        return flash_attention_torch(q, k, v, pos_q, pos_kv, causal=causal,
                                     window=window, q_chunk=q_chunk,
                                     kv_chunk=kv_chunk)
    raise ValueError(impl)
