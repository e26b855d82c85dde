"""Shared building blocks: norms, RoPE, activations, embeddings, vocab
padding. Counterpart of ``repro/models/layers.py``; the f32 upcasts and the
casts back sit where the JAX package puts them."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple so the unembedding shards evenly over TP."""
    return ((v + multiple - 1) // multiple) * multiple


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.float())).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with weight and bias (Whisper), computed in float32."""
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


def activation_fn(name: str, x: torch.Tensor,
                  gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated and ungated MLP activations. ``gate`` is the linear branch."""
    if name == "swiglu":
        return F.silu(x) * gate
    if name == "geglu":
        return F.gelu(x, approximate="tanh") * gate
    if name == "squared_relu":
        r = F.relu(x)
        return r * r
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """cos/sin tables, each positions.shape + (head_dim // 2,), float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int; table: (V_pad, D).

    Same rule as ``jnp.take`` in the JAX package: a negative id counts from
    the end, and an id outside [-V_pad, V_pad) embeds as NaN."""
    v = table.shape[0]
    t = tokens.long()
    ok = (t >= -v) & (t < v)
    rows = torch.where(t < 0, t + v, t).clamp(0, v - 1)
    out = torch.nn.functional.embedding(rows, table)
    return torch.where(ok[..., None], out, float("nan"))


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits over the rows of ``table``. x: (B, S, D); table: (V, D).

    The JAX package projects onto the padded table and fills the pad tail
    with -1e30; callers here pass the table already sliced to the true
    vocab, which gives the same logits on every real token id.
    """
    return torch.matmul(x, table.t())
