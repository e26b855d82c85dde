"""Plain reference of the served decoders, in float32, for the check of
``correct``.

It imports nothing of the serving program. It reads the benchmark's weight
tree (the layout of ``moabench/arch.py``) and the raw inputs of each
request (the image's pixels and the prompt's token ids) and works out the
rest itself: the vision stub's patch embeddings, every layer, the logits.

The architecture is the one the program serves: a pre-norm decoder with
RMSNorm scales of (1 + w), rotary embeddings on the first and second half
of each head (base ``rope_theta``, positions 0.. over patches then text),
grouped-query attention with a causal mask and 1/sqrt(head_dim) scaling,
a SwiGLU MLP whose fused input projection holds the SiLU branch first and
the linear branch second, and a final RMSNorm before the unembedding (the
embedding table when tied). The vision tower is the program's stub: the
image's pixels over 255, tiled row-major into (patches, frontend_dim),
then one linear projection, placed before the text.

Each model runs layer by layer over every sequence it is given, with that
layer's weights cast to float32 once, so that a full-width model fits
beside nothing else on the card. Matrix products run with TF32 off.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, hd) at positions 0..S-1."""
    s, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def stub_patches(image: np.ndarray, patches: int, dim: int) -> np.ndarray:
    """The vision stub's input: pixels / 255, tiled to (patches, dim)."""
    flat = np.asarray(image, np.float32).reshape(-1) / np.float32(255.0)
    need = patches * dim
    rep = max(1, -(-need // max(flat.size, 1)))
    return np.tile(flat, rep)[:need].reshape(patches, dim)


def _layer(x: torch.Tensor, w: Dict[str, torch.Tensor], a) -> torch.Tensor:
    s = x.shape[0]
    h, k, hd = a.heads, a.kv_heads, a.head_dim
    hh = _rms(x, w["ln1"], a.eps)
    q = _rope((hh @ w["wq"]).view(s, h, hd), a.rope_theta)
    kk = _rope((hh @ w["wk"]).view(s, k, hd), a.rope_theta)
    v = (hh @ w["wv"]).view(s, k, hd)
    g = h // k
    q = q.view(s, k, g, hd).permute(1, 2, 0, 3)            # (K, G, S, hd)
    kk, v = kk.permute(1, 0, 2)[:, None], v.permute(1, 0, 2)[:, None]
    sc = (q @ kk.transpose(-1, -2)) / math.sqrt(hd)         # (K, G, S, S)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
    o = (p @ v).permute(2, 0, 1, 3).reshape(s, h * hd)
    x = x + o @ w["wo"]
    h2 = _rms(x, w["ln2"], a.eps)
    up, gate = (h2 @ w["wi"]).chunk(2, dim=-1)
    return x + (torch.nn.functional.silu(up) * gate) @ w["mlp_wo"]


def logits_at(a, weights: Dict, seqs: Sequence[Dict],
              device) -> List[torch.Tensor]:
    """float32 logits of each sequence at its requested rows.

    ``seqs``: dicts with ``ids`` (int array), optional ``image`` (pixels)
    and ``rows`` (row indices into patches + ids whose logits are wanted).
    Returns one (len(rows), vocab) tensor per sequence."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits_at(a, weights, seqs, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _logits_at(a, weights, seqs, device):
    f32 = lambda t: t.to(device=device, dtype=torch.float32)  # noqa: E731
    embed = weights["embed"]
    xs = []
    for sq in seqs:
        ids = torch.as_tensor(np.asarray(sq["ids"], np.int64), device=device)
        x = f32(embed[ids.to(embed.device)])
        if sq.get("image") is not None and a.patches:
            px = torch.as_tensor(stub_patches(sq["image"], a.patches,
                                              a.frontend_dim), device=device)
            x = torch.cat([px @ f32(weights["proj_in"]), x], dim=0)
        xs.append(x)
    blocks = weights["blocks"]
    for layer in range(a.layers):
        w = {n: f32(blocks[n][layer])
             for n in ("ln1", "wq", "wk", "wv", "wo", "ln2")}
        w["wi"] = f32(blocks["mlp"]["wi"][layer])
        w["mlp_wo"] = f32(blocks["mlp"]["wo"][layer])
        xs = [_layer(x, w, a) for x in xs]
        del w
    table = weights["embed"] if a.tied else weights["unembed"]
    table = f32(table[:a.vocab])
    ln_f = f32(weights["ln_f"])
    out = []
    for x, sq in zip(xs, seqs):
        rows = torch.as_tensor(np.asarray(sq["rows"], np.int64),
                               device=device)
        out.append(_rms(x[rows], ln_f, a.eps) @ table.t())
    return out


def served_gaps(a, weights: Dict, served: Sequence[Dict], device,
                quantize: Optional[str] = None) -> List[np.ndarray]:
    """For each served request (``ids``, ``image``, ``tokens``: what the
    program streamed), the gap of every served token below the
    reference's best logit at its position: max(logits) - logits[token].

    With ``quantize`` (the control), the weights go through that lower
    precision first and the gaps are those of the token the lower
    precision puts first, read on the float32 reference's logits."""
    seqs = []
    for r in served:
        toks = np.asarray(r["tokens"], np.int64)
        prefix = a.patches if r.get("image") is not None else 0
        first = prefix + len(r["ids"]) - 1
        seqs.append({"ids": np.concatenate([np.asarray(r["ids"], np.int64),
                                            toks[:-1]]),
                     "image": r.get("image"),
                     "rows": np.arange(first, first + len(toks))})
    ref = logits_at(a, weights, seqs, device)
    if quantize is None:
        picks = [torch.as_tensor(np.asarray(r["tokens"], np.int64),
                                 device=device) for r in served]
    else:
        low = logits_at(a, quantized(weights, quantize), seqs, device)
        picks = [lg.argmax(-1) for lg in low]
    return [(lg.max(-1).values - lg.gather(1, p[:, None])[:, 0]).cpu().numpy()
            for lg, p in zip(ref, picks)]


def quantized(weights: Dict, kind: str) -> Dict:
    """The weight tree rounded through a lower precision: ``fp8`` is
    float8 e4m3 with one scale per output column of each matrix (per row
    of an embedding table), the step below bfloat16."""
    if kind != "fp8":
        raise ValueError(f"unknown control precision {kind!r}")

    def q(name: str, t: torch.Tensor) -> torch.Tensor:
        if t.dim() < 2:
            return t
        x = t.float()
        axis = -1 if name in ("embed", "unembed") else -2
        scale = torch.clamp(x.abs().amax(dim=axis, keepdim=True),
                            min=1e-12) / 448.0
        return ((x / scale).to(torch.float8_e4m3fn).float() * scale).to(
            t.dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else q(k, v)
                for k, v in tree.items()}
    return walk(weights)
