"""RG-LRU recurrent block (Griffin / RecurrentGemma [arXiv:2402.19427]).
Counterpart of ``repro/models/rglru.py``.

Recurrence: a_t = exp(-c * softplus(Λ) * r_t),  r_t, i_t input-dependent gates,
h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t).

Prefill runs the linear recurrence as a log-depth scan on whole tensors
(``_lru_scan``, the counterpart of ``jax.lax.associative_scan``): about
log2(S) passes of a few elementwise launches each, where a loop over time
would launch per token. Decode is an O(1) state update.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.spec import ParamSpec

_C = 8.0  # Griffin's fixed gate sharpness constant


def rglru_specs(cfg: ModelConfig, prefix_axes=()) -> dict:
    ps = tuple(n for n, _ in prefix_axes)
    pa = tuple(a for _, a in prefix_axes)
    d = cfg.d_model
    w = cfg.lru_width or cfg.d_model
    cw = cfg.ssm_conv or 4
    return {
        "ln": ParamSpec(ps + (d,), pa + ("embed",), "zeros"),
        "wg": ParamSpec(ps + (d, w), pa + ("embed", "heads"), "scaled"),  # gelu branch
        "wx": ParamSpec(ps + (d, w), pa + ("embed", "heads"), "scaled"),  # recurrent branch
        "conv_w": ParamSpec(ps + (cw, w), pa + (None, "heads"), "scaled"),
        "conv_b": ParamSpec(ps + (w,), pa + ("heads",), "zeros"),
        "w_r": ParamSpec(ps + (w, w), pa + ("heads_in", "heads"), "scaled"),
        "b_r": ParamSpec(ps + (w,), pa + ("heads",), "zeros"),
        "w_i": ParamSpec(ps + (w, w), pa + ("heads_in", "heads"), "scaled"),
        "b_i": ParamSpec(ps + (w,), pa + ("heads",), "zeros"),
        "lam": ParamSpec(ps + (w,), pa + ("heads",), "ones"),  # Λ
        "wo": ParamSpec(ps + (w, d), pa + ("heads", "embed"), "scaled"),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(params: dict, xr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t and the scaled input. xr: (B,S,W) float32."""
    r = torch.sigmoid(torch.matmul(xr, params["w_r"].float())
                      + params["b_r"].float())
    i = torch.sigmoid(torch.matmul(xr, params["w_i"].float())
                      + params["b_i"].float())
    log_a = -_C * softplus(params["lam"].float()) * r  # (B,S,W) <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) * (i * xr)
    return a, gated_x


def _lru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t over axis 1, as a log-depth (Hillis-Steele)
    scan: pass d combines each step with the one 2^d before it,
    (A, B)_t <- (A_{t-o} A_t, A_t B_{t-o} + B_t) with o = 2^d.

    a, b: (B,S,W) float32. Returns (h (B,S,W), h_last (B,W))."""
    if h0 is not None:
        # fold the incoming state into the first step
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b, b[:, -1]


def rglru_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  conv_state: Optional[torch.Tensor] = None,
                  h_state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence Griffin recurrent block. x: (B,S,D)."""
    from repro_torch.models.ssm import _causal_conv

    res = x
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    g = F.gelu(torch.matmul(xn, params["wg"]), approximate="tanh")
    xr = torch.matmul(xn, params["wx"])
    xr, new_conv = _causal_conv(xr, params["conv_w"], params["conv_b"],
                                conv_state)
    a, gx = _gates(params, xr.float())
    h, h_last = _lru_scan(a, gx, h_state)
    y = (g.float() * h).to(x.dtype)
    out = torch.matmul(y, params["wo"])
    return res + out, {"conv": new_conv, "h": h_last}


def rglru_decode(params: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B,1,D); cache {"conv": (B,cw-1,W), "h": (B,W)}."""
    from repro_torch.models.ssm import _causal_conv

    res = x
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    g = F.gelu(torch.matmul(xn, params["wg"]), approximate="tanh")
    xr = torch.matmul(xn, params["wx"])
    xr, new_conv = _causal_conv(xr, params["conv_w"], params["conv_b"],
                                cache["conv"])
    a, gx = _gates(params, xr.float())
    h = a[:, 0] * cache["h"] + gx[:, 0]  # (B,W)
    y = (g[:, 0].float() * h).to(x.dtype)[:, None, :]
    out = torch.matmul(y, params["wo"])
    return res + out, {"conv": new_conv, "h": h}


def rglru_cache_shape(cfg: ModelConfig, batch: int) -> dict:
    w = cfg.lru_width or cfg.d_model
    cw = cfg.ssm_conv or 4
    return {"conv": (batch, cw - 1, w), "h": (batch, w)}
