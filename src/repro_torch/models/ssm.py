"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060]. Counterpart
of ``repro/models/ssm.py``.

Chunked semi-separable computation: a quadratic attention-like term within
chunks + a linear recurrence across chunks (a loop over the S / chunk
chunks, ``jax.lax.scan`` in the JAX package). Decode is an O(1) state
update. Plain PyTorch: the JAX package has no kernel here either.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.rglru import softplus
from repro_torch.models.spec import ParamSpec


def ssd_specs(cfg: ModelConfig, prefix_axes=()) -> dict:
    ps = tuple(n for n, _ in prefix_axes)
    pa = tuple(a for _, a in prefix_axes)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv
    conv_ch = di + 2 * n  # conv runs over [x, B, C] channels
    return {
        "ln": ParamSpec(ps + (d,), pa + ("embed",), "zeros"),
        "wz": ParamSpec(ps + (d, di), pa + ("embed", "heads"), "scaled"),
        "wx": ParamSpec(ps + (d, di), pa + ("embed", "heads"), "scaled"),
        "wb": ParamSpec(ps + (d, n), pa + ("embed", None), "scaled"),
        "wc": ParamSpec(ps + (d, n), pa + ("embed", None), "scaled"),
        "wdt": ParamSpec(ps + (d, h), pa + ("embed", "heads"), "scaled"),
        "conv_w": ParamSpec(ps + (w, conv_ch), pa + (None, "heads"), "scaled"),
        "conv_b": ParamSpec(ps + (conv_ch,), pa + ("heads",), "zeros"),
        "a_log": ParamSpec(ps + (h,), pa + ("heads",), "ones"),
        "d_skip": ParamSpec(ps + (h,), pa + ("heads",), "ones"),
        "dt_bias": ParamSpec(ps + (h,), pa + ("heads",), "zeros"),
        "gn": ParamSpec(ps + (di,), pa + ("heads",), "zeros"),  # gated RMSNorm
        "wo": ParamSpec(ps + (di, d), pa + ("heads", "embed"), "scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,S,C); w: (W,C); state: (B,W-1,C) history.

    Returns (y (B,S,C), new_state (B,W-1,C))."""
    width = w.shape[0]
    s = x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+W-1, C)
    y = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    y = y + b[None, None, :]
    new_state = xp[:, xp.shape[1] - (width - 1):, :]
    return F.silu(y), new_state


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (B,S,H,P) inputs per head; dt: (B,S,H) softplus'd step; a: (H,)
    negative decay rate; bmat/cmat: (B,S,N). Returns (y (B,S,H,P),
    h_final (B,H,P,N))."""
    b_, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    s_orig = s
    if pad:  # ragged tail: dt=0 padding is exact (no state contribution)
        zpad = lambda t: torch.cat(
            [t, t.new_zeros((b_, pad) + tuple(t.shape[2:]))], dim=1)
        xh, dt, bmat, cmat = zpad(xh), zpad(dt), zpad(bmat), zpad(cmat)
        s = s + pad
    nc = s // q
    f32 = torch.float32

    xc = xh.reshape(b_, nc, q, h, p).to(f32)
    dtc = dt.reshape(b_, nc, q, h).to(f32)
    bc = bmat.reshape(b_, nc, q, n).to(f32)
    cc = cmat.reshape(b_, nc, q, n).to(f32)

    da = dtc * a[None, None, None, :]  # (B,nc,Q,H) negative
    cum = torch.cumsum(da, dim=2)  # within-chunk cumulative decay exponent
    total = cum[:, :, -1:, :]  # (B,nc,1,H)

    # ---- intra-chunk (quadratic within chunk) ----
    # L[i,j] = exp(cum_i - cum_j) for i >= j, masked inside the exp (the
    # upper triangle's positive exponents would overflow)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    li = torch.tril(torch.ones((q, q), dtype=torch.bool,
                               device=xh.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(li, diff, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)  # (B,nc,Q,Q)
    w_ij = cb[..., None] * decay * dtc[:, :, None, :, :]  # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ij, xc)

    # ---- chunk states ----
    # state_c = sum_j exp(total - cum_j) * dt_j * B_j (x) x_j
    sdecay = torch.exp(total - cum)  # (B,nc,Q,H)
    sx = xc * (dtc * sdecay)[..., None]  # (B,nc,Q,H,P)
    states = torch.einsum("bcqn,bcqhp->bchpn", bc, sx)  # (B,nc,H,P,N)

    # ---- inter-chunk recurrence: the state ENTERING each chunk ----
    chunk_decay = torch.exp(total[:, :, 0, :])  # (B,nc,H)
    hprev = (h0.to(f32) if h0 is not None
             else torch.zeros((b_, h, p, n), dtype=f32, device=xh.device))
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,P,N)

    # ---- inter-chunk output: y_inter[i] = exp(cum_i) * C_i . h_in ----
    y_inter = (torch.einsum("bcqn,bchpn->bcqhp", cc, h_in)
               * torch.exp(cum)[..., None])

    y = (y_intra + y_inter).reshape(b_, s, h, p)
    if pad:
        y = y[:, :s_orig]
    return y, hprev


def _project(params: dict, xn: torch.Tensor):
    """The five input projections of the block."""
    return (torch.matmul(xn, params["wz"]), torch.matmul(xn, params["wx"]),
            torch.matmul(xn, params["wb"]), torch.matmul(xn, params["wc"]),
            torch.matmul(xn, params["wdt"]))


def ssd_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                conv_state: Optional[torch.Tensor] = None,
                h_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence (prefill) Mamba-2 block. x: (B,S,D).

    Returns (y (B,S,D), cache {"conv": (B,W-1,C), "h": (B,H,P,N)})."""
    b, s, _ = x.shape
    h_heads, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    res = x
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    z, xi, bm, cm, dt = _project(params, xn)

    xbc = torch.cat([xi, bm, cm], dim=-1)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    di = cfg.d_inner
    xi, bm, cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    dt = softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())

    xh = xi.reshape(b, s, h_heads, p)
    y, h_new = _ssd_chunked(xh, dt, a, bm, cm, cfg.ssm_chunk, h_state)
    y = y + xh.float() * params["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)

    y = rms_norm(y * F.silu(z), params["gn"], cfg.norm_eps)
    out = torch.matmul(y, params["wo"])
    return res + out, {"conv": new_conv, "h": h_new}


def ssd_decode(params: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict
               ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B,1,D); cache {"conv", "h"}."""
    b = x.shape[0]
    h_heads, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    res = x
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    z, xi, bm, cm, dt = _project(params, xn)

    xbc = torch.cat([xi, bm, cm], dim=-1)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 cache["conv"])
    di = cfg.d_inner
    xi, bm, cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    dt = softplus(dt.float() + params["dt_bias"].float())[:, 0]  # (B,H)
    a = -torch.exp(params["a_log"].float())
    da = torch.exp(dt * a[None, :])  # (B,H)

    xh = xi[:, 0].reshape(b, h_heads, p).float()
    hprev = cache["h"]
    # h = exp(dt*a) h + dt * B (x) x
    hnew = (hprev * da[:, :, None, None]
            + torch.einsum("bn,bhp->bhpn", bm[:, 0].float(),
                           xh * dt[..., None]))
    y = torch.einsum("bn,bhpn->bhp", cm[:, 0].float(), hnew)
    y = y + xh * params["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)

    y = rms_norm(y * F.silu(z), params["gn"], cfg.norm_eps)
    out = torch.matmul(y, params["wo"])
    return res + out, {"conv": new_conv, "h": hnew}


def ssd_cache_shape(cfg: ModelConfig, batch: int) -> dict:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": (batch, cfg.ssm_conv - 1, conv_ch),
        "h": (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
    }
