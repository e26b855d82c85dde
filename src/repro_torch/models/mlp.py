"""Dense MLP variants: SwiGLU / GeGLU (fused gate+up), squared-ReLU, GELU.
Counterpart of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.models.layers import activation_fn, is_gated
from repro_torch.models.spec import ParamSpec


def mlp_specs(d_model: int, d_ff: int, activation: str, prefix_axes=()) -> dict:
    """Param specs for one dense MLP. ``prefix_axes`` prepends stacked-layer dims."""
    pshape = tuple(n for n, _ in prefix_axes)
    paxes = tuple(a for _, a in prefix_axes)
    width = 2 * d_ff if is_gated(activation) else d_ff
    return {
        "wi": ParamSpec(pshape + (d_model, width), paxes + ("embed", "ffn"),
                        "scaled"),
        "wo": ParamSpec(pshape + (d_ff, d_model), paxes + ("ffn", "embed"),
                        "scaled"),
    }


def mlp_forward(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x: (..., D) -> (..., D)."""
    h = torch.matmul(x, params["wi"])
    if is_gated(activation):
        up, gate = torch.chunk(h, 2, dim=-1)
        h = activation_fn(activation, up, gate)
    else:
        h = activation_fn(activation, h)
    return torch.matmul(h, params["wo"])
