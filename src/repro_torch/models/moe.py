"""Mixture-of-Experts layer. Counterpart of ``repro/models/moe.py`` on one
device.

Two implementations share one parameter layout:

- ``dense``: every expert computes every token, outputs weighted by the
  router (the oracle, and what ``auto`` picks without a mesh).
- ``dropping``: GShard-style capacity-bounded dispatch through a sort-based
  slot plan (no (T, E, C) one-hot tensor): each expert takes at most
  ``capacity`` of the tokens that picked it, in token order, and the rest
  drop. ``decode2d`` runs the same body on one device.

The JAX package's ``shard_map`` wrappers (experts sharded over the model
axis, or over data with the expert FFN over model) have no counterpart yet.
Expert products are plain PyTorch, as the JAX package computes them in XLA.
The dropping path's combine is an ``index_add_``, atomic on CUDA: its f32
sums are not bitwise repeatable there.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import activation_fn, is_gated
from repro_torch.models.spec import ParamSpec

MOE_IMPLS = ("auto", "dense", "dropping", "decode2d")


def moe_specs(cfg: ModelConfig, prefix_axes=()) -> dict:
    """up ("wi") and gate ("wg") are separate tensors, plus the shared
    expert's ``shared_*`` when the config has one."""
    pshape = tuple(n for n, _ in prefix_axes)
    paxes = tuple(a for _, a in prefix_axes)
    d, fe, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    specs = {
        "router": ParamSpec(pshape + (d, e), paxes + ("embed", "experts_r"),
                            "small"),
        "wi": ParamSpec(pshape + (e, d, fe),
                        paxes + ("experts", "embed", "expert_ffn"), "scaled"),
        "wo": ParamSpec(pshape + (e, fe, d),
                        paxes + ("experts", "expert_ffn", "embed"), "scaled"),
    }
    if is_gated(cfg.activation):
        specs["wg"] = ParamSpec(pshape + (e, d, fe),
                                paxes + ("experts", "embed", "expert_ffn"),
                                "scaled")
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        specs["shared_wi"] = ParamSpec(pshape + (d, fs),
                                       paxes + ("embed", "ffn"), "scaled")
        specs["shared_wo"] = ParamSpec(pshape + (fs, d),
                                       paxes + ("ffn", "embed"), "scaled")
        if is_gated(cfg.activation):
            specs["shared_wg"] = ParamSpec(pshape + (d, fs),
                                           paxes + ("embed", "ffn"), "scaled")
    return specs


def topk_lower_index_first(x: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_topk(x: torch.Tensor, router_w: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (ids (T, k), weights (T, k) renormalised, probs (T, E)),
    all in float32."""
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    w, ids = topk_lower_index_first(probs, top_k)
    w = w / w.sum(dim=-1, keepdim=True)  # norm_topk_prob
    return ids, w, probs


def _aux_loss(probs: torch.Tensor, ids: torch.Tensor,
              num_experts: int) -> torch.Tensor:
    """Switch/GShard load-balance loss: E * sum_e f_e * p_e."""
    t = probs.shape[0]
    counts = torch.bincount(ids.reshape(-1), minlength=num_experts).float()
    f = counts / max(t * ids.shape[-1], 1)
    p = probs.mean(dim=0)
    return num_experts * (f * p).sum()


def _expert_mlp(xb: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                activation: str, wg=None) -> torch.Tensor:
    """xb: (E, C, D) (or (C, D), the same tokens for every expert);
    wi/wg: (E, D, F); wo: (E, F, D) -> (E, C, D)."""
    up = torch.matmul(xb, wi)
    if is_gated(activation):
        h = activation_fn(activation, up, torch.matmul(xb, wg))
    else:
        h = activation_fn(activation, up)
    return torch.matmul(h, wo)


def _shared_expert(params: dict, x: torch.Tensor,
                   activation: str) -> torch.Tensor:
    up = torch.matmul(x, params["shared_wi"])
    if is_gated(activation):
        h = activation_fn(activation, up,
                          torch.matmul(x, params["shared_wg"]))
    else:
        h = activation_fn(activation, up)
    return torch.matmul(h, params["shared_wo"])


# ---------------------------------------------------------------------------
# dense oracle
# ---------------------------------------------------------------------------


def moe_dense_forward(params: dict, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (y, aux_loss). Computes ALL experts."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    ids, w, probs = _router_topk(xt, params["router"], cfg.top_k)
    comb = torch.zeros((xt.shape[0], cfg.num_experts), dtype=x.dtype,
                       device=x.device)
    comb.scatter_(1, ids, w.to(x.dtype))  # (T, E) combine weights
    all_out = _expert_mlp(xt, params["wi"], params["wo"], cfg.activation,
                          params.get("wg"))  # (E, T, D)
    y = torch.einsum("te,etd->td", comb, all_out)
    if cfg.num_shared_experts:
        y = y + _shared_expert(params, xt, cfg.activation)
    return y.reshape(b, s, d), _aux_loss(probs, ids, cfg.num_experts)


# ---------------------------------------------------------------------------
# dropping (sort-based slot plan)
# ---------------------------------------------------------------------------


def _dispatch_plan(ids: torch.Tensor, w: torch.Tensor, e_lo: int,
                   e_local: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot-centric dispatch plan: per-SLOT vectors of length E_l * C —
    the source token (0 for an empty slot), the combine weight (0 for an
    empty slot) and a validity mask. ids/w: (T, k). Assignments past an
    expert's capacity, and experts outside [e_lo, e_lo + e_local), go to a
    spare last slot that is cut off (the JAX package's ``mode="drop"``)."""
    t, k = ids.shape
    n = t * k
    dev = ids.device
    flat_ids = ids.reshape(-1) - e_lo
    tok_idx = torch.arange(t, dtype=torch.int64,
                           device=dev).repeat_interleave(k)
    w_flat = w.reshape(-1)
    is_local = (flat_ids >= 0) & (flat_ids < e_local)
    sort_key = torch.where(is_local, flat_ids, e_local)
    order = torch.argsort(sort_key, stable=True)
    sorted_ids = sort_key[order]
    starts = torch.searchsorted(
        sorted_ids, torch.arange(e_local, dtype=sorted_ids.dtype, device=dev),
        side="left")
    pos = torch.arange(n, device=dev) - torch.where(
        sorted_ids < e_local, starts[sorted_ids.clamp(max=e_local - 1)], 0)
    valid = (sorted_ids < e_local) & (pos < capacity)
    nslots = e_local * capacity
    dest = torch.where(valid, sorted_ids * capacity + pos, nslots)
    slot_src = torch.zeros(nslots + 1, dtype=torch.int64, device=dev)
    slot_src.scatter_(0, dest, tok_idx[order])
    slot_w = torch.zeros(nslots + 1, dtype=w_flat.dtype, device=dev)
    slot_w.scatter_(0, dest, torch.where(valid, w_flat[order], 0.0))
    slot_valid = torch.zeros(nslots + 1, dtype=torch.bool, device=dev)
    slot_valid.scatter_(0, dest, valid)
    return slot_src[:-1], slot_w[:-1], slot_valid[:-1]


def _dispatch_gather(xt: torch.Tensor, slot_src: torch.Tensor,
                     slot_valid: torch.Tensor, e_local: int, capacity: int
                     ) -> torch.Tensor:
    """(T, D) tokens -> (E_l, C, D) buffers; empty slots zeroed."""
    x_buf = xt[slot_src] * slot_valid[:, None].to(xt.dtype)
    return x_buf.reshape(e_local, capacity, -1)


def _combine_scatter(y_buf: torch.Tensor, slot_src: torch.Tensor,
                     slot_w: torch.Tensor, t: int) -> torch.Tensor:
    """(E_l, C, D) expert outputs -> (T, D) weighted scatter-add."""
    d = y_buf.shape[-1]
    contrib = y_buf.reshape(-1, d) * slot_w[:, None].to(y_buf.dtype)
    out = torch.zeros((t, d), dtype=y_buf.dtype, device=y_buf.device)
    return out.index_add_(0, slot_src, contrib)


def moe_dropping_local(params: dict, xt: torch.Tensor, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropping body on one device (the JAX package's
    ``moe_dropping_local`` with ``model_axis=None``). xt: (T, D)."""
    t, d = xt.shape
    num_experts = params["wi"].shape[0]
    ids, w, probs = _router_topk(xt, params["router"], cfg.top_k)
    capacity = max(1, int(t * cfg.top_k / num_experts * cfg.capacity_factor))
    slot_src, slot_w, slot_valid = _dispatch_plan(ids, w, 0, num_experts,
                                                  capacity)
    x_buf = _dispatch_gather(xt, slot_src, slot_valid, num_experts, capacity)
    y_buf = _expert_mlp(x_buf, params["wi"], params["wo"], cfg.activation,
                        params.get("wg"))
    y = _combine_scatter(y_buf, slot_src, slot_w, t)
    if cfg.num_shared_experts:
        y = y + _shared_expert(params, xt, cfg.activation)
    return y, _aux_loss(probs, ids, num_experts)


def moe_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux). impl: auto (= dense on one
    device) | dense | dropping | decode2d (= the dropping body on one
    device)."""
    if impl == "auto":
        impl = "dense"
    if impl == "dense":
        return moe_dense_forward(params, x, cfg)
    if impl in ("dropping", "decode2d"):
        b, s, d = x.shape
        y, aux = moe_dropping_local(params, x.reshape(-1, d), cfg)
        return y.reshape(b, s, d), aux
    raise ValueError(f"moe impl {impl!r} not in {MOE_IMPLS}")
