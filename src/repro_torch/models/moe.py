"""Mixture-of-Experts layer. Counterpart of ``repro/models/moe.py``.

Two implementations share one parameter layout:

- ``dense``: every expert computes every token, outputs weighted by the
  router (the oracle, and what ``auto`` picks without a mesh).
- ``dropping``: GShard-style capacity-bounded dispatch through a sort-based
  slot plan (no (T, E, C) one-hot tensor): each expert takes at most
  ``capacity`` of the tokens that picked it, in token order, and the rest
  drop. On a mesh (what ``auto`` picks there) it is expert-parallel, the
  JAX package's ``shard_map``: tokens stay sharded over the batch axes
  ("pod", "data"), experts are sharded over "model", each model shard runs
  the local tokens that picked its experts, and one all-reduce over
  "model" merges the routed partial outputs with the shared expert's
  (whose FFN dim is sharded over "model"). ``decode2d`` on a mesh is the
  weight-stationary decode layout: experts over "data", the expert FFN
  over "model", tokens replicated, one all-reduce over both; without a
  mesh it is the dropping body.

Expert products are plain PyTorch, as the JAX package computes them in XLA.
The combine gathers each token's (at most ``top_k``) slot outputs through
the inverse of the slot plan and sums them in slot order: no atomics, so
it repeats bitwise on the card.

The shard bodies run on each rank's local tensors (``to_local``), and the
all-reduces are DTensor redistributions of a ``Partial`` result, which are
differentiable: each local input declares the placement its gradient
takes (``Partial`` where every rank holds a share of it), so the trainer
differentiates through them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import as_dtensor, local_block
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
    flat = ids.reshape(-1)
    # a static-shape count (no bincount): exact, as every add is 1.0
    counts = torch.zeros(num_experts, dtype=torch.float32,
                         device=ids.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=ids.device))
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
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Slot-centric dispatch plan: per-SLOT vectors of length E_l * C —
    the source token (0 for an empty slot), the combine weight (0 for an
    empty slot) and a validity mask — and its inverse, each token's slots
    (T, k) in ascending order, ``E_l * C`` for an assignment that dropped.
    ids/w: (T, k). Assignments past an expert's capacity, and experts
    outside [e_lo, e_lo + e_local), go to a spare last slot that is cut off
    (the JAX package's ``mode="drop"``)."""
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
    # ``order`` is a permutation: this scatter writes each entry once
    tok_slot = torch.empty_like(dest).scatter_(0, order, dest)
    tok_slot = torch.sort(tok_slot.reshape(t, k), dim=1).values
    return slot_src[:-1], slot_w[:-1], slot_valid[:-1], tok_slot


def _dispatch_gather(xt: torch.Tensor, slot_src: torch.Tensor,
                     slot_valid: torch.Tensor, e_local: int, capacity: int
                     ) -> torch.Tensor:
    """(T, D) tokens -> (E_l, C, D) buffers; empty slots zeroed."""
    x_buf = xt[slot_src] * slot_valid[:, None].to(xt.dtype)
    return x_buf.reshape(e_local, capacity, -1)


def _combine_gather(y_buf: torch.Tensor, tok_slot: torch.Tensor,
                    slot_w: torch.Tensor) -> torch.Tensor:
    """(E_l, C, D) expert outputs -> (T, D): each token's weighted slot
    outputs gathered through ``tok_slot`` and summed in slot order (a
    dropped assignment reads a zero row). The JAX package's scatter-add,
    with no atomics."""
    d = y_buf.shape[-1]
    contrib = y_buf.reshape(-1, d) * slot_w[:, None].to(y_buf.dtype)
    contrib = torch.cat([contrib, contrib.new_zeros((1, d))])
    picked = contrib[tok_slot]  # (T, k, D)
    y = picked[:, 0]
    for j in range(1, picked.shape[1]):
        y = y + picked[:, j]
    return y


def _routed(params: dict, xt: torch.Tensor, ids: torch.Tensor,
            w: torch.Tensor, cfg: ModelConfig, e_lo: int,
            capacity: int) -> torch.Tensor:
    """The routed experts' combined output for the local experts."""
    e_local = params["wi"].shape[0]
    slot_src, slot_w, slot_valid, tok_slot = _dispatch_plan(
        ids, w, e_lo, e_local, capacity)
    x_buf = _dispatch_gather(xt, slot_src, slot_valid, e_local, capacity)
    y_buf = _expert_mlp(x_buf, params["wi"], params["wo"], cfg.activation,
                        params.get("wg"))
    return _combine_gather(y_buf, tok_slot, slot_w)


def moe_dropping_local(params: dict, xt: torch.Tensor, cfg: ModelConfig,
                       e_lo: int = 0, tp: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropping body: one device (``tp`` 1), or one model shard of
    ``tp``, holding experts [e_lo, e_lo + E_local) and a 1/tp slice of the
    shared expert's FFN (its output is then a partial sum). xt: (T, D)
    local tokens; the capacity comes from the local T."""
    t, d = xt.shape
    num_experts = params["wi"].shape[0] * tp
    ids, w, probs = _router_topk(xt, params["router"], cfg.top_k)
    capacity = max(1, int(t * cfg.top_k / num_experts * cfg.capacity_factor))
    y = _routed(params, xt, ids, w, cfg, e_lo, capacity)
    if cfg.num_shared_experts:
        y = y + _shared_expert(params, xt, cfg.activation)
    return y, _aux_loss(probs, ids, num_experts)


# ---------------------------------------------------------------------------
# expert parallelism on a mesh
# ---------------------------------------------------------------------------


def _placements(mesh, default, **by_axis) -> tuple:
    return tuple(by_axis.get(n, default) for n in mesh.mesh_dim_names)


def _local_params(params: dict, mesh, shard: dict, partial_axes) -> dict:
    """Each leaf's local block under ``shard`` (leaf -> {axis: Shard}); on
    the other axes of ``partial_axes`` (where the ranks see other tokens or
    other experts) its gradient is a partial sum, elsewhere replicated."""
    from torch.distributed.tensor import Partial, Replicate

    out = {}
    for name, x in params.items():
        by_axis = shard.get(name, {})
        pl = _placements(mesh, Replicate(), **by_axis)
        grad = tuple(by_axis.get(n, Partial() if n in partial_axes
                                 else Replicate())
                     for n in mesh.mesh_dim_names)
        out[name] = local_block(x, mesh, pl, grad)
    return out


def moe_dropping_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                         mesh, model_axis: str = "model",
                         data_axis: str = "data"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dropping on ``mesh``: tokens sharded over the batch
    axes ("pod", ``data_axis``), experts over ``model_axis``. Returns
    (y, a DTensor laid out like the tokens; aux, the mean over token shards
    of each shard's aux loss)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    d = x.shape[-1]
    names = mesh.mesh_dim_names
    batch_axes = tuple(a for a in ("pod", data_axis) if a in names)
    tp = mesh.size(names.index(model_axis))
    x_pl = _placements(mesh, Replicate(), **{a: Shard(0) for a in batch_axes})
    # tokens' blocks, a partial sum over the model shards (each holds its
    # experts' share): the layout of x's gradient and of y before the
    # all-reduce
    part = _placements(mesh, Replicate(), **{a: Shard(0) for a in batch_axes},
                       **{model_axis: Partial()})
    xl = local_block(x, mesh, x_pl, part)
    e_shard = {model_axis: Shard(0)}
    shard = {"wi": e_shard, "wg": e_shard, "wo": e_shard,
             "shared_wi": {model_axis: Shard(1)},
             "shared_wg": {model_axis: Shard(1)},
             "shared_wo": {model_axis: Shard(0)}}
    # the router's gradient is partial over the model shards too (each
    # holds the combine weights of its own experts only)
    pl = _local_params(params, mesh, shard, batch_axes + (model_axis,))
    e_lo = mesh.get_local_rank(model_axis) * pl["wi"].shape[0]
    y, aux = moe_dropping_local(pl, xl.reshape(-1, d), cfg, e_lo, tp)
    # one all-reduce over the model axis: routed and shared partial sums
    y = DTensor.from_local(y.reshape(xl.shape), mesh, part, run_check=False,
                           shape=x.shape, stride=x.stride())
    y = y.redistribute(mesh, x_pl)
    # aux: every model shard holds the same value; the mean over token
    # shards, written as a sum of partial shares so its gradient is exact
    n_tok = 1
    for a in batch_axes:
        n_tok *= mesh.size(names.index(a))
    share = aux / (n_tok * tp)
    aux = DTensor.from_local(share, mesh, [Partial()] * mesh.ndim,
                             run_check=False)
    return y, aux.redistribute(mesh, [Replicate()] * mesh.ndim)


# ---------------------------------------------------------------------------
# decode-2D: weight-stationary expert parallelism for small token counts
# ---------------------------------------------------------------------------


def moe_decode_2d_local(params: dict, xt: torch.Tensor, cfg: ModelConfig,
                        e_lo: int, dp: int) -> torch.Tensor:
    """Per-shard body: this rank's experts [e_lo, e_lo + E_local) of
    ``E_local * dp`` (experts over "data") with a slice of their FFN dim
    (over "model"), all tokens. The output is a partial sum over both axes:
    no weight ever moves, the only collective is the all-reduce of the
    (tiny) combined activations. The capacity takes one row more than the
    dropping body's, as in the JAX package."""
    t, d = xt.shape
    num_experts = params["wi"].shape[0] * dp
    ids, w, _ = _router_topk(xt, params["router"], cfg.top_k)
    capacity = max(1, int(t * cfg.top_k / num_experts * cfg.capacity_factor)
                   + 1)
    return _routed(params, xt, ids, w, cfg, e_lo, capacity)


def moe_decode_2d_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                          mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-2D on ``mesh``: experts over "data", the expert FFN over
    "model", tokens replicated; one all-reduce over both axes. The shared
    expert runs outside, on the DTensors. Returns (y replicated, aux 0)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    b, s, d = x.shape
    both = ("data", "model")
    rep = (Replicate(),) * mesh.ndim
    part = _placements(mesh, Replicate(), data=Partial(), model=Partial())
    x = as_dtensor(x, mesh)
    xl = local_block(x, mesh, rep, part)
    shard = {"wi": {"data": Shard(0), "model": Shard(2)},
             "wg": {"data": Shard(0), "model": Shard(2)},
             "wo": {"data": Shard(0), "model": Shard(1)}}
    routed = {k: v for k, v in params.items() if not k.startswith("shared")}
    pl = _local_params(routed, mesh, shard, both)
    names = mesh.mesh_dim_names
    dp = mesh.size(names.index("data"))
    e_lo = mesh.get_local_rank("data") * pl["wi"].shape[0]
    y = moe_decode_2d_local(pl, xl.reshape(-1, d), cfg, e_lo, dp)
    y = DTensor.from_local(y.reshape(b, s, d), mesh, part, run_check=False,
                           shape=x.shape, stride=x.stride())
    if mesh.ndim > 1:
        # with the two axes flattened once, DTensor reduces over both in
        # ONE all-reduce (else one per axis)
        mesh[both]._flatten()
    y = y.redistribute(mesh, rep)
    if cfg.num_shared_experts:
        shared = {k: as_dtensor(v, mesh) for k, v in params.items()
                  if k.startswith("shared")}
        y = y + _shared_expert(shared, x.reshape(-1, d),
                               cfg.activation).reshape(b, s, d)
    zero = torch.zeros((), dtype=torch.float32, device=xl.device)
    return y, DTensor.from_local(zero, mesh, rep, run_check=False)


def moe_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                impl: str = "auto", mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux). impl: auto (dropping on a mesh,
    dense without) | dense | dropping | decode2d. Without a mesh,
    dropping and decode2d run the one-device dropping body."""
    if impl == "auto":
        impl = "dropping" if mesh is not None else "dense"
    if impl == "dense":
        return moe_dense_forward(params, x, cfg)
    if impl not in ("dropping", "decode2d"):
        raise ValueError(f"moe impl {impl!r} not in {MOE_IMPLS}")
    if mesh is None:
        b, s, d = x.shape
        y, aux = moe_dropping_local(params, x.reshape(-1, d), cfg)
        return y.reshape(b, s, d), aux
    if impl == "decode2d":
        return moe_decode_2d_forward(params, x, cfg, mesh)
    return moe_dropping_forward(params, x, cfg, mesh)
