"""AdamW with a warmup-cosine schedule and global-norm clipping.
Counterpart of ``repro/training/optimizer.py``.

States are plain trees like the parameters (nested dicts of tensors), so
the checkpointer writes them exactly like params. The arithmetic is the
JAX package's, in float32 and cast back per leaf; the update runs in
place on the caller's tensors (the counterpart of JAX's buffer donation).
The port's trees are layer-stacked, so a model has a few dozen leaves, the
largest several GB (qwen2-vl-2b's ``blocks.mlp.wi`` is 3.1 GB in f32): the
update and the norm walk each leaf in flat slices of ``CHUNK`` elements,
so their float32 temporaries stay a few slices large. The arithmetic is
elementwise, so slicing changes no result; only the norm's sums run in
another order.

On a mesh the leaves are DTensors (parameters, gradients and moments of
one leaf share its placements): the update walks each rank's local shard,
and the norm sums each leaf's local squares and all-reduces them over the
mesh dims that shard it, so a sharded leaf counts each element once and a
replicated leaf counts once, not once per rank.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch

from repro_torch.config import OptimizerConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
#: elements of a leaf the update and the norm take at once (64 MB in f32)
CHUNK = 1 << 24


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar: updates applied so far
    m: Any  # first moment (a tree like params)
    v: Any  # second moment


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict, keys in sorted order (the JAX
    package's leaf order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves: List[torch.Tensor]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lr_schedule(cfg: OptimizerConfig,
                step: Union[int, torch.Tensor]) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params: Any, cfg: OptimizerConfig) -> OptState:
    dt = DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=dt,
                                       memory_format=torch.contiguous_format)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _slices(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Flat views of ``x`` of at most ``CHUNK`` elements (a copy only if
    ``x`` is not contiguous; callers write only into params and moments,
    which are)."""
    return x.reshape(-1).split(CHUNK)


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage); a plain tensor."""
    return x.to_local() if hasattr(x, "placements") else x


def _squares(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares of a leaf, over its shards once on a mesh."""
    sq = sum(torch.sum(torch.square(c.float())) for c in _slices(_local(x)))
    if not hasattr(x, "placements"):
        return sq
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if any(p.is_partial() for p in x.placements):
        raise ValueError("global_norm takes sharded or replicated leaves, "
                         "not partial sums")
    parts = [Partial() if p.is_shard() else Replicate() for p in x.placements]
    return DTensor.from_local(sq, x.device_mesh, parts,
                              run_check=False).full_tensor()


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(_squares(x) for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: OptState,
                 cfg: OptimizerConfig
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and ``state``'s moments;
    returns (params, the new state, {"grad_norm" (before clipping),
    "lr"})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p_full, g, m, v in zip(*(tree_leaves(t) for t in
                                 (params, grads, state.m, state.v))):
        p_ = p_full
        if hasattr(m, "placements") and m.placements != p_full.placements:
            # ZeRO: the moments are sharded finer than the parameter; the
            # update runs on the moments' layout and is gathered back
            p_ = p_full.redistribute(m.device_mesh, m.placements)
            g = g.redistribute(m.device_mesh, m.placements)
        leaf = tuple(map(_local, (p_, g, m, v)))
        for x in leaf[:1] + leaf[2:]:
            if not x.is_contiguous():
                raise ValueError("adamw_update updates contiguous params "
                                 "and moments in place")
        for p, g, m, v in zip(*map(_slices, leaf)):
            g = g.float() * scale
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g * g
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                     + cfg.weight_decay * p.float())
            p.copy_(p.float() - lr * delta)
            m.copy_(m_new)
            v.copy_(v_new)
        if p_ is not p_full:
            p_full.copy_(p_.redistribute(p_full.device_mesh,
                                         p_full.placements))
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}
