"""Carry JAX parameter and cache trees into the port.

The port keeps the JAX package's tree layout (names, layer-stacked shapes),
so conversion is a copy: nested dicts of numpy arrays (for example
``jax.device_get(model.init(PRNGKey(i)))``) become nested dicts of tensors
on ``device``, or DTensors on a mesh laid out by the logical-axis rules
(``params_on_mesh``). Only the input is numpy; this module imports no JAX.
``draw_params`` makes such a tree from a seed, so that both packages can
hold the same weights without either one's random stream.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch

_INT_KINDS = ("i", "u", "b")


def _leaf(x: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind in _INT_KINDS:
        return torch.tensor(arr.astype(np.int32), device=device)
    if arr.dtype != np.float32 and arr.dtype != np.float64:
        arr = arr.astype(np.float32)  # bf16 (ml_dtypes) and friends
    return torch.tensor(arr, device=device).to(dtype)


def _tree(tree: Dict[str, Any], device, dtype) -> Dict[str, Any]:
    return {k: (_tree(v, device, dtype) if isinstance(v, dict)
                else _leaf(v, device, dtype))
            for k, v in tree.items()}


def params_from_numpy(tree: Dict[str, Any],
                      device: Union[str, torch.device] = "cuda",
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> port parameters on ``device``,
    every float leaf cast to ``dtype``."""
    return _tree(tree, torch.device(device), dtype)


def draw_params(leaf_specs: Sequence[Mapping[str, Any]],
                seed: int) -> Dict[str, Any]:
    """Weights drawn by numpy from ``seed``, as a nested tree of float32
    numpy leaves in the JAX package's layout: the same tree feeds JAX
    (``jax.tree_util.tree_unflatten`` on its init's treedef) and the port
    (``params_from_numpy``), so both packages hold the same weights bit for
    bit without committing any.

    ``leaf_specs`` lists the leaves in ``tree_flatten_with_path`` order, each
    a mapping with ``name`` (the checkpointer's dotted path), ``shape`` and
    the ``mean``, ``std``, ``min`` and ``max`` of the JAX package's own init
    of that leaf. Each leaf is ``rng.standard_normal(shape)`` scaled to that
    mean and std (in float64), clipped to [min, max], then cast to float32;
    a leaf whose std is 0 (a norm scale of ones, a zero bias) is exactly
    its mean and draws nothing."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Any] = {}
    for spec in leaf_specs:
        shape = tuple(int(d) for d in spec["shape"])
        if spec["std"] == 0.0:
            leaf = np.full(shape, spec["mean"], np.float32)
        else:
            z = rng.standard_normal(shape)
            leaf = np.clip(spec["mean"] + spec["std"] * z, spec["min"],
                           spec["max"]).astype(np.float32)
        *parents, last = spec["name"].split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def cache_from_numpy(tree: Dict[str, Any],
                     device: Union[str, torch.device] = "cuda",
                     dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """JAX cache tree (numpy leaves) -> port cache: KV leaves in ``dtype``,
    the integer bookkeeping leaves (pos, index, pages) as int32."""
    return _tree(tree, torch.device(device), dtype)


def params_on_mesh(tree: Dict[str, Any], specs: Dict[str, Any], mesh,
                   dtype: torch.dtype = torch.float32, rules=None,
                   fsdp_axes=()) -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves, the same on every rank) -> DTensors
    on ``mesh``, each laid out by ``param_shardings`` of its ``ParamSpec``
    (each rank keeps its block; no communication)."""
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  distribute_tree,
                                                  param_shardings)

    shardings = param_shardings(specs, mesh, rules or DEFAULT_RULES,
                                fsdp_axes)
    return distribute_tree(params_from_numpy(tree, "cpu", dtype), shardings,
                           mesh)
