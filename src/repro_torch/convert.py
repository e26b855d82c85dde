"""Carry JAX parameter and cache trees into the port.

The port keeps the JAX package's tree layout (names, layer-stacked shapes),
so conversion is a copy: nested dicts of numpy arrays (for example
``jax.device_get(model.init(PRNGKey(i)))``) become nested dicts of tensors
on ``device``. Only the input is numpy; this module imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Union

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


def cache_from_numpy(tree: Dict[str, Any],
                     device: Union[str, torch.device] = "cuda",
                     dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """JAX cache tree (numpy leaves) -> port cache: KV leaves in ``dtype``,
    the integer bookkeeping leaves (pos, index, pages) as int32."""
    return _tree(tree, torch.device(device), dtype)
