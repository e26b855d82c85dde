"""Parameter-spec system: one declarative tree drives init, shapes and
counting. Counterpart of ``repro/models/spec.py``.

Trees are nested dicts whose leaves are :class:`ParamSpec`; walks visit
dict keys in sorted order, the leaf order of the JAX package's pytrees.
Init draws from one ``torch.Generator`` on the target device: the same
distributions as the JAX package, not the same random bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

Axis = Optional[str]


@dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor (shape, logical
    axes, init rule)."""

    shape: Tuple[int, ...]
    axes: Tuple[Axis, ...]
    init: str = "normal"  # normal | zeros | ones | scaled | small
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], tree: Dict) -> Dict:
    return {k: (fn(v) if is_spec(v) else tree_map_specs(fn, v))
            for k, v in tree.items()}


def iter_specs(tree: Dict, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], ParamSpec]]:
    """(path, spec) for every leaf, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if is_spec(v):
            yield prefix + (k,), v
        else:
            yield from iter_specs(v, prefix + (k,))


def init_param(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "normal":
        std = spec.scale
    elif spec.init == "scaled":  # fan-in scaled
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 1.0 / np.sqrt(max(fan_in, 1))
    elif spec.init == "small":
        std = 1e-3
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)  # in place: one f32 temporary per leaf


def init_tree(specs: Dict, seed: Union[int, torch.Generator],
              dtype: torch.dtype, device: torch.device) -> Dict:
    """Materialize a param tree from a spec tree, deterministic per seed."""
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    out: Dict = {}
    for path, spec in iter_specs(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = init_param(spec, gen, dtype, device)
    return out


def count_tree(specs: Dict) -> int:
    total = 0
    for _, s in iter_specs(specs):
        total += int(np.prod(s.shape, dtype=np.int64))
    return total
