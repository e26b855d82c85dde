"""Logical-axis -> mesh-axis resolution on DTensor meshes. Counterpart of
``repro/distributed/sharding.py``.

Parameters and activations carry *logical* axis names (see
``repro_torch.models.spec.ParamSpec``); this module resolves them against a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's rules
and fallbacks: an axis that does not divide evenly is replicated rather
than erroring, and ZeRO-3 (FSDP) optionally shards the largest still-free
dim over the data axes.

A resolved spec is a :class:`PartitionSpec`, a tuple with one entry per
tensor dim (``None``, a mesh axis name, or a tuple of names), equal entry
by entry to the JAX package's. :func:`to_placements` turns it into the
DTensor placements of a mesh, one per mesh dimension: ``Shard(d)`` where
the axis shards tensor dim ``d``, else ``Replicate()``.

Joint axes shard in MESH order. JAX's entry ``("data", "pod")`` (FSDP over
``fsdp_axes=("data", "pod")``) splits its tensor dim with ``data`` major;
DTensor's several ``Shard(d)`` on one tensor dim follow the mesh's dim
order, which puts ``pod`` first. Each rank's local shard has the same shape
either way, only which rank holds which block differs, and
``full_tensor()`` reassembles the global tensor exactly. Nothing here reads
a block's position, so the port keeps DTensor's order.

A mesh is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``); the spec functions read only those two, so they run on a
stand-in object without a process group.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import spec as pspec_mod
from repro_torch.models.spec import ParamSpec

# logical axis -> mesh axis (tuples tried jointly; filtered by mesh axes)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "seq_sp": ("model",),  # sequence-parallel residuals (batch owns data)
    "embed": (),
    "heads": ("model",),
    "heads_in": (),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "experts_r": (),
    "expert_ffn": (),
    "vocab": ("model",),
    "layers": (),
    "repeats": (),
    "pattern": (),
    "state": (),
    "frontend": (),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of names (sharded jointly). JAX's ``PartitionSpec`` as a plain
    tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _resolve_axis(logical: Optional[str], dim: int, mesh,
                  rules: Dict[str, Tuple[str, ...]]):
    """One logical axis -> mesh axis tuple (or None), divisibility-checked."""
    if logical is None:
        return None
    want = rules.get(logical, ())
    sizes = mesh_axis_sizes(mesh)
    chosen = tuple(a for a in want if a in sizes)
    if not chosen:
        return None
    total = int(np.prod([sizes[a] for a in chosen]))
    if dim % total != 0:
        # try dropping axes from the left (pod first) until it divides
        while chosen and dim % int(np.prod([sizes[a] for a in chosen])) != 0:
            chosen = chosen[1:]
        if not chosen:
            return None
    return chosen if len(chosen) > 1 else chosen[0]


def spec_to_pspec(ps: ParamSpec, mesh,
                  rules: Dict[str, Tuple[str, ...]] = DEFAULT_RULES,
                  fsdp_axes: Sequence[str] = ()) -> PartitionSpec:
    """Resolve one ParamSpec to a PartitionSpec (optionally FSDP over data)."""
    entries = [
        _resolve_axis(ax, dim, mesh, rules)
        for ax, dim in zip(ps.axes, ps.shape)
    ]
    if fsdp_axes:
        sizes = mesh_axis_sizes(mesh)
        used = set()
        for e in entries:
            if e is None:
                continue
            used.update(e if isinstance(e, tuple) else (e,))
        fs = tuple(a for a in fsdp_axes if a in sizes and a not in used)
        total = int(np.prod([sizes[a] for a in fs])) if fs else 1
        if fs and total > 1:
            # shard the LARGEST still-unsharded dim over the fsdp axes
            cands = [(dim, i) for i, (dim, e) in enumerate(zip(ps.shape, entries))
                     if e is None and dim % total == 0]
            if cands:
                _, idx = max(cands)
                entries[idx] = fs if len(fs) > 1 else fs[0]
    return PartitionSpec(*entries)


def logical_pspec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                  mesh, rules: Dict[str, Tuple[str, ...]] = DEFAULT_RULES
                  ) -> PartitionSpec:
    return PartitionSpec(*[
        _resolve_axis(ax, dim, mesh, rules) for ax, dim in zip(axes, shape)])


def to_placements(pspec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``pspec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` if the axis shards tensor dim ``d``, else ``Replicate()``
    (joint axes in mesh order, see the module doc). A mesh dim of one rank
    holds the whole tensor either way: it is always ``Replicate()``, which
    spares DTensor's views the degenerate shards."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, size in zip(mesh.mesh_dim_names, tuple(mesh.shape)):
        dim = next((d for d, e in enumerate(pspec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None or size == 1 else Shard(dim))
    return tuple(out)


def param_shardings(specs, mesh,
                    rules: Dict[str, Tuple[str, ...]] = DEFAULT_RULES,
                    fsdp_axes: Sequence[str] = ()):
    """ParamSpec tree -> tree of DTensor placements (one per mesh dim)."""
    return pspec_mod.tree_map_specs(
        lambda s: to_placements(spec_to_pspec(s, mesh, rules, fsdp_axes),
                                mesh), specs)


def batch_shardings(tree_axes, tree_shapes, mesh, rules=DEFAULT_RULES):
    """Input-batch placements from parallel (axes, shapes) dicts."""
    if isinstance(tree_axes, dict):
        return {k: batch_shardings(v, tree_shapes[k], mesh, rules)
                for k, v in tree_axes.items()}
    return to_placements(logical_pspec(tree_axes, tuple(tree_shapes), mesh,
                                       rules), mesh)


def as_dtensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """A DTensor as it is; a plain tensor as the replicated global value
    (every rank holds the same tensor; no communication)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_block(x: torch.Tensor, mesh, placements,
                grad_placements=None) -> torch.Tensor:
    """This rank's block of ``x`` laid out as ``placements``: the operand
    of a shard body. Its gradient comes back as ``grad_placements`` (a
    partial sum where the ranks of an axis see other tokens or other
    experts)."""
    x = as_dtensor(x, mesh).redistribute(mesh, tuple(placements))
    return x.to_local(grad_placements=grad_placements)


def new_zeros(like: torch.Tensor, shape) -> torch.Tensor:
    """Zeros of ``shape`` in ``like``'s dtype and device, laid out as
    ``like`` when it is a DTensor: each rank allocates its own block only
    (``new_zeros`` of a DTensor would be replicated)."""
    if not hasattr(like, "placements"):
        return like.new_zeros(shape)
    from torch.distributed.tensor import zeros

    return zeros(tuple(shape), dtype=like.dtype,
                 device_mesh=like.device_mesh, placements=like.placements)


def logical_constraint(x: torch.Tensor, axes: Tuple[Optional[str], ...],
                       mesh, rules: Dict[str, Tuple[str, ...]] = DEFAULT_RULES
                       ) -> torch.Tensor:
    """``x`` laid out by logical names on ``mesh`` (identity without a
    mesh): a DTensor is redistributed, a plain tensor is taken as the
    replicated global value and sliced locally (no communication)."""
    if mesh is None:
        return x
    placements = to_placements(logical_pspec(axes, tuple(x.shape), mesh,
                                             rules), mesh)
    x = as_dtensor(x, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def distribute(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A full tensor, the same on every rank, as a DTensor of
    ``placements``: each rank keeps a contiguous copy of its block (the
    full tensor can be freed), with no communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = tuple(placements)
    out = distribute_tensor(x.detach(), mesh, placements, src_data_rank=None)
    local = out.to_local()
    if tuple(local.shape) != tuple(x.shape):
        out = DTensor.from_local(local.clone(), mesh, placements,
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


def distribute_tree(tree, shardings, mesh):
    """A dict tree of full tensors (the same on every rank, on any device)
    -> DTensors on ``mesh``, each leaf moved to the mesh's device and laid
    out by its entry of ``shardings`` (a tree like ``tree`` of placements,
    as ``param_shardings`` gives), one leaf at a time."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k], mesh)
                for k, v in tree.items()}
    return distribute(tree.to(mesh.device_type), mesh, shardings)
