"""Per-device cost of one step, counted while it runs. Stands for
``repro/launch/hlo_analysis.py``, which has no direct counterpart: that
module parses XLA's partitioned HLO text, and an eager PyTorch step has no
such program. This one runs the step (on fake tensors in the dry-run) under
two dispatch modes and counts what each rank executes:

  · FLOPs: every product op (``mm``, ``bmm``, ``addmm``, attention, ...)
    by ``torch.utils.flop_counter``'s formulas. An op on DTensors is seen
    at its global shapes, so its count is divided by the number of ranks
    that split the work: the product of the sizes of the mesh dims on
    which the op's output is sharded or a partial sum (on a replicated
    dim every rank computes the whole). That is the count of the local op
    each rank runs; an op on plain tensors (a shard body after
    ``to_local``) is counted as it is;
  · HBM bytes: each op's local inputs read once and outputs written once,
    view ops free, plus each collective's payload. Eager PyTorch does not
    fuse, so this is an upper bound of what a fused program moves (XLA's
    count stops at fusion boundaries);
  · collective bytes: the payload of every collective the step issues
    (the output of all-gather / all-reduce / reduce-scatter / all-to-all /
    broadcast), from ``CommDebugMode``, per collective kind.

Every number is PER RANK, in the keys of ``analyze_hlo``. Loops are run,
not multiplied: a Python loop over layers or microbatches is counted as
many times as it runs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
#: ops that move no bytes of their own (views and metadata)
_FREE = {_aten.view, _aten._unsafe_view, _aten.reshape, _aten.expand,
         _aten.permute, _aten.transpose, _aten.t, _aten.detach,
         _aten.alias, _aten.select, _aten.slice, _aten.unsqueeze,
         _aten.squeeze, _aten.split, _aten.split_with_sizes, _aten.unbind,
         _aten.as_strided, _aten.view_as_real, _aten.view_as_complex,
         _aten._reshape_alias, _aten.lift_fresh, _aten.empty,
         _aten.empty_strided, _aten.sym_size, _aten.sym_stride,
         _aten.sym_numel, _aten.is_same_size}


def _kind(name: str):
    """The collective kind of a functional collective op's name."""
    for key, kind in (("all_gather", "all-gather"),
                      ("all_reduce", "all-reduce"),
                      ("allreduce", "all-reduce"),
                      ("allgather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_to_all", "all-to-all"),
                      ("alltoall", "all-to-all"),
                      ("broadcast", "collective-permute")):
        if key in name:
            return kind
    return None


def _local_bytes(x: Any) -> int:
    if not isinstance(x, torch.Tensor):
        return 0
    if hasattr(x, "_local_tensor"):
        x = x._local_tensor
    return x.numel() * x.element_size()


def _split(out: Any) -> int:
    """The number of ranks that share the work of an op whose (first)
    output is ``out``: 1 for a plain tensor."""
    leaves, _ = tree_flatten(out)
    t = next((x for x in leaves if isinstance(x, torch.Tensor)), None)
    if t is None or not hasattr(t, "placements"):
        return 1
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_shard() or p.is_partial():
            n *= t.device_mesh.size(i)
    return n


class _Counts(TorchDispatchMode):
    """FLOPs and bytes of every op dispatched while active (see the module
    doc). Enter it last, so that it sees an op before DTensor runs it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.num_dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet is None or _kind(str(packet)) is not None:
            return out  # collectives: their bytes come from the comm count
        if packet in flop_registry:
            self.flops += (flop_registry[packet](*args, **kwargs,
                                                 out_val=out)
                           / _split(out))
            self.num_dots += 1
        if packet not in _FREE:
            ins, _ = tree_flatten((args, kwargs))
            outs, _ = tree_flatten(out)
            self.hbm_bytes += sum(_local_bytes(x) for x in ins + outs)
        return out


def _comm_mode():
    """A ``CommDebugMode`` that also sums each collective's payload."""
    from torch.distributed.tensor.debug import CommDebugMode

    class _Payload(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.payload = {c: 0.0 for c in COLLECTIVES}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            packet = getattr(func, "_overloadpacket", None)
            if out is not NotImplemented and packet is not None and (
                    packet in self.comm_registry):
                kind = _kind(str(packet))
                if kind is not None:
                    leaves, _ = tree_flatten(out)
                    self.payload[kind] += sum(_local_bytes(x)
                                              for x in leaves)
            return out

    return _Payload()


def analyze_step(fn: Callable, *args, **kwargs) -> Tuple[Dict[str, Any],
                                                         Any]:
    """Run ``fn(*args, **kwargs)`` and count it. Returns ({"flops",
    "hbm_bytes", "collective_bytes", "per_collective", "num_dots",
    "collective_counts"}, fn's result), every figure per rank."""
    comm = _comm_mode()
    counts = _Counts()
    with comm, counts:
        out = fn(*args, **kwargs)
    coll = sum(comm.payload.values())
    return {"flops": counts.flops,
            "hbm_bytes": counts.hbm_bytes + coll,
            "collective_bytes": coll,
            "per_collective": dict(comm.payload),
            "num_dots": counts.num_dots,
            "collective_counts": {str(k): v for k, v in
                                  comm.get_comm_counts().items()}}, out
