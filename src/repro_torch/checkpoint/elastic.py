"""Elastic restart: restore a checkpoint onto a DIFFERENT mesh shape.
Counterpart of ``repro/checkpoint/elastic.py``.

Checkpoints store full (unsharded) tensors, so elasticity is a matter of
re-resolving the logical-axis rules against the new mesh and laying each
leaf out with the new DTensor placements — scale from 256 ranks to 512 (or
down to 1 for a local debug session) without converting anything.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.distributed.sharding import DEFAULT_RULES, param_shardings


def elastic_restore_tree(ckpt: Checkpointer, tree_like: Any, specs: Any,
                         mesh, step: Optional[int] = None,
                         rules=DEFAULT_RULES, fsdp_axes=()) -> Tuple[int, Any]:
    """Restore ``tree_like`` re-sharded for ``mesh`` (any shape)."""
    shardings = None
    if mesh is not None and specs is not None:
        shardings = param_shardings(specs, mesh, rules, fsdp_axes)
    return ckpt.restore(tree_like, step=step, shardings=shardings, mesh=mesh)
