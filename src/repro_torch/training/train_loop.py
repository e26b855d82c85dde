"""Training loop: the train-step factory (gradient accumulation, remat by
the model's policy, an in-place optimizer step) and the fault-tolerant
Trainer (auto-resume, preemption save, data-skip on resume). Counterpart of
``repro/training/train_loop.py``.

On a mesh the leaves are DTensors and the same step runs over them: each
gradient is laid out as its parameter (a partial sum is all-reduced, the
data-parallel gradient reduction) before the update.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_token_batch
from repro_torch.distributed.sharding import batch_shardings, distribute
from repro_torch.models import build_model
from repro_torch.models.transformer import mesh_context
from repro_torch.training.optimizer import (OptState, adamw_update,
                                            init_opt_state, tree_leaves,
                                            tree_map, tree_unflatten)


def loss_and_grads(model, params: Any, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the gradient
    of every leaf from ``torch.autograd.grad`` over views of the leaves, so
    no ``.grad`` state is left on them. A leaf the loss does not reach (a
    vlm's ``proj_in`` on a text batch) gets zeros, as under ``jax.grad``."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    # on a mesh the backward pass too (remat recomputes layers there)
    with mesh_context(getattr(model, "mesh", None)):
        loss, metrics = model.loss(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return (_full(loss), {k: _full(v) for k, v in metrics.items()},
            tree_unflatten(live, [_like(g, p) for g, p in zip(grads,
                                                               leaves)]))


def _full(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's global value)."""
    x = x.detach()
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its parameter (a partial sum over
    data-parallel ranks is all-reduced here); a plain one as it is."""
    if hasattr(p, "placements") and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def microbatch(x: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    """Microbatch ``i`` of ``accum``: rows [i*n, (i+1)*n) of the batch. A
    batch DTensor sharded over its rows takes rows [i*n, (i+1)*n) of each
    rank's shard instead (no rows move between ranks): other rows form
    each microbatch, and the accumulated gradient and mean loss are the
    same."""
    if not hasattr(x, "placements") or not any(
            p.is_shard(0) for p in x.placements):
        n = x.shape[0] // accum
        return x[i * n:(i + 1) * n]
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    n = local.shape[0] // accum
    return DTensor.from_local(local[i * n:(i + 1) * n], x.device_mesh,
                              x.placements, run_check=False)


def make_train_step(model, opt_cfg, accum: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and moments updated in place.

    ``accum`` > 1 splits the batch into that many contiguous microbatches:
    activation memory scales with the microbatch, the gradients sum in
    float32 and are divided by ``accum``, the loss is the mean of the
    microbatches' (and there are no ce / aux metrics, as in JAX)."""

    def step(params, opt_state, batch):
        if accum <= 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32,
                memory_format=torch.contiguous_format), params)
            loss = 0.0
            for i in range(accum):
                mb = {k: microbatch(v, i, accum) for k, v in batch.items()}
                l, _, g = loss_and_grads(model, params, mb)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    with torch.no_grad():
                        acc.add_(gi.float())
                loss = loss + l
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = {}
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **om, **metrics}

    return step


class Trainer:
    """Fault-tolerant trainer.

    · auto-resumes from the latest checkpoint in ``cfg.checkpoint_dir``;
    · async-checkpoints every ``checkpoint_every`` steps;
    · on SIGTERM (preemption) writes a final checkpoint and stops;
    · the data stream is seeded by (seed, step) so resume skips consumed
      batches deterministically.

    ``params`` / ``opt_state`` set before ``train()`` are taken as they are
    (no init, no resume). The model runs on ``device`` (default ``cuda``,
    which raises without a card), or on the given model's device.

    With a ``mesh`` (a ``DeviceMesh``, every rank of its process group
    running the same trainer) the model is built on it, as in the JAX
    package; the parameters and moments are replicated DTensors and each
    batch is sharded over the batch axes ("pod", "data"). The checkpoint
    holds full tensors, written by rank 0.
    """

    def __init__(self, cfg: TrainConfig, model=None, mesh=None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        mcfg = get_config(cfg.model)
        self.model = model or build_model(mcfg, sharding=cfg.sharding,
                                          param_dtype="float32",
                                          device=device, mesh=mesh)
        self.mesh = mesh
        self.ckpt = Checkpointer(cfg.checkpoint_dir,
                                 keep=cfg.keep_checkpoints)
        self._step_fn = make_train_step(self.model, cfg.optimizer,
                                        cfg.sharding.gradient_accum)
        self.params = None
        self.opt_state: Optional[OptState] = None
        self.step = 0
        self.history: list = []
        self._preempted = False

    # ------------------------------------------------------------------

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.cfg.seed << 20) + step)
        b = make_token_batch(rng, self.cfg.batch_size, self.cfg.seq_len,
                             self.model.cfg.vocab_size)
        out = {k: torch.as_tensor(v, device=self.model.device)
               for k, v in b.items()}
        if self.mesh is None:
            return out
        axes = {k: ("batch",) + (None,) * (v.dim() - 1)
                for k, v in out.items()}
        placements = batch_shardings(axes, {k: v.shape
                                            for k, v in out.items()},
                                     self.mesh)
        return {k: distribute(v, self.mesh, placements[k])
                for k, v in out.items()}

    def initialize(self, resume: bool = True) -> None:
        self.params = self.model.init(self.cfg.seed)
        if self.mesh is not None:
            from torch.distributed.tensor import Replicate

            rep = [Replicate()] * self.mesh.ndim
            self.params = tree_map(lambda p: distribute(p, self.mesh, rep),
                                   self.params)
        self.opt_state = init_opt_state(self.params, self.cfg.optimizer)
        if resume and self.ckpt.latest_step() is not None:
            tree = {"params": self.params, "opt": self.opt_state}
            step, restored = self.ckpt.restore(tree)
            self.params = restored["params"]
            self.opt_state = restored["opt"]
            self.step = step
            print(f"[trainer] resumed from step {step}")

    def _install_preempt_handler(self) -> None:
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def save(self, async_: bool = True) -> None:
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state}, async_=async_)

    def train(self, steps: Optional[int] = None) -> list:
        if self.params is None:
            self.initialize()
        self._install_preempt_handler()
        target = self.step + (steps if steps is not None else self.cfg.steps)
        t0 = time.perf_counter()
        while self.step < target and not self._preempted:
            batch = self._batch(self.step)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % self.cfg.log_every == 0:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self.history.append((self.step, loss))
                print(f"[trainer] step={self.step} loss={loss:.4f} "
                      f"({dt / self.cfg.log_every:.3f}s/step)")
                t0 = time.perf_counter()
            if self.step % self.cfg.checkpoint_every == 0:
                self.save(async_=True)
        self.save(async_=False)  # final/preemption checkpoint is blocking
        self.ckpt.wait()
        return self.history
