"""Async, atomic checkpointing in the JAX package's on-disk layout.
Counterpart of ``repro/checkpoint/checkpointer.py``.

Layout:  <dir>/step_<N>/<flattened.leaf.path>.npy  +  manifest.json
  · leaf names are JAX's ``tree_flatten_with_path`` names: dict keys (in
    sorted order) and NamedTuple field names joined by ".", unsafe
    characters replaced by "_" (``opt.m.blocks.wq``);
  · the manifest is ``{"step", "leaves": {name: {"dtype", "shape"}}}`` with
    numpy's dtype spelling; bfloat16 leaves are stored as their uint16 bit
    pattern (no ``ml_dtypes`` on either side), so a checkpoint written by
    either package restores in the other;
  · leaves are written to ``step_<N>.tmp-<pid>`` and the directory is then
    renamed: a crash mid-save never corrupts the latest checkpoint;
  · ``save(async_=True)`` copies every leaf to host memory at once and
    writes in a daemon thread; a write error is raised by the next
    ``wait()`` or ``save()``;
  · a tree of DTensors (a trainer on a mesh) is saved as full tensors
    (``full_tensor()``, a collective every rank joins), so the files are
    those of the same tree on one device; rank 0 writes them. ``restore``
    lays each leaf out again on a DTensor ``tree_like`` leaf's mesh, or by
    ``shardings`` on ``mesh`` (``repro_torch.checkpoint.elastic``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import distribute, distribute_tree

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _path_str(path: Tuple[str, ...]) -> str:
    return _SAFE.sub("_", ".".join(path)) or "root"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree: Any, path: Tuple[str, ...] = ()
                           ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in the JAX package's flatten order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [pl for f in tree._fields
                for pl in tree_flatten_with_path(getattr(tree, f),
                                                 path + (f,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, x in enumerate(tree)
                for pl in tree_flatten_with_path(x, path + (str(i),))]
    return [(path, tree)]


def tree_map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                       path: Tuple[str, ...] = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[tree_map_with_path(fn, getattr(tree, f),
                                               path + (f,))
                            for f in tree._fields])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, x, path + (str(i),))
                          for i, x in enumerate(tree))
    return fn(path, tree)


def _is_dtensor(x: Any) -> bool:
    return hasattr(x, "placements") and hasattr(x, "full_tensor")


def _host_copy(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to store, logical numpy dtype name): a copy, since the
    optimizer updates the tensor in place while the writer runs. A DTensor
    is gathered whole first."""
    if _is_dtensor(x):
        x = x.full_tensor()
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = x.numpy()
    return arr, str(arr.dtype)


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------

    def save(self, step: int, tree: Any, async_: bool = True) -> None:
        self.wait()  # one in-flight save at a time
        flat = tree_flatten_with_path(tree)
        leaves = [(_path_str(p),) + _host_copy(x) for p, x in flat]
        if any(_is_dtensor(x) for _, x in flat):
            import torch.distributed as dist

            if dist.get_rank() != 0:
                return  # the gathered copy is the same on every rank
        if async_:
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves), daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int,
               leaves: List[Tuple[str, np.ndarray, str]]) -> None:
        try:
            final = self._step_dir(step)
            tmp = f"{final}.tmp-{os.getpid()}"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest: Dict[str, dict] = {}
            for name, arr, dtype in leaves:
                np.save(os.path.join(tmp, name + ".npy"), arr,
                        allow_pickle=False)
                manifest[name] = {"dtype": dtype, "shape": list(arr.shape)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "leaves": manifest}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()
        except BaseException as e:  # surfaced on the next wait()/save()
            self._error = e

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None, mesh=None
                ) -> Tuple[int, Any]:
        """Restore into the structure of ``tree_like`` (the latest step by
        default); each leaf lands on its ``tree_like`` leaf's device, in
        the stored dtype. A DTensor leaf is laid out again with its mesh
        and placements; ``shardings`` (a dict tree like ``tree_like`` of
        DTensor placements) lays every leaf out on ``mesh`` instead
        (elastic restore onto a mesh of any shape)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]

        def load(path, like):
            name = _path_str(path)
            arr = np.load(os.path.join(d, name + ".npy"))
            x = _from_file(arr, manifest[name]["dtype"])
            if shardings is not None:
                return x  # laid out below, leaf by leaf
            if _is_dtensor(like):
                return distribute(x.to(like.device), like.device_mesh,
                                  like.placements)
            return x.to(like.device)

        tree = tree_map_with_path(load, tree_like)
        if shardings is not None:
            tree = distribute_tree(tree, shardings, mesh)
        return step, tree
