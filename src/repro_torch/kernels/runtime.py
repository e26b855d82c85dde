"""Build and load the port's CUDA kernels.

Counterpart of ``repro/kernels/runtime.py::auto_interpret``: where the JAX
package chose between compiled and interpreted Pallas, the port compiles
``src/repro_torch/csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into shared
libraries with a plain C interface and loads them with ``ctypes``.

Nothing builds at import. The first kernel call builds every source, one
``nvcc`` process per source, all started together, into
``build/repro_torch_kernels/<digest>/`` at the repository root, where
``<digest>`` hashes the sources and the flags: an edited source rebuilds,
an unchanged one loads what is there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
_build_logs: Dict[str, str] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit on PATH")


def build_all() -> Dict[str, str]:
    """Compile every source that has no library yet, in parallel.

    Returns ``{source stem: nvcc stderr}``; the stderr holds the
    ``-Xptxas -v`` register and shared-memory lines. Raises on any failed
    compile."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src.stem, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for stem, lib, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        _build_logs[stem] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc exit {proc.returncode}\n{stderr}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return dict(_build_logs)


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it if needed."""
    lib = _loaded.get(stem)
    if lib is not None:
        return lib
    path = build_dir() / f"lib{stem}.so"
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    _loaded[stem] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
