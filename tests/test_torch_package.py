"""The port stands alone: importing it loads no JAX, no module of it (nor
chip_smoke.py) imports ``jax`` or the JAX package, nothing builds at
import, and asking for CUDA without a card raises instead of falling back
to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks load in the test process)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_importing_the_port_loads_no_jax():
    # a subprocess: this test process already imported jax (conftest)
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.serving.tiers, repro_torch.kernels.ops\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import runtime\n"
            "assert not runtime._loaded, 'a kernel library loaded at import'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import reduced_config
    from repro_torch.core.complexity import image_complexity
    from repro_torch.models import build_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(reduced_config("qwen2-vl-2b"), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(reduced_config("qwen2-vl-2b"))  # cuda is the default
    with pytest.raises((RuntimeError, AssertionError)):
        image_complexity(np.zeros((1, 8, 8), np.float32))  # kernel -> cuda


def test_copied_configs_match_reference():
    from repro.configs import ALL_ARCHS, get_config as j_get
    from repro_torch.configs import get_config, reduced_config

    from repro.configs import reduced_config as j_reduced

    for name in ALL_ARCHS:
        assert get_config(name).__dict__ == j_get(name).__dict__, name
        assert reduced_config(name).__dict__ == j_reduced(name).__dict__
