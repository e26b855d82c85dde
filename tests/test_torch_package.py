"""The port stands alone: importing it (and a bf16 slot payload's trip
through the migration wire) loads no JAX and no ``ml_dtypes``, nor does a
spawned process replica; no module of it (nor chip_smoke.py) imports
``jax``, ``ml_dtypes`` or the JAX package, nothing builds at import, and
asking for CUDA without a card raises instead of falling back to the CPU,
in a worker process too."""
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
            "repro_torch.serving.tiers, repro_torch.kernels.ops, "
            "repro_torch.serving.simulator, repro_torch.models.moe, "
            "repro_torch.models.encdec\n"
            "import numpy as np, torch\n"
            "from repro_torch.serving.engine import SeqState, SlotPayload\n"
            "k = torch.randn(2, 8, 2, 4).to(torch.bfloat16)\n"
            "p = SlotPayload(version=2, model='m', family='vlm', max_seq=8, "
            "seq=SeqState(rid=1, prompt_len=3), position=3, "
            "key=np.zeros(2, np.uint32), leaves={'k': k})\n"
            "q = SlotPayload.from_bytes(p.to_bytes())\n"
            "assert q.leaves['k'].dtype == torch.bfloat16\n"
            "assert torch.equal(q.leaves['k'], k)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import runtime\n"
            "assert not runtime._loaded, 'a kernel library loaded at import'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_spawned_worker_loads_no_jax():
    """A process replica's worker imports neither ``jax`` nor the JAX
    package. ``-X importtime`` passes on to the spawned worker, whose
    import lines share the parent's stderr; only the worker builds a
    model, so the transformer module's line proves its lines are there."""
    code = ("import numpy as np\n"
            "from repro_torch.config import ServingConfig\n"
            "from repro_torch.serving.pool import EnginePool\n"
            "from repro_torch.serving.transport import (ProcessTransport, "
            "ReplicaSpec)\n"
            "if __name__ == '__main__':\n"
            "    tr = ProcessTransport(ReplicaSpec(model='qwen3-0.6b', "
            "serving=ServingConfig(max_batch=1, max_seq=32), "
            "device='cpu'))\n"
            "    pool = EnginePool('edge', [tr])\n"
            "    pool.submit_to(0, 0, np.arange(4, 12, dtype=np.int32), "
            "max_new=2, extras={}, deadline=None, session=None)\n"
            "    fins = []\n"
            "    while not fins:\n"
            "        fins = pool.poll()[0]\n"
            "    pool.close()\n"
            "    assert len(fins[0].generated) == 2\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-X", "importtime", "-c", code],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = [line.rsplit("|", 1)[-1].strip()
            for line in proc.stderr.splitlines()
            if line.startswith("import time:")]
    assert "repro_torch.models.transformer" in mods  # the worker's lines
    bad = sorted({m for m in mods if m.split(".")[0] in
                  ("jax", "jaxlib", "repro", "ml_dtypes")})
    assert not bad, bad


def test_cuda_worker_without_a_card_reports_died():
    """A worker asked for "cuda" on a machine with no card reports died
    and never builds on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.config import ServingConfig
    from repro_torch.serving.transport import (ProcessTransport, ReplicaSpec,
                                               TransportError)

    with pytest.raises(TransportError, match="no CUDA device"):
        ProcessTransport(ReplicaSpec(
            model="qwen3-0.6b", serving=ServingConfig(max_batch=1, max_seq=32),
            name="edge/cuda"), start_timeout_s=60.0)


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
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), (path, mod)


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
    for arch in ("qwen3-moe-235b-a22b", "whisper-small"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(reduced_config(arch))
    with pytest.raises((RuntimeError, AssertionError)):
        image_complexity(np.zeros((1, 8, 8), np.float32))  # kernel -> cuda


def test_copied_configs_match_reference():
    from repro.configs import ALL_ARCHS, get_config as j_get
    from repro_torch.configs import get_config, reduced_config

    from repro.configs import reduced_config as j_reduced

    for name in ALL_ARCHS:
        assert get_config(name).__dict__ == j_get(name).__dict__, name
        assert reduced_config(name).__dict__ == j_reduced(name).__dict__
