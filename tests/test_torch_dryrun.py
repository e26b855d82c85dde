"""The port's dry-run against the JAX package's on 8 ranks: qwen3-0.6b
``train_4k`` on a (2, 4) ("data", "model") mesh and a (2, 2, 2) ("pod",
"data", "model") mesh. The port runs as rank 0 of an 8-rank fake process
group; JAX compiles on 8 forced host devices, its meshes built with Auto
axis types (under jax 0.9 ``jax.make_mesh`` makes Explicit axes by default,
which ``with_sharding_constraint`` refuses; the JAX package's own test
meets that). All run at once: each port cell and the JAX cells in a
subprocess of their own.

They must agree on the model FLOPs, on each rank's argument bytes (within
0.1%; the same layout rules give the same bytes) and on each rank's FLOPs
within 10%, and both must issue collectives."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")

_PORT = textwrap.dedent("""
    import os, json, sys
    os.environ["REPRO_DRYRUN_RANKS"] = "8"
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch.launch.dryrun as dr
    dr.make_production_mesh = lambda multi_pod=False: init_device_mesh(
        "cpu", (2, 2, 2) if multi_pod else (2, 4),
        mesh_dim_names=("pod", "data", "model") if multi_pod
        else ("data", "model"))
    multi_pod = sys.argv[1] == "multi"
    rec = dr.run_cell("qwen3-0.6b", "train_4k", multi_pod, out_dir="")
    print(json.dumps([rec], default=str))
""")

_JAX = textwrap.dedent("""
    import os
    os.environ["REPRO_DRYRUN_DEVICES"] = "8"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, json
    from jax.sharding import AxisType
    import repro.launch.mesh as lm

    def mesh(multi_pod=False):
        shape = (2, 2, 2) if multi_pod else (2, 4)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))

    lm.make_production_mesh = mesh
    import repro.launch.dryrun as dr
    dr.make_production_mesh = mesh
    recs = [dr.run_cell("qwen3-0.6b", "train_4k", mp, out_dir="")
            for mp in (False, True)]
    print(json.dumps(recs, default=str))
""")


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    # the port's two cells each in a process of their own (one fake process
    # group a process), beside JAX's
    cmds = {"port_single": [_PORT, "single"], "port_multi": [_PORT, "multi"],
            "jax": [_JAX]}
    procs = {name: subprocess.Popen([sys.executable, "-c", *args], env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, args in cmds.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return {"port": out["port_single"] + out["port_multi"],
            "jax": out["jax"]}


@pytest.mark.parametrize("mesh", [0, 1], ids=["single_2x4", "multi_2x2x2"])
def test_port_dryrun_agrees_with_jax(records, mesh):
    port, ref = records["port"][mesh], records["jax"][mesh]
    assert port["ok"], port.get("traceback")
    assert ref["ok"], ref.get("traceback")
    assert port["devices"] == ref["devices"] == 8
    assert port["model_flops"] == ref["model_flops"]
    got = port["memory"]["argument_size_in_bytes"]
    want = ref["memory"]["argument_size_in_bytes"]
    assert abs(got - want) <= 1e-3 * want, (got, want)
    assert abs(port["per_device_flops"] / ref["per_device_flops"] - 1) < 0.1
    assert port["collective_bytes_per_device"] > 0
    assert ref["collective_bytes_per_device"] > 0
    # the port's roofline divides by the H100's data sheet, not the TPU's
    assert port["roofline"]["hardware"]["peak_flops_bf16"] == 989e12
