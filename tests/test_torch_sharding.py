"""The port's distribution layer without a process group: the
logical-axis rules (``spec_to_pspec``) against the JAX package's for every
parameter of the zoo on both production meshes, with and without FSDP axes;
the placements they turn into; the fault-tolerance policy on a scripted
clock; and the per-rank cost counter on known products."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks load in the test process)

from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.spec import iter_specs  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _stand_in(shape, axes):
    """A mesh object either package's rules can read: JAX's reads
    ``axis_names`` and ``devices.shape``, the port's ``mesh_dim_names`` and
    ``shape``."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape),
                                 mesh_dim_names=axes, shape=shape)


def _jax_specs(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "axes"):
            yield prefix + (k,), v
        else:
            yield from _jax_specs(v, prefix + (k,))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [(), ("data", "pod")])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_to_pspec_equals_jax_for_every_param(arch, fsdp, mesh_name):
    mesh = _stand_in(*MESHES[mesh_name])
    # full-width specs: only shapes are read, nothing is allocated
    tspecs = tbuild(get_config(arch), device="cpu").specs()
    from repro.configs import get_config as jget

    jflat = dict(_jax_specs(jbuild(jget(arch)).specs()))
    n = 0
    for path, ps in iter_specs(tspecs):
        jps = jflat[path]
        assert (ps.shape, ps.axes) == (jps.shape, jps.axes), path
        want = jsh.spec_to_pspec(jps, mesh, fsdp_axes=fsdp)
        got = tsh.spec_to_pspec(ps, mesh, fsdp_axes=fsdp)
        assert tuple(got) == tuple(want), (path, got, want)
        n += 1
    assert n == len(jflat)


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _stand_in(*MESHES["multi"])
    ps = tsh.PartitionSpec(("data", "pod"), None, "model")
    # joint axes shard their dim in mesh order (pod first); see the module
    assert tsh.to_placements(ps, mesh) == (Shard(0), Shard(0), Shard(2))
    assert tsh.to_placements(tsh.PartitionSpec(None, None), mesh) == (
        Replicate(),) * 3
    # a dim the axis does not divide stays replicated, as in JAX
    odd = tsh.logical_pspec(("vocab", "heads"), (63, 7), mesh)
    assert tuple(odd) == tuple(jsh.logical_pspec(("vocab", "heads"), (63, 7),
                                                 mesh)) == (None, None)
    shapes = {"tokens": (32, 8), "positions": (32,)}
    axes = {"tokens": ("batch", "seq"), "positions": ("batch",)}
    out = tsh.batch_shardings(axes, shapes, mesh)
    assert out["tokens"] == out["positions"] == (Shard(0), Shard(0),
                                                 Replicate())


def test_logical_constraint_without_a_mesh_is_identity():
    x = torch.randn(2, 3)
    assert tsh.logical_constraint(x, ("batch", "embed"), None) is x


def test_heartbeat_recovery_policy():
    """``tests/test_training.py::test_heartbeat_recovery_policy`` on the
    port's copy, the same scripted clock: both packages take the same
    actions at the same times."""
    from repro.distributed import fault_tolerance as jft
    from repro_torch.distributed import fault_tolerance as tft

    logs = []
    for ft in (jft, tft):
        clock = [0.0]
        reg = ft.HeartbeatRegistry(timeout_s=5.0, clock=lambda: clock[0])
        for w in ("pod0", "pod1", "pod2"):
            reg.register(w)
        coord = ft.RecoveryCoordinator(reg, min_workers=2, spares=["spare0"])
        clock[0] = 3.0
        reg.beat("pod0")
        reg.beat("pod1")
        clock[0] = 6.0  # pod2 missed deadline
        evs = coord.tick()
        assert len(evs) == 1 and evs[0].action == "spare_swap"
        clock[0] = 20.0  # everyone stale now; no spares left
        evs = coord.tick()
        assert {e.action for e in evs} & {"elastic_downsize", "restart"}
        logs.append([(e.t, e.worker, e.action, e.detail) for e in coord.log])
    assert logs[0] == logs[1]


def test_cost_analysis_counts_a_known_matmul():
    from repro_torch.launch.cost_analysis import analyze_step

    r, out = analyze_step(torch.matmul, torch.randn(64, 32),
                          torch.randn(32, 16))
    assert out.shape == (64, 16)
    assert r["flops"] == 2 * 64 * 32 * 16
    assert r["num_dots"] == 1 and r["collective_bytes"] == 0
    # inputs read once, output written once, f32
    assert r["hbm_bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)


def test_cost_analysis_counts_a_layer_stack_per_layer():
    from repro_torch.launch.cost_analysis import analyze_step

    def stack(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    r, _ = analyze_step(stack, torch.randn(5, 16, 16), torch.randn(4, 16))
    assert r["flops"] == 5 * 2 * 4 * 16 * 16
    assert r["num_dots"] == 5
