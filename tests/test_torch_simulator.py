"""The port's discrete-event simulator against the JAX package's: the
pre-refactor golden metrics (keys exact, values to 1e-12) for the four
locked configurations, and requests carrying real pixels routed alike when
the port scores images on the CPU (``device="cpu"``)."""
import json
import os

import pytest

pytest.importorskip("torch")

from repro.config import SimConfig as JSimConfig  # noqa: E402
from repro.data.synthetic import RequestGenerator as JGenerator  # noqa: E402
from repro.serving.simulator import ClusterSimulator as JSimulator  # noqa: E402
from repro_torch.config import SimConfig  # noqa: E402
from repro_torch.data.synthetic import RequestGenerator  # noqa: E402
from repro_torch.serving.simulator import (ClusterSimulator,  # noqa: E402
                                           EdgeCloudSimulator)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_sim_metrics.json")


@pytest.mark.parametrize("key", ["moa-off", "cloud-only", "edge-only-hedge",
                                 "moa-off-fail"])
def test_simulator_matches_golden_metrics(key):
    entry = json.load(open(GOLDEN))[key]
    cfg = dict(entry["config"])
    policy, n, rate = cfg.pop("policy"), cfg.pop("n"), cfg.pop("rate")
    sim = EdgeCloudSimulator(SimConfig(bandwidth_bps=300e6, seed=0),
                             policy_name=policy, cloud_servers=1,
                             edge_servers=1, **cfg)
    for r in RequestGenerator(seed=0, arrival_rate=rate).generate(n):
        sim.submit(r)
    sim.run()
    m = sim.metrics()
    assert set(m) == set(entry["metrics"])
    for k, want in entry["metrics"].items():
        assert m[k] == pytest.approx(want, rel=1e-12, abs=1e-12), k


def test_pixel_requests_route_as_jax_on_cpu():
    """Requests with materialized 64x64 images: the port scores them with
    the image kernel's plain version on the CPU, and every request takes
    the JAX simulator's route and tier."""
    kw = dict(seed=4, arrival_rate=2.0, image_hw=64, materialize_images=True)
    jsim = JSimulator(JSimConfig(seed=0))
    tsim = ClusterSimulator(SimConfig(seed=0), device="cpu")
    assert not tsim.scheduler.use_kernel
    for r in JGenerator(**kw).generate(24):
        jsim.submit(r)
    for r in RequestGenerator(**kw).generate(24):
        tsim.submit(r)
    jsim.run()
    tsim.run()
    want = {o.rid: o for o in jsim.outcomes}
    got = {o.rid: o for o in tsim.outcomes}
    assert sorted(got) == sorted(want) == list(range(24))
    assert any("image" in o.routes for o in got.values())
    for rid, o in got.items():
        assert o.routes == want[rid].routes, rid
        assert o.served_tier == want[rid].served_tier, rid
    assert set(tsim.metrics()) == set(jsim.metrics())
