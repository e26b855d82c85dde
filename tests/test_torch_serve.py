"""The port's control plane and live front end against the JAX package's:
scheduler decisions and scores on one request stream, ClusterServer routes
and tokens on edge-cloud with converted weights, and the launcher on the
CPU: its warm-serving, migration, speculation and process-replica flags
run to their summary lines."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.config import PolicyConfig as JPolicyConfig  # noqa: E402
from repro.config import ServingConfig as JServingConfig  # noqa: E402
from repro.config import get_topology as j_topology  # noqa: E402
from repro.core.baselines import make_policy as j_make_policy  # noqa: E402
from repro.core.scheduler import MoAOffScheduler as JScheduler  # noqa: E402
from repro.data.synthetic import RequestGenerator as JGenerator  # noqa: E402
from repro.serving.tiers import ClusterServer as JClusterServer  # noqa: E402
from repro.serving.tiers import build_cluster_engines as j_engines  # noqa: E402
from repro_torch.config import PolicyConfig, ServingConfig, get_topology  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.baselines import make_policy  # noqa: E402
from repro_torch.core.scheduler import MoAOffScheduler  # noqa: E402
from repro_torch.data.synthetic import RequestGenerator, make_image  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import TierEngine  # noqa: E402
from repro_torch.serving.tiers import ClusterServer  # noqa: E402


def test_scheduler_decisions_and_scores_match_jax():
    kw = dict(seed=3, image_hw=64, materialize_images=True)
    jreqs = JGenerator(**kw).generate(32)
    treqs = RequestGenerator(**kw).generate(32)
    jsched = JScheduler(policy=j_make_policy("moa-off"))
    tsched = MoAOffScheduler(policy=make_policy("moa-off"), use_kernel=False)
    for jr, tr in zip(jreqs, treqs):
        jd, td = jsched.route(jr), tsched.route(tr)
        assert dataclasses.asdict(td) == dataclasses.asdict(jd)
        for name, jm in jr.modalities.items():
            got, want = tr.modalities[name].complexity, jm.complexity
            if name == "image":
                assert abs(got - want) <= 1e-6, (name, got, want)
            else:  # float32 text scores: bit-identical
                assert got == want, (name, got, want)


def _launcher_mix(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        u = rng.beta(1.6, 1.6)
        img = make_image(rng, u, 64, 64)
        text = (f"Request {i}: describe the Scene {i * 3}. "
                + "and then explain why it matters. " * rng.integers(1, 12))
        out.append((text, img))
    return out


def test_cluster_server_routes_and_tokens_match_jax():
    sv_kw = dict(max_batch=4, max_seq=128, paged=True, kv_page_size=64)
    jtopo = j_topology("edge-cloud")
    jeng = j_engines(jtopo, JServingConfig(**sv_kw))
    jserver = JClusterServer(jeng, topology=jtopo, scheduler=JScheduler(
        policy=j_make_policy("moa-off", JPolicyConfig(adaptive_tau=False),
                             topology=jtopo)))
    topo = get_topology("edge-cloud")
    engines = {}
    for name, je in jeng.items():
        tm = build_model(reduced_config(je.cfg.name).replace(dtype="float32"),
                         device="cpu")
        engines[name] = TierEngine(
            tm, params_from_numpy(jax.device_get(je.params), "cpu"),
            ServingConfig(**sv_kw))
    tserver = ClusterServer(engines, topology=topo, scheduler=MoAOffScheduler(
        policy=make_policy("moa-off", PolicyConfig(adaptive_tau=False),
                           topology=topo), use_kernel=False))
    for server in (jserver, tserver):
        for text, img in _launcher_mix(4):
            server.submit(text, image=img, max_new=4)
    want = {r.rid: r for r in jserver.run(timeout_s=300.0)}
    got = {r.rid: r for r in tserver.run(timeout_s=300.0)}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid, r in got.items():
        assert not r.failed
        assert r.routes == want[rid].routes and r.tier == want[rid].tier
        assert r.tokens == want[rid].tokens, rid
        assert len(r.tokens) == 4


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out


@pytest.mark.parametrize("flag,summary", [
    (["--migrate"], "migrated="), (["--hedge-in-service"], "served 2"),
    (["--migrate-threshold", "2"], "migrated="),
    (["--sessions", "2"], "sessions: "),
    (["--prefix-cache-mb", "4"], "sessions: ")])
def test_launcher_runs_warm_and_migration_flags_on_cpu(capsys, flag,
                                                       summary):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--max-new", "2",
                *flag])
    out = capsys.readouterr().out
    assert "served " in out and summary in out


@pytest.mark.parametrize("flag", [
    (["--speculate", "edge:cloud", "--draft-k", "4"],
     ("speculative decoding: edge drafts k=4", "speculation: ")),
    (["--replicas", "edge=2", "--transport", "process"],
     ("replicas: cloudx1 edgex2 | transport process", "  replicas[edge]: "))])
def test_launcher_refuses_unported_flags(capsys, flag):
    """The launcher refuses no flag any more: speculation and process
    replicas, the last two paths that exited naming their ROADMAP item,
    run on the CPU to their summary lines."""
    from repro_torch.launch import serve

    flags, lines = flag
    serve.main(["--device", "cpu", "--requests", "4", "--max-new", "4",
                *flags])
    out = capsys.readouterr().out
    assert "ROADMAP" not in out and "served 4 requests" in out
    for line in lines:
        assert line in out


@pytest.mark.parametrize("options", [{}, {"sessions": True}])
def test_a_dropped_cluster_server_frees_its_engines_without_the_cycle_collector(
        options):
    """The live backend's engine hooks, its link to the runtime and the
    runtime's handler table hold weak references: with ``gc`` disabled,
    dropping the last reference to a server that has served two requests
    frees its runtime, backend, pools, engines and their caches at once."""
    import gc
    import weakref

    from repro_torch.serving.tiers import build_cluster_engines

    topo = get_topology("edge-cloud")
    engines = build_cluster_engines(topo, ServingConfig(
        max_batch=2, max_seq=128, paged=True, kv_page_size=16,
        prefix_cache_mb=4.0), device="cpu")
    gc.collect()
    gc.disable()
    try:
        server = ClusterServer(engines, topology=topo, **options)
        del engines
        (text, img), = _launcher_mix(1)
        server.submit(text, image=img, max_new=3)
        server.submit("hello there, friend.", max_new=3)
        assert [len(r.tokens) for r in server.run(timeout_s=120.0)] == [3, 3]
        alive = [weakref.ref(x) for x in (server.runtime, server.backend,
                                          *server.pools.values())]
        for eng in server.engines.values():
            alive += [weakref.ref(eng), weakref.ref(eng.cache["blocks"]["k"])]
        del server, eng
        assert [r() is None for r in alive] == [True] * len(alive)
    finally:
        gc.enable()
