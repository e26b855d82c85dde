"""Prefix and session KV reuse in the port's TierEngine, against the JAX
package's with the same (converted) weights, in float32 at temperature 0:
a prefix hit and a resumed session decode the tokens of a cold prefill of
the whole prompt (the JAX engine's cold tokens), paged and dense, and
charge only the suffix; the stores evict under their byte budgets; a
request parks while queued or in flight; payloads move between engines
through the wire and incompatible ones are refused; on a paged engine a
hit shares the stored pages copy-free and the pool's references return to
the store's holdings."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.config import ServingConfig as JServingConfig  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.engine import TierEngine as JTierEngine  # noqa: E402
from repro_torch.config import (PolicyConfig, ServingConfig,  # noqa: E402
                                two_tier_topology)
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.baselines import make_policy  # noqa: E402
from repro_torch.core.scheduler import MoAOffScheduler  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import SlotPayload, TierEngine  # noqa: E402
from repro_torch.serving.tiers import ClusterServer  # noqa: E402

torch.set_float32_matmul_precision("highest")
FAMILIES = ("dense", "vlm",
            # as in the JAX suites, moe rides the slow mark
            pytest.param("moe", marks=pytest.mark.slow), "ssm", "hybrid")


@pytest.fixture(scope="module")
def port_model(family_model):
    """``family -> (cfg, port model, port params)``: the JAX reduced model's
    weights, converted."""
    cache = {}

    def get(family):
        if family not in cache:
            cfg, params = family_model(family)
            tm = build_model(reduced_config(cfg.name).replace(
                dtype="float32"), device="cpu")
            cache[family] = (cfg, tm, params_from_numpy(
                jax.device_get(params), "cpu"))
        return cache[family]

    return get


def make_engine(tm, tp, max_batch=2, max_seq=128, **sv_kw):
    sv = ServingConfig(max_batch=max_batch, max_seq=max_seq, **sv_kw)
    return TierEngine(tm, tp, sv, eos_id=-1)


def _inputs(cfg, base_len=40, ext_len=10, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(4, 200, size=base_len).astype(np.int32)
    ext = rng.integers(4, 200, size=ext_len).astype(np.int32)
    extras = {}
    if cfg.frontend == "vision_stub":
        extras["patches"] = rng.standard_normal(
            (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return base, ext, extras


def _drain(eng, rid):
    done = {s.rid: s.generated for s in eng.run_until_drained()}
    eng.finished.clear()
    return done[rid]


_JAX_COLD = {}


def jax_cold(family_model, family, prompt, max_new, extras):
    """The JAX engine's cold tokens for one prompt (cached per input)."""
    key = (family, prompt.tobytes(), max_new)
    if key not in _JAX_COLD:
        cfg, params = family_model(family)
        eng = JTierEngine(j_build(cfg), params,
                          JServingConfig(max_batch=2, max_seq=128), eos_id=-1)
        eng.submit(0, prompt, max_new=max_new, extras=dict(extras))
        _JAX_COLD[key] = list(_drain(eng, 0))
    return _JAX_COLD[key]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_prefix_hit_matches_cold(family, paged, family_model, port_model):
    cfg, tm, tp = port_model(family)
    base, ext, extras = _inputs(cfg)
    full = np.concatenate([base, ext])
    pool = dict(paged=paged, kv_page_size=16)

    cold = make_engine(tm, tp, **pool)
    cold.submit(0, full, max_new=8, extras=dict(extras))
    want = _drain(cold, 0)
    assert want == jax_cold(family_model, family, full, 8, extras)

    warm = make_engine(tm, tp, prefix_cache_mb=64.0, **pool)
    warm.submit(0, base, max_new=8, extras=dict(extras))
    _drain(warm, 0)
    pf0 = warm.prefill_tokens
    warm.submit(1, full, max_new=8, extras=dict(extras))
    assert _drain(warm, 1) == want
    assert warm.prefix_hits == 1
    vis = cfg.num_patches if extras else 0
    assert warm.prefix_hit_tokens == len(base) + vis
    assert warm.prefill_tokens - pf0 == len(ext)  # only the suffix


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_resumed_session_matches_cold(family, paged, family_model,
                                      port_model):
    cfg, tm, tp = port_model(family)
    base, ext, extras = _inputs(cfg)
    pool = dict(paged=paged, kv_page_size=16)

    eng = make_engine(tm, tp, **pool)
    eng.submit(0, base, max_new=6, extras=dict(extras), session="s")
    gen1 = _drain(eng, 0)
    assert gen1 == jax_cold(family_model, family, base, 6, extras)
    assert eng.parks == 1 and "s" in eng.sessions
    hist = np.concatenate([base, np.asarray(gen1, np.int32), ext])
    pf0 = eng.prefill_tokens
    eng.submit(1, hist, max_new=6, extras=dict(extras), session="s")
    got = _drain(eng, 1)
    assert got == jax_cold(family_model, family, hist, 6, extras)
    assert eng.resumed_sessions == 1
    # suffix = the last generated token (sampled, never fed) + new tokens
    assert eng.prefill_tokens - pf0 == len(ext) + 1
    assert "s" in eng.sessions  # turn 2 re-parked
    if paged:
        assert eng.pool.gauges()["pages_free"] == eng.serving.pool_pages


def test_prefix_store_disabled_is_default(port_model):
    cfg, tm, tp = port_model("dense")
    eng = make_engine(tm, tp)
    assert not eng.prefix_store.enabled
    base, ext, _ = _inputs(cfg)
    eng.submit(0, base, max_new=4)
    _drain(eng, 0)
    pf0 = eng.prefill_tokens
    eng.submit(1, np.concatenate([base, ext]), max_new=4)
    _drain(eng, 1)
    assert eng.prefix_hits == 0
    assert eng.prefill_tokens - pf0 == len(base) + len(ext)


def test_engine_lru_eviction_under_tight_prefix_budget(family_model,
                                                       port_model):
    """A budget for about one prompt's ladder keeps only the latest
    prompt's rows, and charges exactly what the JAX engine charges."""
    cfg, tm, tp = port_model("dense")
    rng = np.random.default_rng(3)
    a = rng.integers(4, 200, size=48).astype(np.int32)
    b = rng.integers(4, 200, size=48).astype(np.int32)
    one = make_engine(tm, tp, prefix_cache_mb=64.0)
    one.submit(0, a, max_new=2)
    _drain(one, 0)
    jcfg, jparams = family_model("dense")
    jone = JTierEngine(j_build(jcfg), jparams, JServingConfig(
        max_batch=2, max_seq=128, prefix_cache_mb=64.0), eos_id=-1)
    jone.submit(0, a, max_new=2)
    _drain(jone, 0)
    assert one.prefix_store.lru.bytes == jone.prefix_store.lru.bytes
    need_mb = one.prefix_store.lru.bytes / 1e6
    eng = make_engine(tm, tp, prefix_cache_mb=need_mb * 1.2)
    eng.submit(0, a, max_new=2)
    _drain(eng, 0)
    eng.submit(1, b, max_new=2)
    _drain(eng, 1)
    assert eng.prefix_store.evictions > 0
    hit_b = eng.prefix_store.lookup(np.concatenate([b, [5]]), b"")
    assert hit_b is not None and len(hit_b.tokens) == len(b)
    hit_a = eng.prefix_store.lookup(np.concatenate([a, [5]]), b"")
    assert hit_a is None or len(hit_a.tokens) < len(a)


def test_session_park_respects_budget(port_model):
    cfg, tm, tp = port_model("dense")
    base, ext, _ = _inputs(cfg)
    eng = make_engine(tm, tp, session_cache_mb=0.0)
    eng.submit(0, base, max_new=4, session="s")
    _drain(eng, 0)
    assert eng.parks == 0 and "s" not in eng.sessions
    pf0 = eng.prefill_tokens
    hist = np.concatenate([base, ext])
    eng.submit(1, hist, max_new=4, session="s")
    _drain(eng, 1)
    assert eng.resumed_sessions == 0  # nothing parked: cold fallback
    assert eng.prefill_tokens - pf0 == len(hist)


def test_park_session_marks_inflight_request(port_model):
    cfg, tm, tp = port_model("dense")
    base, _, _ = _inputs(cfg)
    eng = make_engine(tm, tp)
    eng.submit(0, base, max_new=30)
    assert eng.park_session(0, "late")  # still waiting
    eng.step()
    eng.submit(1, base, max_new=30)
    assert eng.park_session(1, "late2")  # waiting while 0 decodes
    assert eng.park_session(0, "late")  # in flight
    assert not eng.park_session(99, "nope")
    eng.run_until_drained()
    assert "late" in eng.sessions and "late2" in eng.sessions


@pytest.mark.parametrize("family", FAMILIES)
def test_session_wire_roundtrip_and_adopt(family, port_model):
    """A parked payload survives the wire with its prompt tokens and extras
    fingerprint; a paged engine adopts a dense engine's payload and the
    next turn resumes warm with the tokens of the unmoved session."""
    cfg, tm, tp = port_model(family)
    base, ext, extras = _inputs(cfg)
    eng = make_engine(tm, tp)
    eng.submit(0, base, max_new=4, extras=dict(extras), session="s")
    _drain(eng, 0)
    parked = eng.sessions.peek("s")
    back = SlotPayload.from_bytes(parked.data.to_bytes())
    assert np.array_equal(back.prompt_tokens, base)
    assert back.extras_fp == parked.data.extras_fp
    assert back.seq.session == "s"
    hist = np.concatenate([base,
                           np.asarray(parked.data.seq.generated, np.int32),
                           ext])
    eng.submit(1, hist, max_new=4, extras=dict(extras), session="s")
    want = _drain(eng, 1)
    eng2 = make_engine(tm, tp, paged=True, kv_page_size=16)
    assert eng2.adopt_session("s", back)
    eng2.submit(7, hist, max_new=4, extras=dict(extras), session="s")
    assert _drain(eng2, 7) == want
    assert eng2.resumed_sessions == 1


def test_adopt_rejects_incompatible_payload(port_model):
    cfg, tm, tp = port_model("dense")
    base, _, _ = _inputs(cfg)
    eng = make_engine(tm, tp)
    eng.submit(0, base, max_new=4, session="s")
    _drain(eng, 0)
    payload = eng.sessions.resume("s").data
    other = make_engine(tm, tp, max_seq=64)  # different geometry
    assert not other.adopt_session("s", payload)
    wrong = dataclasses.replace(payload, model="other-model", _wire=None)
    assert not eng.adopt_session("s", wrong)
    no_prompt = dataclasses.replace(payload, prompt_tokens=None, _wire=None)
    assert not eng.adopt_session("s", no_prompt)
    assert len(eng.sessions) == 0


def test_paged_prefix_hit_is_copy_free(port_model):
    """The stored prefix is a page-id list; a hit maps its full pages into
    the new slot's table (shared, not copied) while the hit decodes, and
    the pool's references come back to the store's holdings, then to zero
    once the store is emptied."""
    cfg, tm, tp = port_model("vlm")
    base, ext, extras = _inputs(cfg, base_len=40)
    eng = make_engine(tm, tp, paged=True, kv_page_size=16,
                      prefix_cache_mb=64.0, fused_steps=4)
    eng.submit(0, base, max_new=2, extras=dict(extras))
    _drain(eng, 0)
    held = sum(len(e.data["pages"]) for e in eng.prefix_store.lru._d.values())
    assert held > 0
    assert eng.pool.pages_used == len({p for e in eng.prefix_store.lru._d
                                       .values() for p in e.data["pages"]})
    eng.submit(1, np.concatenate([base, ext]), max_new=12,
               extras=dict(extras))
    eng.step()  # warm admission + one fused block; still decoding
    (slot,) = [i for i, s in enumerate(eng.slots) if s is not None]
    entry = eng.prefix_store.lookup(np.concatenate([base, ext]),
                                    eng._slot_extras_fp[slot])
    t_len = entry.data["t_len"]
    assert t_len == cfg.num_patches + len(base)
    n_shared = t_len // 16
    assert eng._slot_pages[slot][:n_shared] == entry.data["pages"][:n_shared]
    assert eng.kv_gauges()["pages_shared"] > 0
    eng.run_until_drained()
    eng.pool.check()
    refs = {}
    for e in eng.prefix_store.lru._d.values():
        for p in e.data["pages"]:
            refs[p] = refs.get(p, 0) + 1
    assert eng.pool.pages_used == len(refs)
    for p, n in refs.items():
        assert eng.pool.refcnt[p] == n
    while eng.prefix_store.evict_oldest() is not None:
        pass
    assert eng.pool.gauges()["pages_free"] == eng.serving.pool_pages
    eng.pool.check()


def test_live_session_turns_resume_and_park(family_model):
    """Two turns of one session through the port's ClusterServer: turn 2
    routes sticky, resumes the parked state and prefills only its
    suffix."""
    topo = two_tier_topology()
    sv = ServingConfig(max_batch=2, max_seq=256)
    engines = {}
    for i, tier in enumerate(topo.tiers):
        tm = build_model(reduced_config(tier.model).replace(dtype="float32"),
                         device="cpu")
        engines[tier.name] = TierEngine(tm, tm.init(i), sv)
    server = ClusterServer(engines, topology=topo, sessions=True,
                           scheduler=MoAOffScheduler(policy=make_policy(
                               "moa-off", PolicyConfig(adaptive_tau=False),
                               topology=topo), use_kernel=False))
    server.submit_turn("chat", "hello there, introduce Yourself please. ",
                       max_new=4, complexity={"text": 0.05})
    server.run()
    (r1,) = server.results
    assert r1.warm == ""
    eng = server.engines[r1.tier]
    pf0 = eng.prefill_tokens
    server.submit_turn("chat", "now expand on that Thought. ",
                       max_new=4, complexity={"text": 0.05})
    server.run()
    r2 = server.results[1]
    assert r2.warm == "resume" and r2.warm_tokens > 0
    trace = server.runtime.records[r2.rid].trace()
    assert ("sticky", r1.tier) in trace
    assert ("resume", r2.tier) in trace
    assert ("park", r1.tier) in trace
    hist_len = len(server._session_hist["chat"]["ids"])
    assert eng.prefill_tokens - pf0 < hist_len
    assert server.backend.parked_sessions()[r1.tier] == 1
