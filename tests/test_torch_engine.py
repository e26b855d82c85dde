"""The port's TierEngine against the JAX package's at temperature 0 with the
same (converted) weights: per-token and fused decode, dense and paged KV
pools, prompts across two length buckets, a vlm request with patches,
prefill attention ``auto`` on both sides and JAX ``pallas`` against port
``torch``; the port engine's snapshot/restore round trip; and which engine
paths are live and which still raise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.config import ServingConfig as JServingConfig  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.engine import TierEngine as JTierEngine  # noqa: E402
from repro_torch.config import ServingConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import MigrationError, TierEngine  # noqa: E402

torch.set_float32_matmul_precision("highest")


#: prefill attention impls (JAX, port) that compute the same function: the
#: default dispatchers, and the Pallas flash-attention kernel against the
#: port's plain version of its CUDA kernel
IMPLS = {"auto": ("auto", "auto"), "pallas": ("pallas", "torch")}


@pytest.fixture(scope="module", params=[
    ("qwen2-vl-2b", "auto"), ("qwen3-0.6b", "auto"),
    ("qwen2-vl-2b", "pallas"), ("qwen3-0.6b", "pallas")],
    ids=lambda p: p[0] if p[1] == "auto" else f"{p[0]}-pallas-torch")
def models(request):
    name, impl = request.param
    j_impl, t_impl = IMPLS[impl]
    jm = j_build(j_reduced(name).replace(dtype="float32"), attn_impl=j_impl)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(reduced_config(name).replace(dtype="float32"),
                     attn_impl=t_impl, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), "cpu")


def _jobs(cfg, n=5):
    """More requests than slots (slot refill), prompt lengths across two
    length buckets, patches on every other vlm request. Every prefill has
    S <= 64 (max_seq), which the Pallas kernel takes."""
    rng = np.random.default_rng(0)
    out = []
    for rid in range(n):
        toks = rng.integers(4, cfg.vocab_size, 6 + 7 * rid).astype(np.int32)
        extras = {}
        if cfg.frontend == "vision_stub" and rid % 2 == 0:
            extras["patches"] = rng.standard_normal(
                (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        out.append((rid, toks, 4 + rid % 3, extras))
    return out


def _drain(eng, jobs):
    for rid, toks, max_new, extras in jobs:
        eng.submit(rid, toks, max_new=max_new, extras=extras)
    return {s.rid: list(s.generated) for s in eng.run_until_drained()}


@pytest.mark.parametrize("fused", [1, 8])
@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_match_jax(models, fused, paged):
    jm, jp, tm, tp = models
    kw = dict(max_batch=2, max_seq=64, fused_steps=fused, paged=paged,
              kv_page_size=16)
    jobs = _jobs(tm.cfg)
    want = _drain(JTierEngine(jm, jp, JServingConfig(**kw)), jobs)
    eng = TierEngine(tm, tp, ServingConfig(**kw))
    got = _drain(eng, jobs)
    assert sorted(got) == sorted(want) == list(range(len(jobs)))
    assert got == want
    if paged:
        assert eng.pool.gauges()["pages_free"] == eng.serving.pool_pages


def test_snapshot_restore_round_trip(models):
    _, _, tm, tp = models
    sv = ServingConfig(max_batch=2, max_seq=64, fused_steps=4, paged=True,
                       kv_page_size=16)
    eng = TierEngine(tm, tp, sv)
    for rid, toks, max_new, extras in _jobs(tm.cfg):
        eng.submit(rid, toks, max_new=max_new + 6, extras=extras)
    eng.step()
    snap = eng.snapshot()
    k0 = len(eng.finished)
    eng.run_until_drained()
    first = {s.rid: list(s.generated) for s in eng.finished[k0:]}
    eng.restore(snap)
    k1 = len(eng.finished)
    eng.run_until_drained()
    again = {s.rid: list(s.generated) for s in eng.finished[k1:]}
    assert again == first and len(first) > 0
    assert eng.pool.gauges()["pages_free"] == sv.pool_pages


def test_engine_keeps_attn_impl(models):
    """The engine's shallow model copy keeps the prefill impl, through
    snapshot and restore, and leaves the caller's model as it was."""
    _, _, tm, tp = models
    sv = ServingConfig(max_batch=2, max_seq=64, decode_impl="torch")
    eng = TierEngine(tm, tp, sv)
    assert eng.model is not tm and eng.model.attn_impl == tm.attn_impl
    assert eng.model.decode_impl == "torch" and tm.decode_impl == "auto"
    snap = eng.snapshot()
    eng.restore(snap)
    assert eng.model.attn_impl == tm.attn_impl


def test_unported_engine_paths_raise_with_roadmap_item(models):
    """Only speculation's recurrent re-feed (families not ported yet) still
    raises with its ROADMAP item; speculation on this model, migration,
    sessions and the prefix store are live (tests/test_torch_speculative.py,
    tests/test_torch_sessions.py and tests/test_torch_migration.py hold
    them to the JAX package)."""
    _, _, tm, tp = models
    eng = TierEngine(tm, tp, ServingConfig(max_batch=1, max_seq=64))
    with pytest.raises(MigrationError, match="holds no decode slot"):
        eng.extract_slot(0)
    assert eng.spec_draft(0, 4) is None  # live: no slot serves rid 0
    recurrent = TierEngine(tm, tp, ServingConfig(max_batch=1, max_seq=64))
    recurrent.cfg = dataclasses.replace(recurrent.cfg, family="hybrid")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        recurrent.spec_verify(0, [5])
    eng.submit(0, np.arange(4, 20, dtype=np.int32), max_new=2, session="s")
    eng.run_until_drained()
    assert eng.parks == 1 and "s" in eng.sessions
    warm = TierEngine(tm, tp, ServingConfig(max_batch=1, max_seq=64,
                                            prefix_cache_mb=1.0))
    assert warm.prefix_store.enabled


def test_encode_image_matches_jax(models):
    jm, jp, tm, tp = models
    img = np.random.default_rng(1).uniform(0, 255, (20, 30)).astype(
        np.float32)
    sv = dict(max_batch=1, max_seq=64)
    want = JTierEngine(jm, jp, JServingConfig(**sv)).encode_image(img, 8, 48)
    got = TierEngine(tm, tp, ServingConfig(**sv)).encode_image(img, 8, 48)
    np.testing.assert_array_equal(got, np.asarray(want))
