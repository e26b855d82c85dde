"""Cross-tier speculative decoding in the port's TierEngine, held to the JAX
package's protocol on the same (converted) weights, in float32: for perfect,
garbage and partially right drafts, on dense and paged caches, both
packages commit the target-only stream, with the same accepted and
rolled-back counts in every round; k = 1, a mid-draft EOS and max_new = 1
behave; rejected tails leak no pages and never count as decoded tokens;
the draft and verify passes run on a copy of the slot's rows; the
two-engine co-drive (quiet shadow admission, draft blocks, commit sync)
commits what the JAX co-drive commits. At temperature 0.7 the port is held
to itself (its keyed draws are not JAX's threefry stream): speculative
tokens equal its fused tokens. A hypothesis fuzz sweeps k x mismatch
position x pool design."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.config import ServingConfig as JServingConfig  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.engine import TierEngine as JTierEngine  # noqa: E402
from repro_torch.config import ServingConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import TierEngine  # noqa: E402

torch.set_float32_matmul_precision("highest")
FAMILIES = ("dense", "vlm",
            # as in the JAX suites, moe rides the slow mark
            pytest.param("moe", marks=pytest.mark.slow), "ssm", "hybrid")
PAGED = dict(paged=True, kv_page_size=32, prefix_cache_mb=0,
             session_cache_mb=0)
MAX_NEW = 12


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


def _sv(cls, paged):
    return cls(max_batch=2, max_seq=96, **(PAGED if paged else {}))


def _port(port_model, family, paged=False, temp=0.0, eos=-1, seed=0):
    _, tm, tp = port_model(family)
    return TierEngine(tm, tp, _sv(ServingConfig, paged), eos_id=eos,
                      sample_temp=temp, seed=seed)


_JAX_ENGINES = {}


def _jax(family_model, family, paged=False, eos=-1):
    """One JAX engine per configuration, reused across cases with fresh
    rids (its jitted functions compile once)."""
    key = (family, paged, eos)
    if key not in _JAX_ENGINES:
        cfg, params = family_model(family)
        _JAX_ENGINES[key] = JTierEngine(j_build(cfg), params,
                                        _sv(JServingConfig, paged),
                                        eos_id=eos)
    return _JAX_ENGINES[key]


def _inputs(cfg, n=10, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 200, size=n).astype(np.int32)
    extras = {}
    if cfg.frontend == "vision_stub":
        extras["patches"] = rng.standard_normal(
            (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return toks, extras


def _plain(eng, toks, max_new, extras, rid=0):
    eng.submit(rid, toks, max_new=max_new, extras=dict(extras))
    done = {s.rid: list(s.generated) for s in eng.run_until_drained()}
    eng.finished.clear()
    return done[rid]


def _spec_target(eng, toks, max_new, draft_for, rid=0, extras=None):
    """Drive ONE request through the target-side verify protocol (either
    package's engine). ``draft_for(generated)`` proposes the next block;
    an empty proposal stops speculating and the fused ``step()`` path
    finishes the request, as the runtime's co-drive does. Returns the
    tokens, the rounds and each round's (drafted, accepted, rolled_back)."""
    mark = len(eng.journal)
    eng.submit(rid, toks, max_new=max_new, extras=dict(extras or {}))
    eng._admit()
    if eng.spec_slot(rid) is not None:
        eng.spec_begin(rid)
        while eng.spec_slot(rid) is not None:
            slot = eng.spec_slot(rid)
            draft = draft_for(list(eng.slots[slot].generated))
            if len(draft) == 0:
                break
            res = eng.spec_verify(rid, draft)
            if res is None or res["finished"]:
                break
        if eng.spec_slot(rid) is not None:
            eng.spec_release(rid)
    done = {s.rid: list(s.generated) for s in eng.run_until_drained()}
    eng.finished.clear()
    rounds = [(p["drafted"], p["accepted"], p["rolled_back"])
              for op, p in eng.journal[mark:]
              if op == "spec_verify" and p["rid"] == rid]
    return done[rid], rounds


def _perfect(ref, k):
    return lambda gen: ref[len(gen):len(gen) + k]


def _garbage(ref, k, vocab):
    """Mismatch at EVERY position: each proposal is the true token + 1."""
    return lambda gen: [(t + 1) % vocab for t in ref[len(gen):len(gen) + k]]


def _corrupt_at(ref, k, vocab, j):
    """True continuation with position ``j`` of each block flipped."""
    def f(gen):
        blk = list(ref[len(gen):len(gen) + k])
        if j < len(blk):
            blk[j] = (blk[j] + 1) % vocab
        return blk
    return f


DRAFTS = {
    "perfect": lambda ref, v: _perfect(ref, 4),
    "garbage": lambda ref, v: _garbage(ref, 4, v),
    "partial": lambda ref, v: _corrupt_at(ref, 5, v, 2),
    "k1": lambda ref, v: _perfect(ref, 1),
}

_RID = iter(range(1000, 10**6))


# ---------------------------------------------------------------------------
# the verify protocol against the JAX package's, temperature 0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", sorted(DRAFTS))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_spec_commits_the_jax_stream(family, paged, draft, family_model,
                                     port_model):
    cfg, _, _ = port_model(family)
    toks, extras = _inputs(cfg)
    jeng = _jax(family_model, family, paged)
    ref = _plain(jeng, toks, MAX_NEW, extras, rid=next(_RID))
    assert _plain(_port(port_model, family, paged), toks, MAX_NEW,
                  extras) == ref
    make = DRAFTS[draft]
    want, jrounds = _spec_target(jeng, toks, MAX_NEW,
                                 make(ref, cfg.vocab_size), rid=next(_RID),
                                 extras=extras)
    assert want == ref
    eng = _port(port_model, family, paged)
    free0 = eng.pool.pages_free if paged else None
    out, rounds = _spec_target(eng, toks, MAX_NEW, make(ref, cfg.vocab_size),
                               extras=extras)
    assert out == ref
    assert rounds == jrounds  # (drafted, accepted, rolled_back) per round
    assert eng.spec_rounds == len(rounds) >= 1
    assert eng.accepted_tokens == sum(a for _, a, _ in rounds)
    assert eng.decode_tokens == len(out)  # rolled-back tails never count
    # every round commits its accepted prefix + one correction/bonus token
    assert eng.accepted_tokens == len(out) - 1 - len(rounds)
    if draft == "garbage":
        assert eng.accepted_tokens == 0 and len(rounds) == len(ref) - 1
    else:
        assert eng.accepted_tokens > 0
    if paged:
        assert eng.pool.pages_free == free0  # no refcount leaks
        eng.pool.check()


@pytest.mark.parametrize("family", FAMILIES)
def test_spec_mid_draft_eos_and_max_new_one(family, family_model,
                                            port_model):
    """EOS sampled mid-block stops the commit loop AT the EOS token, as in
    the JAX run; max_new = 1 finishes at admission with no round."""
    cfg, _, _ = port_model(family)
    toks, extras = _inputs(cfg)
    probe = _plain(_port(port_model, family), toks, MAX_NEW, extras)
    eos = probe[3]
    jeng = _jax(family_model, family, eos=eos)
    ref = _plain(jeng, toks, MAX_NEW, extras, rid=next(_RID))
    assert len(ref) < MAX_NEW and ref[-1] == eos
    want, jrounds = _spec_target(jeng, toks, MAX_NEW, _perfect(probe, 8),
                                 rid=next(_RID), extras=extras)
    out, rounds = _spec_target(_port(port_model, family, eos=eos), toks,
                               MAX_NEW, _perfect(probe, 8), extras=extras)
    assert out == want == ref and rounds == jrounds

    eng = _port(port_model, family)
    out, rounds = _spec_target(eng, toks, 1, _perfect(probe, 4),
                               extras=extras)
    assert out == probe[:1] and rounds == [] and eng.spec_rounds == 0


# ---------------------------------------------------------------------------
# rows, pages and counters
# ---------------------------------------------------------------------------


def _slot_rows(eng, slot):
    return {name: t.clone() for name, t in eng._gather_slot_rows(slot).items()
            } if eng._pt is not None else {
        name: leaf[(slice(None),) * bax + (slot,)].clone()
        for name, leaf, bax in eng._leaf_rows()}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_rounds_leave_slot_rows_intact(paged, port_model):
    """The cache is written in place, so the draft block and the verify
    chunk must run on a copy: drafting leaves the slot's rows bitwise
    as they were, and a rejected round changes nothing below the pending
    token's row and masks everything past the committed frontier."""
    cfg, _, _ = port_model("vlm")
    toks, extras = _inputs(cfg)
    eng = _port(port_model, "vlm", paged)
    eng.submit(0, toks, max_new=MAX_NEW, extras=dict(extras))
    eng._admit()
    slot = eng.spec_slot(0)
    eng.spec_begin(0)
    p = int(eng.positions[slot])
    before = _slot_rows(eng, slot)
    draft = eng.spec_draft(0, 4)
    assert draft is not None and len(draft) == 4
    after = _slot_rows(eng, slot)
    for name, t in before.items():
        assert torch.equal(after[name], t), name
    assert int(eng.positions[slot]) == p and eng.drafted_tokens == 4

    ref = _plain(_port(port_model, "vlm", paged), toks, MAX_NEW, extras)
    res = eng.spec_verify(0, [(t + 1) % cfg.vocab_size for t in ref[1:5]])
    assert res["committed"] == ref[1:2] and res["rolled_back"] == 4
    after = _slot_rows(eng, slot)
    for name in ("['blocks']['k']", "['blocks']['v']"):
        assert torch.equal(after[name][:, :p], before[name][:, :p]), name
    pos = after["['pos']"]
    assert torch.equal(pos[:p], before["['pos']"][:p])
    assert int(pos[p]) == p and bool((pos[p + 1:] == -1).all())
    assert int(after["['index']"]) == p + 1 == int(eng.positions[slot])
    eng.spec_release(0)
    assert {s.rid: s.generated for s in eng.run_until_drained()}[0] == ref


def test_spec_paged_release_restores_reservation(port_model):
    """spec_begin trims to the frontier, spec_release regrows the full
    decode budget; the fused path then finishes and every page returns."""
    cfg, _, _ = port_model("dense")
    toks, extras = _inputs(cfg)
    max_new = 40  # a budget past the frontier's page
    ref = _plain(_port(port_model, "dense", True), toks, max_new, extras)
    eng = _port(port_model, "dense", True)
    eng.submit(0, toks, max_new=max_new, extras=extras)
    eng._admit()
    slot = eng.spec_slot(0)
    full = len(eng._slot_pages[slot])
    eng.spec_begin(0)
    assert len(eng._slot_pages[slot]) == eng._page_need(
        int(eng.positions[slot])) < full
    stop = _perfect(ref, 4)
    eng.spec_verify(0, stop(list(eng.slots[slot].generated)))
    eng.spec_release(0)
    assert len(eng._slot_pages[slot]) == full
    assert {s.rid: s.generated for s in eng.run_until_drained()}[0] == ref
    assert eng.pool.pages_free == eng.pool.num_pages
    eng.pool.check()


def test_spec_on_a_prefix_hit_keeps_the_shared_pages(port_model):
    """A slot admitted on a copy-free prefix hit speculates: the verify
    insert writes the whole row back through the page table, so the pages
    it shares with the prefix store receive the very bytes gathered out of
    them (bitwise unchanged); the committed tokens are the cold prefill's,
    and after the drain the pool's references are the store's."""
    cfg, tm, tp = port_model("vlm")
    base, _ = _inputs(cfg, n=40)
    full = np.concatenate([base, _inputs(cfg, n=10, seed=1)[0]])
    _, extras = _inputs(cfg)
    sv = dict(max_batch=2, max_seq=128, paged=True, kv_page_size=16)
    ref = _plain(TierEngine(tm, tp, ServingConfig(**sv), eos_id=-1), full,
                 MAX_NEW, extras)
    eng = TierEngine(tm, tp, ServingConfig(prefix_cache_mb=64.0, **sv),
                     eos_id=-1)
    _plain(eng, base, 4, extras)  # deposits the prefix
    stored = sorted({p for e in eng.prefix_store.lru._d.values()
                     for p in e.data["pages"]})
    kv = eng.cache["blocks"]
    before = {n: kv[n][:, stored].clone() for n in ("k", "v")}
    eng.submit(1, full, max_new=MAX_NEW, extras=dict(extras))
    eng._admit()
    assert eng.prefix_hits == 1 and eng.kv_gauges()["pages_shared"] > 0
    slot = eng.spec_slot(1)
    shared = set(eng._slot_pages[slot]) & set(stored)
    assert shared
    eng.spec_begin(1)
    draft_for = _corrupt_at(ref, 5, cfg.vocab_size, 2)
    while eng.spec_slot(1) is not None:
        res = eng.spec_verify(1, draft_for(list(eng.slots[slot].generated)))
        if res["finished"]:
            break
    assert eng.spec_rounds > 0 and eng.accepted_tokens > 0
    for n in ("k", "v"):
        assert torch.equal(kv[n][:, stored], before[n]), n
    done = {s.rid: list(s.generated) for s in eng.run_until_drained()}
    assert done[1] == ref
    refs = {}
    for e in eng.prefix_store.lru._d.values():
        for p in e.data["pages"]:
            refs[p] = refs.get(p, 0) + 1
    eng.pool.check()
    held = {p: int(eng.pool.refcnt[p])
            for p in range(1, eng.pool.num_pages + 1) if eng.pool.refcnt[p]}
    assert held == refs


def test_spec_refuses_recurrent_families(port_model):
    """Nothing refuses the recurrent families any more: on an ssm engine
    verify and sync of an unknown rid return None / False, as on a dense
    one, and a live slot verifies (the re-feed branch; the families' JAX
    parity is ``test_spec_commits_the_jax_stream``)."""
    eng = _port(port_model, "ssm")
    assert eng.spec_verify(0, [1]) is None
    assert eng.spec_sync(0, [1]) is False
    toks, _ = _inputs(eng.cfg)
    eng.submit(0, toks, max_new=MAX_NEW)
    eng._admit()
    out = eng.spec_verify(0, [1, 2, 3])
    assert out is not None and 1 <= len(out["committed"]) <= 4


# ---------------------------------------------------------------------------
# draft side: quiet shadow admission, draft blocks, commit sync
# ---------------------------------------------------------------------------


def _codrive(teng, deng, toks, extras, max_new, k, rid=0):
    teng.submit(rid, toks, max_new=max_new, extras=dict(extras))
    teng._admit()
    assert teng.spec_slot(rid) is not None
    assert deng.spec_admit_quiet(rid, toks, max_new=max_new + k + 2,
                                 extras=dict(extras)) is not None
    assert not deng.finished
    deng.spec_set_pending(
        rid, teng.slots[teng.spec_slot(rid)].generated[-1])
    teng.spec_begin(rid)
    blocks, rounds = [], []
    while True:
        d = deng.spec_draft(rid, k)
        if d is None or len(d) == 0:
            break
        blocks.append([int(t) for t in d])
        res = teng.spec_verify(rid, d)
        rounds.append((res["drafted"], res["accepted"], res["rolled_back"]))
        if res["finished"]:
            break
        assert deng.spec_sync(rid, res["committed"])
    deng.cancel(rid)
    if teng.spec_slot(rid) is not None:
        teng.spec_release(rid)
    done = {s.rid: list(s.generated) for s in teng.run_until_drained()}
    teng.finished.clear()
    return done[rid], blocks, rounds


@pytest.mark.parametrize("family", FAMILIES)
def test_spec_two_engine_codrive_matches_jax(family, family_model,
                                             port_model):
    """Full protocol with a real draft engine of the same model: every
    proposal matches the target's greedy choice; the port drafts the JAX
    draft's blocks and commits the JAX target's tokens."""
    cfg, params = family_model(family)
    toks, extras = _inputs(cfg)
    k = 4
    ref = _plain(_port(port_model, family), toks, MAX_NEW, extras)
    jt = JTierEngine(j_build(cfg), params, _sv(JServingConfig, False),
                     eos_id=-1)
    jd = JTierEngine(j_build(cfg), params, _sv(JServingConfig, False),
                     eos_id=-1)
    want = _codrive(jt, jd, toks, extras, MAX_NEW, k)
    teng, deng = _port(port_model, family), _port(port_model, family)
    got = _codrive(teng, deng, toks, extras, MAX_NEW, k)
    assert got == want
    out, blocks, rounds = got
    assert out == ref
    drafted = sum(d for d, _, _ in rounds)
    accepted = sum(a for _, a, _ in rounds)
    assert drafted > 0 and accepted >= drafted - k
    assert teng.drafted_tokens == 0 and deng.drafted_tokens == drafted
    assert teng.accepted_tokens == accepted and deng.accepted_tokens == 0
    assert not deng.rids()  # the shadow is gone


def test_spec_admit_quiet_mutes_hooks(port_model):
    cfg, _, _ = port_model("dense")
    toks, _ = _inputs(cfg)
    eng = _port(port_model, "dense")
    calls = []
    eng.on_admit = lambda rid, t: calls.append(("admit", rid))
    eng.on_token = lambda rid, tok, t: calls.append(("token", rid))
    assert eng.spec_admit_quiet(5, toks, max_new=8) is not None
    assert calls == []  # the shadow is invisible to the runtime's hooks
    assert eng.on_admit is not None and eng.on_token is not None
    eng.cancel(5)
    # a shadow finished straight out of prefill leaves no trace
    assert eng.spec_admit_quiet(6, toks, max_new=1) is None
    assert not eng.finished and not eng.rids()


# ---------------------------------------------------------------------------
# temperature 0.7: the port against its own fused path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_temperature_matches_fused(paged, port_model):
    """Keyed draws: row i of a verify chunk draws at position p + i, as the
    fused path does, so perfect, garbage and partial drafts, and a
    fallback to the fused path mid-request, all reproduce the fused
    stochastic stream."""
    cfg, _, _ = port_model("vlm")
    toks, extras = _inputs(cfg)

    def engine():
        return _port(port_model, "vlm", paged, temp=0.7, seed=11)

    ref = _plain(engine(), toks, MAX_NEW, extras)
    assert len(set(ref)) > 3  # really sampled, not one repeated argmax
    half = _perfect(ref, 3)
    for draft_for in (_perfect(ref, 4), _garbage(ref, 4, cfg.vocab_size),
                      _corrupt_at(ref, 5, cfg.vocab_size, 2),
                      lambda gen: half(gen) if len(gen) < 5 else []):
        out, _ = _spec_target(engine(), toks, MAX_NEW, draft_for,
                              extras=extras)
        assert out == ref


# ---------------------------------------------------------------------------
# hypothesis fuzz: k x mismatch position x pool design
# ---------------------------------------------------------------------------

try:
    from hypothesis import HealthCheck, given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # optional dev dependency (requirements-dev.txt)
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    @given(k=st.integers(1, 6), j=st.integers(0, 6), paged=st.booleans())
    @settings(max_examples=12, deadline=None,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    def test_spec_fuzz_k_by_mismatch_position(k, j, paged, family_model,
                                              port_model):
        """Any (block size, mismatch position, pool design): the committed
        stream is the JAX target-only stream, counters exact, invariants
        hold."""
        cfg, _, _ = port_model("dense")
        toks, extras = _inputs(cfg)
        ref = _plain(_jax(family_model, "dense"), toks, 9, extras,
                     rid=next(_RID))
        eng = _port(port_model, "dense", paged)
        out, rounds = _spec_target(eng, toks, 9,
                                   _corrupt_at(ref, k, cfg.vocab_size, j),
                                   extras=extras)
        assert out == ref
        assert eng.decode_tokens == len(out)
        assert eng.accepted_tokens == len(out) - 1 - len(rounds)
        if paged:
            assert eng.pool.pages_free == eng.pool.num_pages
            eng.pool.check()
else:
    @pytest.mark.skip(reason="hypothesis not installed (optional dev dep)")
    def test_spec_fuzz_k_by_mismatch_position():
        pass
