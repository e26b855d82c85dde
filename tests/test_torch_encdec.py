"""The encoder-decoder family (``encdec``: Whisper-small) against the JAX
package in float32 with the same numpy inputs and converted weights
(``build_model(cfg).init(PRNGKey(i))`` through ``repro_torch.convert``):

* ``layer_norm`` (weight and bias, f32) at 1e-5;
* ``EncDecLM.encode`` at the reduced 32 frames and at the full 1500 (the
  encoder's non-causal self-attention under "auto" and the kernel's plain
  version, "torch"), ``prefill`` (logits and every cache leaf, right-padded
  rows too) and ``decode_step`` at 1e-4. The port's "cuda"/"torch" prefill
  is held to JAX "auto": the JAX "pallas" kernel refuses 1500 frames and
  reads only the first Sq rows of a cross-attention's K/V;
* the attention routing: the cross-attention prefill (Sq != Skv) never
  reaches the self-attention kernel's entry;
* the serving engine decodes the JAX engine's tokens at temperature 0,
  paged and dense, fused (8 steps) and per token, with frames in
  ``extras``; a prefix hit, a resumed session and a migrated slot (paged
  <-> dense, and between the packages) decode the cold tokens; speculation
  is refused, as the JAX engine has no chunked decode for it either."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ServingConfig as JServingConfig  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving.engine import SlotPayload as JSlotPayload  # noqa: E402
from repro.serving.engine import TierEngine as JTierEngine  # noqa: E402
from repro_torch.config import ServingConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving.engine import SlotPayload, TierEngine  # noqa: E402

LTOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-small"


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _close_tree(got, want, tol, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], tol, f"{path}/{k}")
        else:
            assert tuple(got[k].shape) == tuple(np.shape(want[k])), (path, k)
            _close(got[k], want[k], tol)


def _to_port(tree):
    return {k: (_to_port(v) if isinstance(v, dict) else _t(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def whisper():
    """``**cfg overrides -> (jax cfg, jax model, jax params, port cfg,
    port params)``, reduced whisper-small in float32."""
    cache = {}

    def get(seed=0, **kw):
        key = (seed, tuple(sorted(kw.items())))
        if key not in cache:
            cfg = j_reduced(ARCH).replace(dtype="float32", **kw)
            jm = j_build(cfg)
            jp = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
            tcfg = reduced_config(ARCH).replace(dtype="float32", **kw)
            cache[key] = (cfg, jm, jp, tcfg, params_from_numpy(jp, "cpu"))
        return cache[key]

    return get


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        4, cfg.vocab_size, (b, s)).astype(np.int32)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              1e-6)
    _close(tlayers.layer_norm(_t(x), _t(w), _t(b), 1e-6), want, LTOL)
    xb = _t(x).to(torch.bfloat16)
    assert tlayers.layer_norm(xb, _t(w), _t(b)).dtype == torch.bfloat16


@pytest.mark.parametrize("frames", [None, 1500], ids=["F32", "F1500"])
@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_encode_matches_jax(impl, frames, whisper):
    kw = {} if frames is None else {"encoder_seq": frames}
    cfg, jm, jp, tcfg, tp = whisper(**kw)
    f = _frames(cfg, 2, 1)
    want = jm.encode(jp, jnp.asarray(f))
    got = build_model(tcfg, attn_impl=impl, device="cpu").encode(tp, _t(f))
    _close(got, want, TOL)


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
def test_prefill_and_decode_match_jax(padded, impl, whisper):
    cfg, jm, jp, tcfg, tp = whisper(seed=1)
    tm = build_model(tcfg, attn_impl=impl, device="cpu")
    batch = {"tokens": _tokens(cfg, 2, 11, 2), "frames": _frames(cfg, 2, 3)}
    if padded:
        batch["lengths"] = np.array([11, 6], np.int32)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, 24)
    tl, tc = tm.prefill(tp, {k: _t(v) for k, v in batch.items()}, 24)
    _close(tl, jl, TOL)
    jc = jax.device_get(jc)
    _close_tree(tc, jc, TOL)
    tc = _to_port(jc)  # continue both from the JAX cache
    jc = jax.tree.map(jnp.asarray, jc)
    for step in range(3):
        db = {"tokens": _tokens(cfg, 2, 1, 10 + step),
              "positions": np.array([11 + step, 11 + step], np.int32)}
        jl, jc = jm.decode_step(jp, jc, {k: jnp.asarray(v)
                                         for k, v in db.items()})
        tl, tc = tm.decode_step(tp, tc, {k: _t(v) for k, v in db.items()})
        _close(tl, jl, TOL)
    _close_tree(tc, jax.device_get(jc), TOL)


def test_cross_prefill_never_reaches_the_self_attention_kernel(
        whisper, monkeypatch):
    """Under "torch" (and so "cuda") the encoder's and the decoder's
    self-attention take the kernel's entry (Sq == Skv); the cross-attention
    prefill takes the position-aware "auto" choice."""
    cfg, _, _, tcfg, tp = whisper()
    calls = []
    real = tattn.attention

    def spy(q, k, v, pos_q, pos_kv, *, causal=True, window=None,
            impl="auto", **kw):
        calls.append((impl, q.shape[1], k.shape[1], causal))
        return real(q, k, v, pos_q, pos_kv, causal=causal, window=window,
                    impl=impl, **kw)

    monkeypatch.setattr(tattn, "attention", spy)
    tm = build_model(tcfg, attn_impl="torch", device="cpu")
    tm.prefill(tp, {"tokens": _t(_tokens(cfg, 1, 7, 4)),
                    "frames": _t(_frames(cfg, 1, 5))}, 16)
    f = cfg.encoder_seq
    want = ([("torch", f, f, False)] * cfg.encoder_layers
            + [("torch", 7, 7, True), ("auto", 7, f, False)]
            * cfg.num_layers)
    assert calls == want
    with pytest.raises(ValueError, match="frames"):
        tm.prefill(tp, {"tokens": _t(_tokens(cfg, 1, 7, 4))}, 16)


def test_cuda_impl_on_cpu_tensors_raises(whisper):
    """No fallback: asking for the kernels with CPU tensors raises."""
    cfg, _, _, tcfg, tp = whisper()
    batch = {"tokens": _t(_tokens(cfg, 1, 5, 6)),
             "frames": _t(_frames(cfg, 1, 7))}
    with pytest.raises(ValueError, match="CUDA tensors"):
        build_model(tcfg, attn_impl="cuda", device="cpu").prefill(tp, batch,
                                                                 16)
    _, cache = build_model(tcfg, device="cpu").prefill(tp, batch, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        build_model(tcfg, decode_impl="cuda", device="cpu").decode_step(
            tp, cache, {"tokens": _t([[5]]), "positions": _t([5])})


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _jobs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(4, cfg.vocab_size, n).astype(np.int32),
             {"frames": rng.standard_normal(
                 (cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)})
            for n in (4, 9, 16, 5)]


def _serve(eng, jobs, max_new=10):
    for rid, (toks, ex) in enumerate(jobs):
        eng.submit(rid, toks, max_new=max_new, extras=dict(ex))
    return {s.rid: list(s.generated) for s in eng.run_until_drained()}


def _sv(paged, fused=8, **kw):
    return dict(max_batch=3, max_seq=48, paged=paged, fused_steps=fused,
                **({"kv_page_size": 16} if paged else {}), **kw)


@pytest.mark.parametrize("fused", [1, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_encdec_engine_matches_jax_tokens(paged, fused, whisper):
    cfg, jm, jp, tcfg, tp = whisper()
    tm = build_model(tcfg, device="cpu")
    jobs = _jobs(cfg)
    want = _serve(JTierEngine(jm, jp, JServingConfig(**_sv(paged, fused)),
                              eos_id=-1), jobs)
    eng = TierEngine(tm, tp, ServingConfig(**_sv(paged, fused)), eos_id=-1)
    assert _serve(eng, jobs) == want
    if paged:  # dense state under the flat per-slot page charge
        assert "pages" not in eng.cache and eng._slot_page_charge > 1
        assert eng.pool.gauges()["pages_free"] == eng.serving.pool_pages


def _cold(tm, tp, toks, ex, max_new, paged=False):
    eng = TierEngine(tm, tp, ServingConfig(**_sv(paged)), eos_id=-1)
    eng.submit(0, toks, max_new=max_new, extras=dict(ex))
    return list(eng.run_until_drained()[0].generated)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_encdec_prefix_hit_and_resumed_session_match_cold(paged, whisper):
    """Non-sliceable rows: the prefix store keeps whole processed prompts,
    and a hit or a resumed turn steps its suffix token by token; both
    decode the cold tokens (themselves the JAX engine's) and charge only
    the suffix. A request with other frames misses."""
    cfg, jm, jp, tcfg, tp = whisper()
    tm = build_model(tcfg, device="cpu")
    (base, ex), (ext, ex2) = _jobs(cfg, seed=3)[2], _jobs(cfg, seed=3)[1]
    full = np.concatenate([base, ext])
    want = _cold(tm, tp, full, ex, 8, paged)
    jeng = JTierEngine(jm, jp, JServingConfig(**_sv(paged)), eos_id=-1)
    jeng.submit(0, full, max_new=8, extras=dict(ex))
    assert list(jeng.run_until_drained()[0].generated) == want

    warm = TierEngine(tm, tp, ServingConfig(**_sv(
        paged, prefix_cache_mb=16.0)), eos_id=-1)
    warm.submit(0, base, max_new=8, extras=dict(ex))
    warm.run_until_drained()
    pf0 = warm.prefill_tokens
    warm.submit(1, full, max_new=8, extras=dict(ex))
    got = {s.rid: s.generated for s in warm.run_until_drained()}[1]
    assert got == want and warm.prefix_hits == 1
    assert warm.prefill_tokens - pf0 == len(ext)
    warm.submit(2, full, max_new=8, extras=dict(ex2))  # other audio
    warm.run_until_drained()
    assert warm.prefix_hits == 1

    eng = TierEngine(tm, tp, ServingConfig(**_sv(
        paged, session_cache_mb=16.0)), eos_id=-1)
    eng.submit(0, base, max_new=6, extras=dict(ex), session="s")
    gen1 = list(eng.run_until_drained()[0].generated)
    hist = np.concatenate([base, np.asarray(gen1, np.int32), ext])
    eng.submit(1, hist, max_new=6, extras=dict(ex), session="s")
    got = {s.rid: s.generated for s in eng.run_until_drained()}[1]
    assert got == _cold(tm, tp, hist, ex, 6, paged)
    assert eng.resumed_sessions == 1


@pytest.mark.parametrize("route", ["paged-to-dense", "dense-to-paged",
                                   "jax-to-port", "port-to-jax"])
def test_encdec_slot_migrates(route, whisper):
    """A slot (self cache, cross cache over the frames, bookkeeping) moves
    through the wire mid-decode and finishes with the donor's unmigrated
    tokens."""
    cfg, jm, jp, tcfg, tp = whisper()
    tm = build_model(tcfg, device="cpu")
    toks, ex = _jobs(cfg, seed=4)[2]
    src, dst = route.split("-to-")

    def make(kind):
        if kind == "jax":
            return JTierEngine(jm, jp, JServingConfig(**_sv(False)))
        return TierEngine(tm, tp, ServingConfig(**_sv(kind == "paged")))

    ref = make(src)
    ref.submit(0, toks, max_new=14, extras=dict(ex))
    want = list(ref.run_until_drained()[0].generated)
    donor = make(src)
    donor.submit(0, toks, max_new=14, extras=dict(ex))
    donor.step()
    wire = donor.extract_slot(0).to_bytes()
    payload = (JSlotPayload if dst == "jax" else SlotPayload).from_bytes(wire)
    assert "['cross']['k']" in payload.leaves
    target = make(dst)
    target.inject_slot(payload)
    assert list(target.run_until_drained()[0].generated) == want
    assert target.prefill_tokens == 0


def test_encdec_speculation_is_refused(whisper):
    cfg, _, _, tcfg, tp = whisper()
    eng = TierEngine(build_model(tcfg, device="cpu"), tp,
                     ServingConfig(**_sv(False)), eos_id=-1)
    toks, ex = _jobs(cfg)[1]
    eng.submit(0, toks, max_new=30, extras=dict(ex))
    eng.step()
    assert eng.spec_slot(0) is not None
    with pytest.raises(NotImplementedError, match="chunked decode"):
        eng.spec_verify(0, [5, 6])
    with pytest.raises(NotImplementedError, match="chunked decode"):
        eng.spec_sync(0, [5, 6])
