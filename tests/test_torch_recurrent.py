"""The recurrent families (``hybrid``: RecurrentGemma, ``ssm``: Mamba-2) and
the attention kernels' head dims and groups, against the JAX package in
float32 with the same numpy inputs (converted weights):

* the kernel contract at the zoo's new shapes: the JAX package's Pallas
  kernels (interpret mode, as ``tests/test_kernels.py`` runs them; paged
  decode: its XLA oracle) at hd 96, 192 and 256 and groups up to 16
  against the port's plain versions, atol 1e-5; every attention config of
  the zoo is one the CUDA kernels take (``supports``), and nothing else
  is;
* ``rglru_forward``/``rglru_decode``, ``ssd_forward``/``ssd_decode`` and
  ``_ssd_chunked`` against JAX at 1e-5;
* hybrid and ssm ``DecoderLM`` prefill logits and caches, decode steps and
  ``decode_chunk_recurrent`` against JAX at 1e-4, with prompts longer than
  the reduced window of 32 so that the ring wraps; a resumed hybrid
  session through either suffix path (one chunk, or token by token)
  against the JAX engine.
The CUDA kernels themselves at these shapes need a card (marked ``gpu``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_ARCHS as J_ALL_ARCHS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import (ALL_ARCHS, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

torch.set_float32_matmul_precision("highest")
KTOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.as_tensor(np.asarray(x))


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


# ---------------------------------------------------------------------------
# the kernel contract at the zoo's head dims and groups
# ---------------------------------------------------------------------------


def _attn_configs():
    """(arch, hd, group) of every attention config in the zoo, full and
    reduced (the ssm family has no attention)."""
    out = []
    for arch in ALL_ARCHS:
        for cfg in (get_config(arch), reduced_config(arch)):
            if cfg.family == "ssm":
                continue
            out.append((cfg.name, cfg.resolved_head_dim,
                        cfg.num_heads // cfg.num_kv_heads))
    return out


def test_supports_every_zoo_attention_config():
    assert list(ALL_ARCHS) == list(J_ALL_ARCHS)
    configs = _attn_configs()
    assert {(96, 1), (192, 12), (256, 16), (128, 16)} <= {
        (hd, g) for _, hd, g in configs}
    for arch, hd, g in configs:
        assert tdec.supports(hd, g), (arch, hd, g)
        assert tflash.supports(hd, g), (arch, hd, g)
    for hd, g in ((80, 1), (160, 2), (512, 1), (128, 0)):
        assert not tdec.supports(hd, g) and not tflash.supports(hd, g)
    assert not tdec.supports(128, 17) and tflash.supports(128, 17)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("s,h,kh,hd,window", [
    (128, 4, 4, 96, None), (64, 12, 1, 192, None), (128, 16, 1, 256, 48),
    (64, 16, 1, 128, None)])
def test_flash_plain_matches_pallas_at_zoo_shapes(s, h, kh, hd, window):
    rng = np.random.default_rng(hd + h)
    q, k, v = (_rand(rng, (2, s, n, hd)) for n in (h, kh, kh))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                block_q=64, block_k=64, interpret=True)
    got = tflash.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                       window=window)
    _close(got, want, KTOL)
    tiled = tflash.flash_attention_tiled_plain(_t(q), _t(k), _t(v),
                                               causal=True, window=window)
    _close(tiled, want, KTOL)


def _decode_inputs(rng, b, t, h, kh, hd, fill):
    q = _rand(rng, (b, 1, h, hd))
    kc, vc = _rand(rng, (b, t, kh, hd)), _rand(rng, (b, t, kh, hd))
    pos = np.full((b, t), -1, np.int32)
    pos[:, :fill] = np.arange(fill)
    pq = np.full((b,), fill - 1, np.int32)
    return q, kc, vc, pq, pos


@pytest.mark.parametrize("t,h,kh,hd,fill,window", [
    (128, 4, 4, 96, 100, None), (160, 12, 1, 192, 160, None),
    (128, 16, 1, 256, 128, 48), (160, 16, 1, 128, 90, None)])
def test_decode_plain_matches_pallas_at_zoo_shapes(t, h, kh, hd, fill,
                                                   window):
    rng = np.random.default_rng(t + hd)
    q, kc, vc, pq, pos = _decode_inputs(rng, 2, t, h, kh, hd, fill)
    want = jops.decode_attention(*map(jnp.asarray, (q, kc, vc, pq, pos)),
                                 window=window, block_t=32, interpret=True)
    got = tdec.decode_attention_plain(*map(_t, (q, kc, vc, pq, pos)),
                                      window=window)
    _close(got, want, KTOL)
    split = tdec.decode_attention_split_plain(
        *map(_t, (q, kc, vc, pq, pos)), split_rows=32, window=window)
    _close(split, want, KTOL)


@pytest.mark.parametrize("hd,h,kh", [(96, 4, 4), (256, 16, 1)])
def test_paged_decode_plain_matches_xla_at_zoo_shapes(hd, h, kh):
    rng = np.random.default_rng(hd)
    b, page, n_pt, t = 2, 16, 6, 90
    pool_k = _rand(rng, (b * n_pt + 1, page, kh, hd))
    pool_v = _rand(rng, (b * n_pt + 1, page, kh, hd))
    pages = (rng.permutation(b * n_pt) + 1).reshape(b, n_pt).astype(np.int32)
    pos = np.full((b, t), -1, np.int32)
    pos[:, :t - 4] = np.arange(t - 4)
    pq = np.full((b,), t - 5, np.int32)
    q = _rand(rng, (b, 1, h, hd))
    args = (q, pool_k, pool_v, pages, pq, pos)
    want = jattn.decode_attention_paged_xla(*map(jnp.asarray, args),
                                            window=40)
    got = tdec.decode_attention_paged_plain(*map(_t, args), window=40)
    _close(got, want, KTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,h,kh,window", [
    (96, 8, 8, None), (192, 12, 1, None), (256, 16, 1, 48), (128, 16, 1, None),
    (32, 16, 1, None)])
def test_kernels_take_zoo_shapes_on_the_card(hd, h, kh, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(hd)
    q, kc, vc, pq, pos = (_t(x).cuda() for x in _decode_inputs(
        rng, 2, 160, h, kh, hd, 130))
    q, kc, vc = q.to(dt), kc.to(dt), vc.to(dt)
    got = tdec.decode_attention_cuda(q, kc, vc, pq, pos, window=window)
    want = tdec.decode_attention_plain(q, kc, vc, pq, pos, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    qf, kf, vf = (_t(_rand(rng, (1, 130, n, hd))).cuda().to(dt)
                  for n in (h, kh, kh))
    got = tflash.flash_attention_cuda(qf, kf, vf, window=window)
    want = tflash.flash_attention_plain(qf, kf, vf, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="not taken"):
        tdec.decode_attention_cuda(q[..., :80].contiguous(), kc[..., :80],
                                   vc[..., :80], pq, pos)


# ---------------------------------------------------------------------------
# the recurrent blocks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hybrid_cfgs():
    """Reduced hybrid configs: one pattern repeat, and one repeat plus two
    extra rglru units (the full model's 38 = 12 x 3 + 2)."""
    base = reduced_config("recurrentgemma-9b").replace(dtype="float32")
    return {"hybrid": base,
            "hybrid+extra": dataclasses.replace(base, num_layers=5)}


def _jax_params(cfg, seed=0):
    jm = j_build(cfg)
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(seed)))


def _leaf(tree, *idx):
    return {k: (_leaf(v, *idx) if isinstance(v, dict) else v[idx])
            for k, v in tree.items()}


def test_lru_scan_matches_associative_scan():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 1.0, (2, 77, 16)).astype(np.float32)
    b = _rand(rng, (2, 77, 16))
    h0 = _rand(rng, (2, 16))
    for init in (None, h0):
        want, want_last = jrglru._lru_scan(
            jnp.asarray(a), jnp.asarray(b),
            None if init is None else jnp.asarray(init))
        got, got_last = trglru._lru_scan(
            _t(a), _t(b), None if init is None else _t(init))
        _close(got, want, KTOL)
        _close(got_last, want_last, KTOL)


def test_rglru_forward_and_decode_match_jax(hybrid_cfgs):
    cfg = hybrid_cfgs["hybrid"]
    _, jp = _jax_params(cfg)
    lp = _leaf(jp["repeats"]["rglru"], 0, 0)
    tp = params_from_numpy(lp, "cpu")
    rng = np.random.default_rng(1)
    w = cfg.lru_width or cfg.d_model
    x = _rand(rng, (2, 45, cfg.d_model))
    conv = _rand(rng, (2, cfg.ssm_conv - 1 if cfg.ssm_conv else 3, w))
    h = _rand(rng, (2, w))
    for state in ({}, {"conv_state": conv, "h_state": h}):
        want, wc = jrglru.rglru_forward(
            lp, jnp.asarray(x), cfg,
            **{k: jnp.asarray(v) for k, v in state.items()})
        got, gc = trglru.rglru_forward(tp, _t(x), cfg,
                                       **{k: _t(v) for k, v in state.items()})
        _close(got, want, KTOL)
        _close_tree(gc, jax.device_get(wc), KTOL)
    cache = {"conv": conv, "h": h}
    want, wc = jrglru.rglru_decode(lp, jnp.asarray(x[:, :1]), cfg,
                                   {k: jnp.asarray(v) for k, v in cache.items()})
    got, gc = trglru.rglru_decode(tp, _t(x[:, :1]), cfg,
                                  {k: _t(v) for k, v in cache.items()})
    _close(got, want, KTOL)
    _close_tree(gc, jax.device_get(wc), KTOL)


def test_ssd_blocks_match_jax(family_model):
    cfg, jp = family_model("ssm")
    lp = _leaf(jax.device_get(jp)["blocks"], 0)
    tp = params_from_numpy(lp, "cpu")
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 45, cfg.d_model))
    cs = jssm.ssd_cache_shape(cfg, 2)
    conv, h = _rand(rng, cs["conv"]), _rand(rng, cs["h"])
    for state in ({}, {"conv_state": conv, "h_state": h}):
        want, wc = jssm.ssd_forward(
            lp, jnp.asarray(x), cfg,
            **{k: jnp.asarray(v) for k, v in state.items()})
        got, gc = tssm.ssd_forward(tp, _t(x), cfg,
                                   **{k: _t(v) for k, v in state.items()})
        _close(got, want, KTOL)
        _close_tree(gc, jax.device_get(wc), KTOL)
    cache = {"conv": conv, "h": h}
    want, wc = jssm.ssd_decode(lp, jnp.asarray(x[:, :1]), cfg,
                               {k: jnp.asarray(v) for k, v in cache.items()})
    got, gc = tssm.ssd_decode(tp, _t(x[:, :1]), cfg,
                              {k: _t(v) for k, v in cache.items()})
    _close(got, want, KTOL)
    _close_tree(gc, jax.device_get(wc), KTOL)
    # the chunked scan alone: a ragged tail (45 = 32 + 13) and a seed state
    hh, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = _rand(rng, (2, 45, hh, p))
    dt = rng.uniform(0.01, 0.5, (2, 45, hh)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (hh,)).astype(np.float32)
    bm, cm = _rand(rng, (2, 45, n)), _rand(rng, (2, 45, n))
    h0 = _rand(rng, (2, hh, p, n))
    args = (xh, dt, a, bm, cm)
    want, wh = jssm._ssd_chunked(*map(jnp.asarray, args), cfg.ssm_chunk,
                                 jnp.asarray(h0))
    got, gh = tssm._ssd_chunked(*map(_t, args), cfg.ssm_chunk, _t(h0))
    _close(got, want, KTOL)
    _close(gh, wh, KTOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["hybrid", "hybrid+extra", "ssm"])
def model_pair(request, hybrid_cfgs):
    cfg = (reduced_config("mamba2-2.7b").replace(dtype="float32")
           if request.param == "ssm" else hybrid_cfgs[request.param])
    jm, jp = _jax_params(cfg)
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jp, "cpu")


def test_model_prefill_decode_and_chunk_match_jax(model_pair):
    """A 45-token prompt (the reduced window is 32: the ring wraps), three
    decode steps, then a 40-token chunk (longer than the ring: it is
    rebuilt from the chunk's tail) and a 5-token chunk (written into the
    ring in place), all logits and every cache leaf against JAX."""
    jm, jp, tm, tp = model_pair
    rng = np.random.default_rng(3)
    vocab, cap, s = tm.cfg.vocab_size, 96, 45
    toks = rng.integers(4, vocab, (2, s)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cap)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, cap)
    _close(tl, jl, TOL)
    _close_tree(tc, jax.device_get(jc), TOL)
    pos = s
    for _ in range(3):
        tok = rng.integers(4, vocab, (2, 1)).astype(np.int32)
        p = np.full((2,), pos, np.int32)
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                         "positions": jnp.asarray(p)})
        tl, tc = tm.decode_step(tp, tc, {"tokens": _t(tok),
                                         "positions": _t(p)})
        _close(tl, jl, TOL)
        pos += 1
    _close_tree(tc, jax.device_get(jc), TOL)
    for n, all_logits in ((40, True), (5, False)):
        ch = rng.integers(4, vocab, (2, n)).astype(np.int32)
        p = np.broadcast_to(pos + np.arange(n, dtype=np.int32), (2, n))
        jl, jc = jm.decode_chunk_recurrent(
            jp, jc, {"tokens": jnp.asarray(ch), "positions": jnp.asarray(p)},
            all_logits=all_logits)
        tl, tc = tm.decode_chunk_recurrent(
            tp, tc, {"tokens": _t(ch), "positions": _t(p.copy())},
            all_logits=all_logits)
        _close(tl, jl, TOL)
        _close_tree(tc, jax.device_get(jc), TOL)
        pos += n


def test_recurrent_chunk_equals_token_steps(model_pair):
    """``decode_chunk_recurrent`` over a suffix leaves the state and the
    last logits that stepping ``decode_step`` over it does."""
    _, _, tm, tp = model_pair
    rng = np.random.default_rng(4)
    toks = rng.integers(4, tm.cfg.vocab_size, (1, 37)).astype(np.int32)
    _, c1 = tm.prefill(tp, {"tokens": _t(toks)}, 64)
    _, c2 = tm.prefill(tp, {"tokens": _t(toks)}, 64)
    suf = rng.integers(4, tm.cfg.vocab_size, 9).astype(np.int32)
    for i, tok in enumerate(suf):
        l1, c1 = tm.decode_step(tp, c1, {
            "tokens": _t(np.asarray([[tok]], np.int32)),
            "positions": _t(np.asarray([37 + i], np.int32))})
    l2, c2 = tm.decode_chunk_recurrent(tp, c2, {
        "tokens": _t(suf[None]),
        "positions": _t((37 + np.arange(9, dtype=np.int32))[None])})
    torch.testing.assert_close(l1, l2, **TOL)
    for name in ("pos", "index"):
        if name in c1:
            assert torch.equal(c1[name], c2[name])


def test_build_model_serves_the_recurrent_families():
    for arch in ("recurrentgemma-9b", "mamba2-2.7b"):
        cfg = get_config(arch)
        tm = build_model(cfg, device="cpu")
        assert tm.cfg.family in ("hybrid", "ssm")
        if cfg.family == "hybrid":
            assert tm._hybrid_counts() == (12, 2)
    for arch in ("qwen3-moe-235b-a22b", "whisper-small"):
        assert build_model(get_config(arch), device="cpu").cfg.family in (
            "moe", "encdec")


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked-suffix", "per-token-suffix"])
def test_recurrent_resume_matches_jax_either_suffix_path(family_model,
                                                         chunked):
    """A resumed hybrid session replays its suffix in one
    ``decode_chunk_recurrent`` pass (``chunked_recurrent_suffix``, the
    default) or token by token through ``decode_step``; both decode the
    JAX engine's tokens under the same setting."""
    from repro.config import ServingConfig as JServingConfig
    from repro.serving.engine import TierEngine as JTierEngine
    from repro_torch.config import ServingConfig
    from repro_torch.serving.engine import TierEngine

    cfg, jp = family_model("hybrid")
    tm = build_model(reduced_config(cfg.name).replace(dtype="float32"),
                     device="cpu")
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    kw = dict(max_batch=2, max_seq=96, session_cache_mb=16.0,
              chunked_recurrent_suffix=chunked)
    rng = np.random.default_rng(5)
    base = rng.integers(4, 200, 30).astype(np.int32)
    ext = rng.integers(4, 200, 9).astype(np.int32)
    got = {}
    for name, eng in (("jax", JTierEngine(j_build(cfg), jp,
                                          JServingConfig(**kw), eos_id=-1)),
                      ("port", TierEngine(tm, tp, ServingConfig(**kw),
                                          eos_id=-1))):
        eng.submit(0, base, max_new=6, session="s")
        gen = {s.rid: list(s.generated) for s in eng.run_until_drained()}[0]
        hist = np.concatenate([base, np.asarray(gen, np.int32), ext])
        eng.submit(1, hist, max_new=6, session="s")
        got[name] = {s.rid: list(s.generated)
                     for s in eng.run_until_drained()}
        assert eng.resumed_sessions == 1
    assert got["port"] == got["jax"]
