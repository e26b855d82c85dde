"""The MoE family (``moe``: Qwen3-MoE, Kimi-K2) against the JAX package in
float32 with the same numpy inputs and converted weights
(``build_model(cfg).init(PRNGKey(i))`` through ``repro_torch.convert``):

* the MoE layer under ``dense``, ``dropping`` (with headroom, and under
  overflow, where tokens drop) and ``decode2d``: y and the aux loss within
  1e-5;
* the router's tie rule: among equal probabilities the lower expert index
  wins, as ``jax.lax.top_k`` orders them;
* ``DecoderLM`` prefill logits and every cache leaf, decode steps and
  ``decode_chunk`` for reduced qwen3-moe and kimi-k2 (one dense layer, a
  shared expert) within 1e-4, under ``moe_impl`` auto and dropping;
* the parameter trees and counts: the port's specs are the JAX package's
  leaf for leaf, and ``count_params``/``count_active_params`` agree;
* the serving engine decodes the JAX engine's tokens at temperature 0,
  paged and dense, fused (8 steps) and per token, each request prefilled
  in its own group.

Routing. f32 router logits can differ by an ulp between the packages, so a
token whose k-th and (k+1)-th router probabilities lie within ``MARGIN`` of
each other may pick another expert in each. The layer tests compare only
the tokens that clear the margin (on the dropping path, one token's choice
moves which others drop, so its output is compared only when every token
clears it) and require most tokens to clear it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ServingConfig as JServingConfig  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import counting as jcounting  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.engine import TierEngine as JTierEngine  # noqa: E402
from repro_torch.config import ServingConfig  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import counting as tcounting  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.spec import iter_specs  # noqa: E402
from repro_torch.serving.engine import TierEngine  # noqa: E402

LTOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
#: the router-probability gap between the k-th and (k+1)-th expert that a
#: token must clear for its expert choice to be compared across packages
MARGIN = 1e-6
ARCHS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")


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


@pytest.fixture(scope="module")
def moe_models():
    """``(arch, seed) -> (jax cfg, jax model, jax params, port model, port
    params)`` in float32."""
    cache = {}

    def get(arch, seed=0, **kw):
        key = (arch, seed, tuple(sorted(kw.items())))
        if key not in cache:
            cfg = j_reduced(arch).replace(dtype="float32", **kw)
            jm = j_build(cfg)
            jp = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
            tcfg = reduced_config(arch).replace(dtype="float32", **kw)
            cache[key] = (cfg, jm, jp, tcfg, params_from_numpy(jp, "cpu"))
        return cache[key]

    return get


def _layer0(tree):
    return {k: (_layer0(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


def _margins(probs, k):
    top = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    return top[:, k - 1] - top[:, k]


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,cf", [
    ("dense", 1.25), ("dropping", 8.0), ("dropping", 0.25),
    ("decode2d", 1.25)], ids=["dense", "dropping-headroom",
                              "dropping-overflow", "decode2d"])
def test_moe_layer_matches_jax(arch, impl, cf, moe_models):
    cfg, _, jp, tcfg, tp = moe_models(arch, seed=1, capacity_factor=cf)
    jl, tl = _layer0(jp["blocks"]["moe"]), _layer0(tp["blocks"]["moe"])
    x = np.random.default_rng(3).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    yj, auxj = jmoe.moe_forward(jl, jnp.asarray(x), cfg, None, impl)
    yt, auxt = tmoe.moe_forward(tl, _t(x), tcfg, impl)
    _, _, probs = jmoe._router_topk(jnp.asarray(x.reshape(-1, cfg.d_model)),
                                    jl["router"], cfg.top_k)
    ok = _margins(probs, cfg.top_k) > MARGIN
    assert ok.mean() > 0.9, f"only {ok.mean():.0%} of tokens clear {MARGIN}"
    ids_j, _, _ = jmoe._router_topk(jnp.asarray(x.reshape(-1, cfg.d_model)),
                                    jl["router"], cfg.top_k)
    ids_t, _, _ = tmoe._router_topk(_t(x.reshape(-1, cfg.d_model)),
                                    tl["router"], cfg.top_k)
    np.testing.assert_array_equal(ids_t.numpy()[ok], np.asarray(ids_j)[ok])
    if impl == "dense" or ok.all():
        _close(yt.reshape(-1, cfg.d_model)[torch.as_tensor(ok)],
               np.asarray(yj).reshape(-1, cfg.d_model)[ok], LTOL)
    if ok.all():
        _close(auxt, auxj, LTOL)
    if cf < 1.0:  # capacity pressure: tokens dropped, outputs still finite
        yd, _ = tmoe.moe_dense_forward(tl, _t(x), tcfg)
        assert torch.isfinite(yt).all()
        assert float((yt - yd).abs().max()) > 1e-3


def test_router_ties_pick_the_lower_index_first(moe_models):
    """Exact ties: ``topk_lower_index_first`` orders as ``jax.lax.top_k``,
    and a zero router (every probability 1/E) routes every token to
    experts 0..k-1 with weights 1/k in both packages."""
    vals = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0],
                     [0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                     [2.0, 1.0, 2.0, 1.0, 2.0, 2.0]], np.float32)
    for k in (1, 2, 3, 4):
        wj, ij = jax.lax.top_k(jnp.asarray(vals), k)
        wt, it = tmoe.topk_lower_index_first(_t(vals), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    cfg, _, jp, tcfg, tp = moe_models("qwen3-moe-235b-a22b")
    jl, tl = _layer0(jp["blocks"]["moe"]), _layer0(tp["blocks"]["moe"])
    jl["router"] = np.zeros_like(jl["router"])
    tl["router"] = torch.zeros_like(tl["router"])
    x = np.random.default_rng(4).standard_normal(
        (1, 8, cfg.d_model)).astype(np.float32)
    ids, w, _ = tmoe._router_topk(_t(x[0]), tl["router"], cfg.top_k)
    assert (ids == torch.arange(cfg.top_k)).all()
    assert torch.allclose(w, torch.full_like(w, 1.0 / cfg.top_k))
    for impl in ("dense", "dropping"):
        yj, auxj = jmoe.moe_forward(jl, jnp.asarray(x), cfg, None, impl)
        yt, auxt = tmoe.moe_forward(tl, _t(x), tcfg, impl)
        _close(yt, yj, LTOL)
        _close(auxt, auxj, LTOL)


def test_moe_impl_is_validated():
    cfg = reduced_config("qwen3-moe-235b-a22b")
    with pytest.raises(ValueError, match="moe_impl"):
        build_model(cfg, moe_impl="sharded", device="cpu")
    for impl in tmoe.MOE_IMPLS:
        assert build_model(cfg, moe_impl=impl, device="cpu").moe_impl == impl


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _prompt(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        4, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("moe_impl", ["auto", "dropping"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode_match_jax(arch, moe_impl, moe_models):
    cfg, _, jp, tcfg, tp = moe_models(arch, seed=2)
    jm = j_build(cfg, moe_impl=moe_impl)
    tm = build_model(tcfg, moe_impl=moe_impl, device="cpu")
    toks = _prompt(cfg, 2, 13, 5)
    lengths = np.array([13, 9], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lengths)}, 32)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks), "lengths": _t(lengths)}, 32)
    _close(tl, jl, TOL)
    _close_tree(tc, jax.device_get(jc), TOL)
    if cfg.first_k_dense:
        assert set(tc) == {"dense_blocks", "blocks", "pos", "index"}
    # continue both from the JAX cache: three decode steps
    tc = {k: (_t(v) if not isinstance(v, dict) else
              {n: _t(x) for n, x in v.items()})
          for k, v in jax.device_get(jc).items()}
    for step in range(3):
        batch = {"tokens": _prompt(cfg, 2, 1, 10 + step),
                 "positions": np.array([13 + step, 13 + step], np.int32)}
        jl, jc = jm.decode_step(jp, jc, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        tl, tc = tm.decode_step(tp, tc, {k: _t(v) for k, v in batch.items()})
        _close(tl, jl, TOL)
    _close_tree(tc, jax.device_get(jc), TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_chunk_matches_jax(arch, moe_models):
    """The warm suffix pass (``decode_chunk``) over a cached prefix, with
    every position's logits."""
    cfg, jm, jp, tcfg, tp = moe_models(arch, seed=2)
    tm = build_model(tcfg, device="cpu")
    toks = _prompt(cfg, 1, 11, 6)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 48)
    tc = {k: (_t(v) if not isinstance(v, dict) else
              {n: _t(x) for n, x in v.items()})
          for k, v in jax.device_get(jc).items()}
    suffix = _prompt(cfg, 1, 7, 7)
    pos = (11 + np.arange(7, dtype=np.int32))[None]
    jl, jc = jm.decode_chunk(jp, jc, {"tokens": jnp.asarray(suffix),
                                      "positions": jnp.asarray(pos)},
                             all_logits=True)
    tl, tc = tm.decode_chunk(tp, tc, {"tokens": _t(suffix),
                                      "positions": _t(pos)}, all_logits=True)
    _close(tl, jl, TOL)
    _close_tree(tc, jax.device_get(jc), TOL)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS + ("whisper-small",))
def test_param_trees_and_counts_match_jax(arch, reduced):
    """The spec trees carry across leaf for leaf (names, shapes: router,
    wi/wg/wo, shared_*, dense_blocks; encdec's proj_in, enc_pos, enc/dec
    blocks with LayerNorm biases, the tied embed), and the analytic counts
    agree."""
    from repro.configs import get_config as j_get

    cfg = (j_reduced if reduced else j_get)(arch)
    tcfg = (reduced_config if reduced else get_config)(arch)
    jshapes = jax.tree_util.tree_leaves_with_path(
        j_build(cfg).param_shapes())
    want = {tuple(p.key for p in path): tuple(s.shape)
            for path, s in jshapes}
    got = {path: tuple(spec.shape) for path, spec in
           iter_specs(build_model(tcfg, device="cpu").specs())}
    assert got == want
    assert tcounting.count_params(tcfg) == jcounting.count_params(cfg)
    assert (tcounting.count_active_params(tcfg)
            == jcounting.count_active_params(cfg))
    assert (tcounting.embedding_params(tcfg)
            == jcounting.embedding_params(cfg))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [1, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_moe_engine_matches_jax_tokens(paged, fused, moe_models):
    cfg, jm, jp, tcfg, tp = moe_models("qwen3-moe-235b-a22b")
    tm = build_model(tcfg, device="cpu")
    sv = dict(max_batch=3, max_seq=64, paged=paged, fused_steps=fused,
              **({"kv_page_size": 16} if paged else {}))
    prompts = [_prompt(cfg, 1, n, 20 + n)[0] for n in (5, 9, 9, 17)]
    out, groups = [], []
    for eng in (JTierEngine(jm, jp, JServingConfig(**sv), eos_id=-1),
                TierEngine(tm, tp, ServingConfig(**sv), eos_id=-1)):
        if isinstance(eng, TierEngine):
            admit = eng._admit_group
            eng._admit_group = lambda jobs, slots, bucket: (
                groups.append(len(jobs)), admit(jobs, slots, bucket))
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, max_new=10)
        out.append({s.rid: s.generated for s in eng.run_until_drained()})
    assert out[1] == out[0]
    if fused > 1:  # bucketed admission: one prefill group per request
        assert groups and set(groups) == {1}


@pytest.mark.parametrize("cf", [8.0, 0.25], ids=["headroom", "overflow"])
def test_combine_gathers_what_jax_scatters(cf):
    """The dropping combine (a gather through the slot plan's inverse,
    summed in slot order, no atomics) against JAX's scatter-add on the
    same plan and expert outputs, within 1e-5; dropped assignments (under
    overflow) add nothing. Two calls are bitwise equal."""
    rng = np.random.default_rng(7)
    t, k, e = 24, 2, 8
    ids = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    w = rng.random((t, k)).astype(np.float32)
    cap = max(1, int(t * k / e * cf))
    plan = tmoe._dispatch_plan(torch.as_tensor(ids), torch.as_tensor(w), 0,
                               e, cap)
    slot_src, slot_w, slot_valid, tok_slot = plan
    y_buf = rng.standard_normal((e, cap, 16)).astype(np.float32)
    y_buf *= slot_valid.numpy().reshape(e, cap, 1)  # empty slots compute 0
    got = tmoe._combine_gather(torch.as_tensor(y_buf), tok_slot, slot_w)
    js, jw, jv = jmoe._dispatch_plan(jnp.asarray(ids), jnp.asarray(w), 0, e,
                                     cap)
    np.testing.assert_array_equal(slot_src.numpy(), np.asarray(js))
    want = jmoe._combine_scatter(jnp.asarray(y_buf), js, jw, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert torch.equal(got, tmoe._combine_gather(torch.as_tensor(y_buf),
                                                 tok_slot, slot_w))
    kept = (tok_slot < e * cap).sum().item()
    assert kept == int(slot_valid.sum()) and (kept < t * k) == (cf < 1)
