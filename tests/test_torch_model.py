"""The port's DecoderLM against the JAX package's, in float32 with the same
(converted) weights: prefill logits and cache (JAX ``auto`` against port
``auto``, and JAX ``pallas`` against port ``torch``, the flash-attention
kernel's plain version), then decode steps on the dense and the paged
cache, with and without the context hint."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-4, atol=1e-4)
CAP = 64
PAGE = 16


#: prefill attention impls (JAX, port) that compute the same function: the
#: default dispatchers, and the Pallas flash-attention kernel against the
#: port's plain version of its CUDA kernel
IMPLS = {"auto": ("auto", "auto"), "pallas": ("pallas", "torch")}


@pytest.fixture(scope="module", params=[
    ("qwen2-vl-2b", "auto"), ("qwen3-0.6b", "auto"),
    ("qwen2-vl-2b", "pallas"), ("qwen3-0.6b", "pallas")],
    ids=lambda p: p[0] if p[1] == "auto" else f"{p[0]}-pallas-torch")
def pair(request):
    name, impl = request.param
    j_impl, t_impl = IMPLS[impl]
    jm = j_build(j_reduced(name).replace(dtype="float32"), attn_impl=j_impl)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(reduced_config(name).replace(dtype="float32"),
                     attn_impl=t_impl, device="cpu")
    return jm, jp, tm, params_from_numpy(jp, "cpu")


def _prompt(cfg, rng, b=2, s=11):
    batch = {"tokens": rng.integers(4, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return batch


def _to_paged(cache, rng):
    """Dense (L,B,T,K,hd) KV -> a shuffled (L,P,page,K,hd) pool + page
    table; page 0 is the null page (garbage, masked via pos)."""
    k = np.asarray(cache["blocks"]["k"])
    n_layers, b, t, kh, hd = k.shape
    n_pt = t // PAGE
    perm = (rng.permutation(b * n_pt) + 1).reshape(b, n_pt).astype(np.int32)
    out = {"pos": np.asarray(cache["pos"]),
           "index": np.asarray(cache["index"]), "pages": perm, "blocks": {}}
    for name in ("k", "v"):
        leaf = np.asarray(cache["blocks"][name])
        pool = rng.standard_normal((n_layers, b * n_pt + 1, PAGE, kh, hd)
                                   ).astype(np.float32)
        rows = leaf.reshape(n_layers, b, n_pt, PAGE, kh, hd)
        pool[:, perm] = rows
        out["blocks"][name] = pool
    return out


def test_prefill_logits_and_cache(pair):
    # S = 19 (vlm: 8 patches + 11 tokens) or 11: the Pallas kernel takes
    # any S up to 128
    jm, jp, tm, tp = pair
    batch = _prompt(tm.cfg, np.random.default_rng(0))
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, CAP)
    tl, tc = tm.prefill(tp, {k: torch.as_tensor(v) for k, v in batch.items()},
                        CAP)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   np.asarray(jc["blocks"][name]), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))


def test_prefill_with_lengths_gathers_true_last_token(pair):
    jm, jp, tm, tp = pair
    batch = _prompt(tm.cfg, np.random.default_rng(1), s=16)
    batch["lengths"] = np.asarray([16, 9], np.int32)
    jl, _ = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, CAP)
    tl, _ = tm.prefill(tp, {k: torch.as_tensor(v) for k, v in batch.items()},
                       CAP)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("ctx", [None, 48])
def test_decode_steps_match(pair, paged, ctx):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(2)
    batch = _prompt(tm.cfg, rng)
    _, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, CAP)
    cache = jax.device_get(jc)
    if paged:
        cache = _to_paged(cache, rng)
    jcache = jax.tree.map(jnp.asarray, cache)
    tcache = cache_from_numpy(cache, "cpu")
    start = int(np.asarray(cache["index"])[0])
    for step in range(3):
        tok = rng.integers(4, tm.cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), start + step, np.int32)
        jl, jcache = jm.decode_step(
            jp, jcache, {"tokens": jnp.asarray(tok),
                         "positions": jnp.asarray(pos)}, ctx=ctx)
        tl, tcache = tm.decode_step(
            tp, tcache, {"tokens": torch.as_tensor(tok),
                         "positions": torch.as_tensor(pos)}, ctx=ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    np.testing.assert_array_equal(tcache["index"].numpy(),
                                  np.asarray(jcache["index"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache["blocks"][name].numpy(),
                                   np.asarray(jcache["blocks"][name]), **TOL)


def test_out_of_vocab_ids_embed_as_nan_like_jnp_take(pair):
    _, _, tm, tp = pair
    from repro_torch.models.layers import embed

    table = tp["embed"]
    v = table.shape[0]
    out = embed(torch.tensor([[1, v, -1, -v - 1]]), table)
    assert torch.equal(out[0, 0], table[1])
    assert torch.equal(out[0, 2], table[-1])
    assert torch.isnan(out[0, 1]).all() and torch.isnan(out[0, 3]).all()


def test_build_model_refuses_unported_family():
    """Every family of the zoo is ported; a family outside it is refused."""
    from repro_torch.configs import ALL_ARCHS, get_config

    for arch in ALL_ARCHS:
        assert build_model(get_config(arch), device="cpu").cfg.name == arch
    with pytest.raises(NotImplementedError, match="not a family"):
        build_model(get_config("qwen3-0.6b").replace(family="rwkv"),
                    device="cpu")


def test_build_model_validates_attn_impl(pair):
    cfg = pair[2].cfg
    with pytest.raises(ValueError, match="pallas"):
        build_model(cfg, attn_impl="pallas", device="cpu")  # JAX spelling
    for impl in ("auto", "dense", "flash", "local", "cuda", "torch"):
        assert build_model(cfg, attn_impl=impl, device="cpu").attn_impl == impl
