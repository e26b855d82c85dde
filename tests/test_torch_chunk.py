"""The port's ``DecoderLM.decode_chunk`` (the suffix prefill of a warm
admission) against the JAX package's, in float32 with the same (converted)
weights and the same prefilled cache: every position's logits and the
last-real-token logits of right-padded rows, with and without the context
hint, and the cache it leaves (``pos``, ``index``, the new KV rows). JAX
runs ``attn_impl="auto"`` (its ``"pallas"`` chunk path reads the wrong rows
and is not a reference); the port runs ``"auto"`` and ``"torch"``, whose
chunk path must take the position-aware route all the same."""
import copy

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

TOL = dict(rtol=1e-4, atol=1e-4)
CAP = 64
CHUNK = 8


@pytest.fixture(scope="module", params=["qwen2-vl-2b", "qwen3-0.6b"])
def pair(request):
    jm = j_build(j_reduced(request.param).replace(dtype="float32"))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tms = {impl: build_model(reduced_config(request.param).replace(
        dtype="float32"), attn_impl=impl, device="cpu")
        for impl in ("auto", "torch")}
    return jm, jp, tms, params_from_numpy(jp, "cpu")


def _prefilled(jm, jp, rng):
    """Two rows prefilled as a right-padded bucket (lengths 13 and 7, with
    patches on the vlm), pad entries re-masked as the engine does."""
    cfg = jm.cfg
    lengths = np.asarray([13, 7], np.int32)
    batch = {"tokens": rng.integers(4, cfg.vocab_size, (2, 16)).astype(
        np.int32), "lengths": lengths}
    prefix = 0
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        prefix = cfg.num_patches
    _, cache = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          CAP)
    cache = jax.device_get(cache)
    total = lengths + prefix
    cache["pos"] = np.where(cache["pos"] < total[:, None], cache["pos"], -1)
    cache["index"] = (total % CAP).astype(np.int32)
    return cache, total


def _chunk(cfg, total, rng, padded):
    """CHUNK new tokens per row at absolute positions after each row's
    prefix; with ``padded`` row 1 holds 5 real tokens and 3 pads."""
    batch = {"tokens": rng.integers(4, cfg.vocab_size, (2, CHUNK)).astype(
        np.int32),
        "positions": (total[:, None] + np.arange(CHUNK)[None]).astype(
            np.int32)}
    if padded:
        batch["lengths"] = np.asarray([CHUNK, 5], np.int32)
    return batch


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("ctx", [None, 48], ids=["full", "ctx48"])
@pytest.mark.parametrize("mode", ["all_logits", "lengths"])
def test_decode_chunk_matches_jax(pair, impl, ctx, mode):
    jm, jp, tms, tp = pair
    tm = tms[impl]
    rng = np.random.default_rng(1)
    jcache, total = _prefilled(jm, jp, rng)
    batch = _chunk(jm.cfg, total, rng, padded=(mode == "lengths"))
    tcache = cache_from_numpy(copy.deepcopy(jcache), "cpu")
    kw = dict(ctx=ctx, all_logits=(mode == "all_logits"))
    jl, jc = jm.decode_chunk(jp, jax.tree.map(jnp.asarray, jcache),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             **kw)
    tl, tc = tm.decode_chunk(tp, tcache, {k: torch.as_tensor(v) for k, v in
                                          batch.items()}, **kw)
    want_shape = ((2, CHUNK, jm.cfg.vocab_size) if kw["all_logits"]
                  else (2, jm.cfg.vocab_size))
    assert tuple(tl.shape) == want_shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jc = jax.device_get(jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
    np.testing.assert_array_equal(tc["index"].numpy(), jc["index"])
    np.testing.assert_array_equal(tc["index"].numpy(),
                                  (total + CHUNK) % CAP)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   jc["blocks"][name], rtol=1e-5, atol=1e-5)
    # the new rows landed linearly after each row's prefix
    for r in range(2):
        np.testing.assert_array_equal(
            tc["pos"][r, total[r]:total[r] + CHUNK].numpy(),
            batch["positions"][r])


def test_decode_chunk_of_one_token_is_a_decode_step(pair):
    """A one-token chunk is a decode step: same logits, same cache."""
    jm, jp, tms, tp = pair
    tm = tms["auto"]
    rng = np.random.default_rng(2)
    jcache, total = _prefilled(jm, jp, rng)
    tok = rng.integers(4, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
    c1 = cache_from_numpy(copy.deepcopy(jcache), "cpu")
    c2 = cache_from_numpy(copy.deepcopy(jcache), "cpu")
    l1, c1 = tm.decode_chunk(tp, c1, {
        "tokens": torch.as_tensor(tok),
        "positions": torch.as_tensor(total[:, None].astype(np.int32))})
    l2, c2 = tm.decode_step(tp, c2, {
        "tokens": torch.as_tensor(tok),
        "positions": torch.as_tensor(total.astype(np.int32))})
    torch.testing.assert_close(l1, l2, rtol=1e-5, atol=1e-5)
    assert torch.equal(c1["pos"], c2["pos"])
    assert torch.equal(c1["index"], c2["index"])
    torch.testing.assert_close(c1["blocks"]["k"], c2["blocks"]["k"],
                               rtol=1e-5, atol=1e-5)


def test_decode_chunk_refuses_recurrent_families(pair):
    _, _, tms, tp = pair
    m = copy.copy(tms["auto"])
    m.cfg = m.cfg.replace(family="ssm")
    with pytest.raises(AssertionError, match="positionally addressable KV"):
        m.decode_chunk(tp, {}, {"tokens": torch.zeros((1, 2), dtype=torch.int32)})
