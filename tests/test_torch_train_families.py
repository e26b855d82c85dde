"""Training of every family against the JAX package, in float32 on the CPU
with the same numpy inputs and converted weights (``build_model(cfg).init(
PRNGKey(0))`` through ``repro_torch.convert``):

* ``loss`` (ce + router_aux_coef * aux) and the gradient of every
  parameter leaf against ``jax.value_and_grad(model.loss)``, for the
  reduced dense, vlm (with vision patches: the image prefix takes no
  loss), moe (qwen3-moe under ``moe_impl`` auto and dropping, kimi-k2 for
  its dense first layer and shared expert), ssm, hybrid and encdec models.
  Tolerances: the loss and aux within 1e-5 relative; each gradient leaf
  within 1e-4 of the leaf's largest JAX entry (f32 reduction order through
  a few layers; the runs here differ by at most ~6e-6);
* ``chunked_ce`` (the chunk rule, the mask, each chunk recomputed in the
  backward pass) against ``DecoderLM._chunked_ce`` and its gradients;
* the three remat policies give the same loss and gradients (bitwise on
  the CPU: recomputation repeats the same arithmetic);
* "train" mode gathers no cache, and a loss under the attention kernel
  ("cuda") or its CPU stand-in ("torch") raises.

MoE routing: f32 router logits may differ by an ulp between the packages;
a token whose k-th and (k+1)-th router probabilities tie that closely
could pick another expert in each, which would show here as an aux loss
and gradient mismatch (``tests/test_torch_moe.py`` holds the router's tie
rule)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro_torch.checkpoint.checkpointer import \
    tree_flatten_with_path  # noqa: E402
from repro_torch.config import ShardingConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import chunked_ce  # noqa: E402
from repro_torch.training.train_loop import loss_and_grads  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the leaf's largest JAX entry
# family -> arch as tests/conftest.py's FAMILY_ARCHS, plus the second moe
# arch and the encdec family
EXTRA_ARCHS = {"kimi": "kimi-k2-1t-a32b", "encdec": "whisper-small"}


def _jax_model(family, family_model):
    """(jax cfg, jax params) of a family, the session cache where the
    conftest has the family."""
    if family in EXTRA_ARCHS:
        cfg = j_reduced(EXTRA_ARCHS[family]).replace(dtype="float32")
        return cfg, j_build(cfg).init(jax.random.PRNGKey(0))
    return family_model(family)


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(4, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
    return out


def _port(cfg, jp, **kw):
    tcfg = reduced_config(cfg.name).replace(dtype="float32")
    return (build_model(tcfg, device="cpu", **kw),
            params_from_numpy(jax.device_get(jp), device="cpu"))


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _named(tree):
    return {".".join(p): x for p, x in tree_flatten_with_path(tree)}


def _hold_grads(tg, jg):
    got, want = _named(tg), _named(jax.device_get(jg))
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


CASES = [("dense", "auto"), ("vlm", "auto"), ("moe", "auto"),
         ("moe", "dropping"), ("kimi", "auto"), ("ssm", "auto"),
         ("hybrid", "auto"), ("encdec", "auto")]


@pytest.mark.parametrize("family,moe_impl", CASES,
                         ids=[f"{f}-{m}" if m != "auto" else f
                              for f, m in CASES])
def test_loss_and_gradients_match_jax(family, moe_impl, family_model):
    cfg, jp = _jax_model(family, family_model)
    batch = _batch(cfg)
    kw = {"moe_impl": moe_impl} if cfg.family == "moe" else {}
    jm = j_build(cfg, **kw)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm, tp = _port(cfg, jp, **kw)
    tl, tmet, tg = loss_and_grads(tm, tp, _tensors(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if cfg.family == "moe":
        assert float(tmet["aux"]) > 0
    _hold_grads(tg, jg)


def test_loss_mask_matches_jax(family_model):
    """A caller's ``loss_mask`` (here zeroing a third of the text) on the
    vlm model, whose image prefix is masked as well."""
    cfg, jp = _jax_model("vlm", family_model)
    batch = _batch(cfg, seed=2)
    batch["loss_mask"] = (np.arange(24)[None] % 3 != 0).repeat(
        2, 0).astype(np.float32)
    jm = j_build(cfg)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm, tp = _port(cfg, jp)
    tl, _, tg = loss_and_grads(tm, tp, _tensors(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _hold_grads(tg, jg)


@pytest.mark.parametrize("s", [64, 256, 384, 1024])
def test_chunked_ce_matches_jax(s):
    """S=64 is one chunk (fewer than 128 rows), 256 two, 384 two, 1024
    eight; a quarter of the positions are masked."""
    rng = np.random.default_rng(s)
    b, d, v = 2, 16, 40
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.25).astype(np.float32)

    class Cfg:
        vocab_size = v

    class Stub:  # the attributes ``_chunked_ce`` reads
        cfg = Cfg()
        mesh = None

        def _constrain(self, x, axes):
            return x

    jfn = lambda h, t: JDecoderLM._chunked_ce(Stub(), h, t,
                                               jnp.asarray(labels),
                                               jnp.asarray(mask))
    jl, (jgh, jgt) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(table))
    h = torch.tensor(hidden, requires_grad=True)
    t = torch.tensor(table, requires_grad=True)
    tl = chunked_ce(h, t, torch.as_tensor(labels), torch.as_tensor(mask))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgt), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("family", ["vlm", "moe", "ssm", "hybrid",
                                    "encdec"])
def test_remat_policies_give_equal_gradients(family, family_model):
    cfg, jp = _jax_model(family, family_model)
    batch = _tensors(_batch(cfg, seed=1))
    out = {}
    for policy in ("none", "dots", "full"):
        tm, tp = _port(cfg, jp, sharding=ShardingConfig(remat_policy=policy))
        out[policy] = loss_and_grads(tm, tp, batch)
    for policy in ("dots", "full"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        for name, g in _named(out[policy][2]).items():
            assert torch.equal(g, _named(out["none"][2])[name]), (policy,
                                                                  name)


@pytest.mark.parametrize("family", ["vlm", "moe", "ssm", "hybrid"])
def test_train_mode_gathers_no_cache(family, family_model):
    cfg, jp = _jax_model(family, family_model)
    tm, tp = _port(cfg, jp)
    _, _, caches, prefix = tm.forward(tp, _tensors(_batch(cfg)), "train")
    assert caches == {}
    assert prefix == (cfg.num_patches if family == "vlm" else 0)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_loss_refuses_the_attention_kernel(family, impl, family_model):
    """The kernel has no backward: its output carries no gradient, so a
    loss through it would train every attention layer's q/k/v projections
    with zeros. "torch" (the kernel's CPU stand-in) is refused alike."""
    cfg, jp = _jax_model(family, family_model)
    tm, tp = _port(cfg, jp, attn_impl=impl)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        tm.loss(tp, _tensors(_batch(cfg)))
