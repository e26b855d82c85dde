"""The optimizer, the train step and the trainer against the JAX package,
in float32 on the CPU from the same converted weights
(``build_model(cfg).init(PRNGKey(0))`` through ``repro_torch.convert``):

* ``lr_schedule`` at every step of a warmup + cosine run (1e-6);
* ``adamw_update`` on random trees over 5 steps with clipping active:
  parameters, both moments, the step, grad_norm and lr within 1e-6;
* one ``make_train_step`` on tiny-dense at accum 1 and 2: loss and
  grad_norm within 1e-4 relative; parameters at rtol 1e-3 / atol 1e-4
  (step-1 Adam moves every entry by about lr * sign(g), so f32 noise in an
  eps-sized gradient entry shows up as a few percent of one update; atol is
  a tenth of lr = 1e-3, tight enough for any scaling bug);
* 12 ``Trainer`` steps of both packages from the same weights: the loss
  history within 1e-4 relative;
* the port's own counterparts of ``tests/test_training.py``'s optimizer
  cases (convergence on a quadratic, clipping reported before the clip).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as j_get  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import adamw_update as j_adamw  # noqa: E402
from repro.training import init_opt_state as j_init_opt  # noqa: E402
from repro.training import lr_schedule as j_lr  # noqa: E402
from repro.training import make_train_step as j_step  # noqa: E402
from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (Trainer, adamw_update,  # noqa: E402
                                  init_opt_state, lr_schedule,
                                  make_train_step)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _close_tree(got, want, **tol):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_lr_schedule_matches_jax_at_every_step():
    for warmup, total in ((10, 60), (0, 20), (5, 5)):
        jc = JOptimizerConfig(lr=3e-4, warmup_steps=warmup,
                              total_steps=total)
        tc = OptimizerConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
        for s in range(total + 10):
            np.testing.assert_allclose(
                float(lr_schedule(tc, torch.tensor(s, dtype=torch.int32))),
                float(j_lr(jc, jnp.asarray(s, jnp.int32))), rtol=1e-6)
            assert float(lr_schedule(tc, s)) > 0


def test_adamw_update_matches_jax_with_clipping():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}, "e": ()}
    mk = lambda scale: jax.tree.map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, grad_clip=0.5,
              weight_decay=0.1)
    jc, tc = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    jp = mk(1.0)
    tp = params_from_numpy(jp, "cpu")
    jst, tst = j_init_opt(jp, jc), init_opt_state(tp, tc)
    for i in range(5):
        g = mk(3.0)  # global norm ~10 against a clip of 0.5
        jp, jst, jm = j_adamw(jp, g, jst, jc)
        tp, tst, tm = adamw_update(tp, params_from_numpy(g, "cpu"), tst, tc)
        assert float(jm["grad_norm"]) > jc.grad_clip
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert int(tst.step) == int(jst.step) == i + 1
        assert tst.step.dtype == torch.int32
        for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
            _close_tree(got, want, rtol=1e-6, atol=1e-9)


def test_adamw_update_in_slices_changes_no_result(monkeypatch):
    """A leaf walked in flat slices (as a multi-GB stacked leaf is) gets
    the update of the whole leaf at once, bitwise (no clipping here: the
    norm's sums run in another order when sliced)."""
    from repro_torch.training import optimizer

    gen = torch.Generator().manual_seed(0)
    rand = lambda: {"a": torch.randn(50, 7, generator=gen),
                    "b": {"c": torch.randn(33, generator=gen)}}
    p, g = rand(), rand()
    cfg = OptimizerConfig(warmup_steps=0, grad_clip=1e9)
    out = []
    for chunk in (optimizer.CHUNK, 16):
        monkeypatch.setattr(optimizer, "CHUNK", chunk)
        pc = {"a": p["a"].clone(), "b": {"c": p["b"]["c"].clone()}}
        st = init_opt_state(pc, cfg)
        for _ in range(3):
            pc, st, _ = adamw_update(pc, g, st, cfg)
        out.append(tree_leaves(pc) + tree_leaves(st.m) + tree_leaves(st.v))
    for whole, sliced in zip(*out):
        assert torch.equal(whole, sliced)


def test_init_opt_state_honours_state_dtype():
    params = {"w": torch.zeros(3, 2), "b": {"c": torch.ones(4)}}
    st = init_opt_state(params, OptimizerConfig(state_dtype="bfloat16"))
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for leaf in tree_leaves(st.m) + tree_leaves(st.v):
        assert leaf.dtype == torch.bfloat16 and not leaf.any()


def test_adamw_converges_quadratic():
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=100,
                          weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params, cfg)
    for _ in range(150):
        params, state, _ = adamw_update(params, {"w": 2 * params["w"]},
                                        state, cfg)
    assert float(params["w"].abs().max()) < 0.2


def test_grad_clip_reported_before_clipping():
    cfg = OptimizerConfig(lr=1e-3, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    _, _, m = adamw_update(params, {"w": torch.full((3,), 1e6)},
                           init_opt_state(params, cfg), cfg)
    assert float(m["grad_norm"]) > 1e5


@pytest.fixture(scope="module")
def tiny():
    """(jax model, jax params (numpy), port model, a (8, 32) batch)."""
    cfg = j_get("tiny-dense").replace(dtype="float32")
    jm = j_build(cfg)
    jp = _np_tree(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(get_config("tiny-dense").replace(dtype="float32"),
                     device="cpu")
    tok = np.random.default_rng(0).integers(4, cfg.vocab_size,
                                            (8, 33)).astype(np.int32)
    return jm, jp, tm, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum, tiny):
    jm, jp, tm, batch = tiny
    jc = JOptimizerConfig(lr=1e-3, warmup_steps=0)
    tc = OptimizerConfig(lr=1e-3, warmup_steps=0)
    jp1, jst, jmet = jax.jit(j_step(jm, jc, accum))(
        jp, j_init_opt(jp, jc), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(jp, "cpu")
    tp1, tst, tmet = make_train_step(tm, tc, accum)(
        tp, init_opt_state(tp, tc),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(tmet) == set(jmet)
    assert ("ce" in tmet) == (accum == 1)
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4)
    _close_tree(tp1, jp1, rtol=1e-3, atol=1e-4)
    _close_tree(tst.m, jst.m, rtol=1e-3, atol=1e-6)
    assert int(tst.step) == 1


def test_grad_accum_matches_full_batch(tiny):
    _, jp, tm, batch = tiny
    tc = OptimizerConfig(lr=1e-3, warmup_steps=0)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = {}
    for accum in (1, 4):
        tp = params_from_numpy(jp, "cpu")
        out[accum] = make_train_step(tm, tc, accum)(
            tp, init_opt_state(tp, tc), tb)
    (p1, _, m1), (p4, _, m4) = out[1], out[4]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m1[k]), float(m4[k]), rtol=1e-4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_trainer_history_matches_jax(tmp_path, tiny):
    """12 steps (warmup 2, cosine over 20), both trainers started from the
    same weights: the per-step loss history within 1e-4 relative."""
    _, jp, _, _ = tiny
    kw = dict(model="tiny-dense", batch_size=4, seq_len=32, steps=12,
              log_every=1, checkpoint_every=100)
    jt = JTrainer(JTrainConfig(checkpoint_dir=str(tmp_path / "jax"),
                               optimizer=JOptimizerConfig(
                                   lr=1e-3, warmup_steps=2, total_steps=20),
                               **kw))
    jt.params = jax.tree.map(jnp.asarray, jp)
    jt.opt_state = j_init_opt(jt.params, jt.cfg.optimizer)
    jh = jt.train()
    tt = Trainer(TrainConfig(checkpoint_dir=str(tmp_path / "port"),
                             optimizer=OptimizerConfig(
                                 lr=1e-3, warmup_steps=2, total_steps=20),
                             **kw), device="cpu")
    tt.params = params_from_numpy(jp, "cpu")
    tt.opt_state = init_opt_state(tt.params, tt.cfg.optimizer)
    th = tt.train()
    assert [s for s, _ in th] == [s for s, _ in jh] == list(range(1, 13))
    np.testing.assert_allclose([l for _, l in th], [l for _, l in jh],
                               rtol=1e-4)
    assert th[-1][1] < th[0][1]  # it learns


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--device", "cpu", "--model", "tiny-dense",
                       "--steps", "10", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"])
    out = capsys.readouterr().out
    assert "[trainer] step=10 loss=" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000005", "step_00000010"]
