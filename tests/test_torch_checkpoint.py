"""The port's checkpointer and trainer lifecycle, and checkpoints shared
with the JAX package:

* the port's counterparts of ``tests/test_training.py``'s checkpoint cases
  (dtypes round trip, keep-GC, async then wait, atomic re-save), a write
  error raised by the next ``wait()``, trainer resume, the deterministic
  data skip and a SIGTERM preemption save;
* cross-package restore both ways: a JAX ``Checkpointer`` directory of
  {"params": ..., "opt": OptState} (a bf16 leaf included) restores into the
  port with equal leaves, and the port's save of the same tree has the
  same file names, the same manifest and byte-identical ``.npy`` files; a
  port directory restores into JAX with equal leaves;
* a port trainer resuming a JAX trainer's step-6 checkpoint reaches the
  JAX trainer's uninterrupted step-12 parameters (rtol 1e-3 / atol 1e-4,
  the train step's tolerance in ``tests/test_torch_train.py``) and loss
  history (1e-4 relative)."""
import filecmp
import json
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.config import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import init_opt_state as j_init_opt  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt_mod  # noqa: E402
from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.training import Trainer, init_opt_state  # noqa: E402
from repro_torch.training.optimizer import OptState, tree_leaves  # noqa


@pytest.fixture()
def ckpt_dir(tmp_path):
    return str(tmp_path / "ckpt")


def _train_cfg(ckpt_dir, **kw):
    base = dict(model="tiny-dense", batch_size=4, seq_len=32, steps=12,
                log_every=6, checkpoint_every=6, checkpoint_dir=ckpt_dir,
                optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=50))
    base.update(kw)
    return TrainConfig(**base)


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_dtypes(ckpt_dir):
    ck = Checkpointer(ckpt_dir)
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16) * 1.5,
                  "d": torch.tensor(2.5)}}
    ck.save(3, tree, async_=False)
    step, out = ck.restore(tree)
    assert step == 3
    for x, y in zip(tree_leaves(tree), tree_leaves(out)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_gc_keeps_latest(ckpt_dir):
    ck = Checkpointer(ckpt_dir, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.zeros(2)}, async_=False)
    assert ck.list_steps() == [3, 4]


def test_checkpoint_async_snapshot_then_wait(ckpt_dir):
    """The async save copies the leaves at once: an in-place update after
    ``save`` returns does not reach the file."""
    ck = Checkpointer(ckpt_dir)
    x = torch.ones(128)
    ck.save(1, {"x": x}, async_=True)
    x.add_(1.0)
    ck.wait()
    assert ck.latest_step() == 1
    assert torch.equal(ck.restore({"x": x})[1]["x"], torch.ones(128))


def test_checkpoint_atomic_resave(ckpt_dir):
    ck = Checkpointer(ckpt_dir)
    ck.save(5, {"x": torch.zeros(4)}, async_=False)
    ck.save(5, {"x": torch.ones(4)}, async_=False)
    _, out = ck.restore({"x": torch.zeros(4)}, step=5)
    assert torch.equal(out["x"], torch.ones(4))
    assert os.listdir(ckpt_dir) == ["step_00000005"]


def test_checkpoint_write_error_raised_at_next_wait(ckpt_dir, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    ck = Checkpointer(ckpt_dir)
    monkeypatch.setattr(ckpt_mod.np, "save", broken)
    ck.save(1, {"x": torch.zeros(2)}, async_=True)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.list_steps() == []
    ck.wait()  # the error is raised once


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_trainer_resume_continues(ckpt_dir):
    t1 = Trainer(_train_cfg(ckpt_dir), device="cpu")
    t1.train()
    assert t1.step == 12
    t2 = Trainer(_train_cfg(ckpt_dir), device="cpu")
    t2.initialize()
    assert t2.step == 12
    assert isinstance(t2.opt_state, OptState)
    assert int(t2.opt_state.step) == 12
    for a, b in zip(tree_leaves(t1.params), tree_leaves(t2.params)):
        assert torch.equal(a, b)
    t2.train(steps=6)
    assert t2.step == 18


def test_trainer_deterministic_data_skip(ckpt_dir):
    cfg = _train_cfg(ckpt_dir, batch_size=2, seq_len=16)
    b2 = Trainer(cfg, device="cpu")._batch(2)
    b2_again = Trainer(cfg, device="cpu")._batch(2)
    assert torch.equal(b2["tokens"], b2_again["tokens"])
    assert torch.equal(b2["labels"], b2_again["labels"])


def test_trainer_preemption_saves_and_stops(ckpt_dir):
    """SIGTERM mid-run: the step in flight finishes, a blocking checkpoint
    of it is written, and the trainer stops."""
    t = Trainer(_train_cfg(ckpt_dir, checkpoint_every=100), device="cpu")
    step_fn = t._step_fn

    def step_then_sigterm(*a):
        out = step_fn(*a)
        if t.step == 2:  # the third step is in flight
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    t._step_fn = step_then_sigterm
    saved = signal.getsignal(signal.SIGTERM)
    try:
        t.train()
    finally:
        signal.signal(signal.SIGTERM, saved)
    assert t.step == 3
    assert t.ckpt.list_steps() == [3]


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _tiny_params():
    from repro.configs import get_config
    from repro.models import build_model

    cfg = get_config("tiny-dense").replace(dtype="float32")
    return jax.device_get(build_model(cfg).init(jax.random.PRNGKey(0)))


def _jax_tree():
    """{"params", "opt"} as the JAX trainer saves it, plus a bf16 leaf."""
    params = _tiny_params()
    params["extra_bf16"] = (np.arange(12, dtype=np.float32) * 0.37
                            ).astype(jnp.bfloat16).reshape(3, 4)
    params = jax.tree.map(jnp.asarray, params)
    opt = j_init_opt(params, JOptimizerConfig())
    rng = np.random.default_rng(1)
    fill = lambda x: jnp.asarray(rng.standard_normal(x.shape)).astype(
        x.dtype)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       m=jax.tree.map(fill, opt.m),
                       v=jax.tree.map(fill, opt.v))
    return {"params": params, "opt": opt}


def _port_tree(jtree):
    """The same tree as port tensors (bf16 leaves stay bf16)."""
    def leaf(x):
        x = np.array(x)
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(x))

    conv = lambda t: jax.tree.map(leaf, t)
    opt = jtree["opt"]
    return {"params": conv(jtree["params"]),
            "opt": OptState(conv(opt.step), conv(opt.m), conv(opt.v))}


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def test_jax_checkpoint_restores_in_the_port_and_layouts_match(tmp_path):
    jtree = _jax_tree()
    JCheckpointer(str(tmp_path / "jax")).save(7, jtree, async_=False)
    like = jax.tree.map(torch.zeros_like, _port_tree(jtree))
    step, out = Checkpointer(str(tmp_path / "jax")).restore(like)
    assert step == 7
    assert isinstance(out["opt"], OptState)
    assert out["params"]["extra_bf16"].dtype == torch.bfloat16
    assert out["opt"].step.dtype == torch.int32 and out["opt"].step.dim() == 0
    got, want = jax.tree.leaves(out), jax.tree.leaves(jtree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the port's save of the same tree: same files, manifest and bytes
    Checkpointer(str(tmp_path / "port")).save(7, _port_tree(jtree),
                                              async_=False)
    jd, td = tmp_path / "jax" / "step_00000007", tmp_path / "port" / \
        "step_00000007"
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    assert "params.extra_bf16.npy" in names and "opt.m.embed.npy" in names
    assert (json.loads((jd / "manifest.json").read_text())
            == json.loads((td / "manifest.json").read_text()))
    assert (jd / "manifest.json").read_bytes() == \
        (td / "manifest.json").read_bytes()
    _, mismatch, errors = filecmp.cmpfiles(jd, td, names, shallow=False)
    assert mismatch == [] and errors == []


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree = _jax_tree()
    ck = Checkpointer(str(tmp_path))
    ck.save(4, _port_tree(jtree), async_=True)
    ck.wait()
    step, out = JCheckpointer(str(tmp_path)).restore(jtree)
    assert step == 4
    for g, w in zip(jax.tree.leaves(out), jax.tree.leaves(jtree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_port_trainer_resumes_a_jax_checkpoint(tmp_path):
    """A JAX trainer runs 12 steps (checkpoints at 6 and 12); a port
    trainer resumes from the JAX step-6 directory and reaches the JAX
    step-12 parameters and losses."""
    kw = dict(model="tiny-dense", batch_size=4, seq_len=32, steps=12,
              log_every=1, checkpoint_every=6)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jt = JTrainer(JTrainConfig(checkpoint_dir=str(tmp_path / "jax"),
                               optimizer=JOptimizerConfig(**opt), **kw))
    jh = jt.train()
    assert sorted(os.listdir(tmp_path / "jax")) == [
        "step_00000006", "step_00000012"]
    shutil.copytree(tmp_path / "jax" / "step_00000006",
                    tmp_path / "port" / "step_00000006")
    tt = Trainer(TrainConfig(checkpoint_dir=str(tmp_path / "port"),
                             optimizer=OptimizerConfig(**opt), **kw),
                 device="cpu")
    tt.initialize()
    assert tt.step == 6 and int(tt.opt_state.step) == 6
    th = tt.train(steps=6)
    assert [s for s, _ in th] == list(range(7, 13))
    np.testing.assert_allclose([l for _, l in th], [l for _, l in jh[6:]],
                               rtol=1e-4)
    want = jax.device_get(jt.params)
    for g, w in zip(tree_leaves(tt.params), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4)
    # and the port's step-12 directory restores in JAX
    step, back = JCheckpointer(str(tmp_path / "port")).restore(
        {"params": jt.params, "opt": jt.opt_state})
    assert step == 12
    for g, w in zip(jax.tree.leaves(back["params"]), tree_leaves(tt.params)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_converted_params_restore_from_a_jax_trainer_save(tmp_path):
    """``convert.params_from_numpy`` and a restore give the same tensors."""
    params = _tiny_params()
    JCheckpointer(str(tmp_path)).save(1, {"params": params}, async_=False)
    conv = params_from_numpy(params, "cpu")
    _, out = Checkpointer(str(tmp_path)).restore({"params": conv})
    for a, b in zip(tree_leaves(out["params"]), tree_leaves(conv)):
        assert torch.equal(a, b)
    assert init_opt_state(conv, OptimizerConfig()).m.keys() == conv.keys()
