"""The port's distribution layer on 4 gloo CPU ranks, one (2, 2)
("data", "model") DeviceMesh, against the JAX package:

* the expert-parallel MoE (``moe_dropping_forward``: tokens over data,
  experts over model) and ``decode2d`` (experts over data, expert FFN over
  model) within 5e-4 of JAX's dense oracle (aux within 2e-3), on the JAX
  test's config, and the dropping path's gradients within 1e-4 of the
  port's dense oracle's;
* the reduced qwen2-vl-2b trainer on the mesh (replicated parameters, the
  batch over data) from converted JAX weights: 3 losses within 1e-5 of
  JAX's mesh-free ``Trainer``; its checkpoint of the same weights
  byte-identical to the mesh-free port's, and its trained one within 1e-6;
* ``full_tensor()`` of every placement ``param_shardings`` gives the
  reduced model (with and without FSDP, on (2, 2) and on a (2, 2, 1) mesh
  with a "pod" axis, where FSDP shards one dim over two axes) bitwise;
* ``elastic_restore_tree`` of the trained checkpoint onto 2 ranks (FSDP
  over "data") and onto 1 rank (new process groups of the same
  processes), bitwise;
* meshed inference with the parameters sharded by ``param_shardings``: a
  reduced dense model with one KV head (which does not divide "model", so
  each rank slices out its KV heads) and reduced whisper-small, a prefill
  and two decode steps each, logits within 1e-4 of the JAX package's
  mesh-free model;
* ``global_norm`` of gradients sharded as their parameters against the
  plain tree's, and two ``adamw_update`` steps with the moments sharded
  finer (ZeRO, FSDP over "data") against the mesh-free update, 1e-6.

All of it runs in ONE module-scoped spawn of 4 processes that returns
every result at once; the JAX references run in the test process
meanwhile."""
import os
import socket
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCH = "qwen2-vl-2b"
B, S, STEPS, LR = 4, 32, 3, 1e-3
#: the meshed inference cases: (arch, config overrides, prompt length,
#: cache capacity); one KV head does not divide "model"
INFER = {"dense": ("qwen3-0.6b", {"num_kv_heads": 1}, 11, 16),
         "whisper": ("whisper-small", {}, 11, 24)}
DECODE_STEPS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _moe_case():
    """The JAX package's 8-device test config (8 experts, top-2, capacity
    8.0, f32) and its oracle's outputs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config
    from repro.models import moe as M
    from repro.models.spec import init_tree

    cfg = reduced_config("qwen3-moe-235b-a22b").replace(
        dtype="float32", capacity_factor=8.0, num_experts=8, top_k=2)
    params = init_tree(M.moe_specs(cfg), jax.random.PRNGKey(0), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model))
    y, aux = M.moe_dense_forward(params, x, cfg)
    r = np.asarray(jax.random.normal(jax.random.PRNGKey(2), x.shape))
    return (jax.tree.map(np.asarray, params), np.asarray(x), r,
            np.asarray(y), float(aux))


def _infer_case(name, seed):
    """A reduced model's JAX parameters and its inputs: a prompt of two
    rows (with frames for whisper) and DECODE_STEPS decode steps."""
    import jax

    from repro.configs import reduced_config
    from repro.models import build_model

    arch, kw, s, cap = INFER[name]
    cfg = reduced_config(arch).replace(dtype="float32", **kw)
    jp = jax.device_get(build_model(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    prompt = {"tokens": rng.integers(4, cfg.vocab_size, (2, s)).astype(
        np.int32)}
    if cfg.family == "encdec":
        prompt["frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
    steps = [{"tokens": rng.integers(4, cfg.vocab_size, (2, 1)).astype(
                  np.int32),
              "positions": np.full((2,), s + i, np.int32)}
             for i in range(DECODE_STEPS)]
    return jp, prompt, steps


def _infer_jax(name, case):
    """The JAX package's mesh-free logits: the prefill's, then each decode
    step's."""
    import jax.numpy as jnp

    from repro.configs import reduced_config
    from repro.models import build_model

    arch, kw, _, cap = INFER[name]
    jm = build_model(reduced_config(arch).replace(dtype="float32", **kw))
    jp, prompt, steps = case
    logits, cache = jm.prefill(jp, {k: jnp.asarray(v)
                                    for k, v in prompt.items()}, cap)
    out = [np.asarray(logits)]
    for b in steps:
        logits, cache = jm.decode_step(jp, cache, {k: jnp.asarray(v)
                                                   for k, v in b.items()})
        out.append(np.asarray(logits))
    return out


def _infer_on_mesh(name, case, mesh):
    """The port's logits on ``mesh``, the parameters laid out by
    ``param_shardings``, and the cache's KV leaves that the prefill and the
    decode steps left in another layout than ``cache_axes`` gives."""
    from repro_torch.configs import reduced_config
    from repro_torch.convert import params_on_mesh
    from repro_torch.models import build_model

    arch, kw, _, cap = INFER[name]
    tm = build_model(reduced_config(arch).replace(dtype="float32", **kw),
                     param_dtype="float32", mesh=mesh)
    jp, prompt, steps = case
    tp = params_on_mesh(jp, tm.specs(), mesh)
    full = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x
    logits, cache = tm.prefill(tp, {k: torch.from_numpy(v)
                                    for k, v in prompt.items()}, cap)
    out = [full(logits).numpy()]
    for b in steps:
        logits, cache = tm.decode_step(tp, cache, {
            k: torch.from_numpy(v) for k, v in b.items()})
        out.append(full(logits).numpy())
    return out, _layout_faults(cache, tm.cache_axes(2, cap), mesh)


def _layout_faults(cache, axes, mesh, path=""):
    """The KV leaves of ``cache`` not laid out as the model's
    ``cache_axes`` resolve on ``mesh``: (path, placements, wanted)."""
    from repro_torch.distributed.sharding import logical_pspec, to_placements

    faults = []
    for k, x in cache.items():
        if isinstance(x, dict):
            faults += _layout_faults(x, axes[k], mesh, f"{path}/{k}")
        elif x.dim() == 5:
            want = to_placements(logical_pspec(axes[k], tuple(x.shape), mesh),
                                 mesh)
            got = tuple(getattr(x, "placements", ()))
            if got != want:
                faults.append((f"{path}/{k}", str(got), str(want)))
    return faults


def _optimizer_on_mesh(jparams, grads, specs, mesh):
    """``global_norm`` of gradients laid out as their parameters, against
    the plain tree's, and two ``adamw_update`` steps with the moments
    sharded finer (FSDP over "data") against the mesh-free update: (the
    two norms, the largest parameter and moment difference, the number of
    leaves whose moments are sharded finer)."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  param_shardings)
    from repro_torch.training.optimizer import (OptState, adamw_update,
                                                global_norm, init_opt_state,
                                                tree_leaves, tree_map)

    cfg = OptimizerConfig(lr=LR, warmup_steps=1, total_steps=STEPS)
    sh = param_shardings(specs, mesh)
    zero = param_shardings(specs, mesh, fsdp_axes=("data",))
    finer = sum(a != b for a, b in zip(tree_leaves(sh), tree_leaves(zero)))
    p = params_from_numpy(jparams, "cpu")
    g = params_from_numpy(grads, "cpu")
    mp = distribute_tree(params_from_numpy(jparams, "cpu"), sh, mesh)
    mg = distribute_tree(g, sh, mesh)
    zeros = tree_map(torch.zeros_like, p)
    mstate = OptState(step=torch.zeros((), dtype=torch.int32),
                      m=distribute_tree(zeros, zero, mesh),
                      v=distribute_tree(zeros, zero, mesh))
    state = init_opt_state(p, cfg)
    norms = (float(global_norm(mg)), float(global_norm(g)))
    for _ in range(2):
        mp, mstate, _ = adamw_update(mp, mg, mstate, cfg)
        p, state, _ = adamw_update(p, g, state, cfg)
    diff = max(float((a.full_tensor() - b).abs().max())
               for t, u in ((mp, p), (mstate.m, state.m),
                            (mstate.v, state.v))
               for a, b in zip(tree_leaves(t), tree_leaves(u)))
    return norms, diff, finer


def _train_kw(directory):
    return dict(model=ARCH, batch_size=B, seq_len=S, steps=STEPS,
                log_every=1, checkpoint_every=100,
                checkpoint_dir=str(directory))


def _check_restored(ckpt, like, specs, mesh, step, fsdp):
    """Elastic restore onto ``mesh``: every leaf's local block and its
    full tensor equal the checkpoint's array bitwise."""
    from repro_torch.checkpoint import elastic_restore_tree
    from repro_torch.training.optimizer import tree_leaves

    got_step, tree = elastic_restore_tree(ckpt, like, specs, mesh, step=step,
                                          fsdp_axes=fsdp)
    d = os.path.join(ckpt.dir, f"step_{step:08d}")
    names = sorted(n[:-4] for n in os.listdir(d) if n.startswith("params."))
    n_sharded = 0
    for name, leaf in zip(names, tree_leaves(tree)):
        want = torch.from_numpy(np.load(os.path.join(d, name + ".npy")))
        if not torch.equal(leaf.full_tensor(), want):
            return f"{name}: full tensor differs"
        block = want
        for i, p in enumerate(leaf.placements):
            if p.is_shard():
                block = block.chunk(mesh.size(i), p.dim)[
                    mesh.get_local_rank(i)]
        if not torch.equal(leaf.to_local(), block):
            return f"{name}: local block differs"
        n_sharded += leaf.to_local().numel() < want.numel()
    return got_step, len(names), n_sharded


def _worker(rank, port, tmp, queue):
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    out = {"rank": rank}
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            moe, jparams, infer, grads = pickle.load(f)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate

        from repro_torch.checkpoint import Checkpointer
        from repro_torch.config import OptimizerConfig, TrainConfig
        from repro_torch.configs import reduced_config
        from repro_torch.convert import params_from_numpy, params_on_mesh
        from repro_torch.distributed.sharding import distribute
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import build_model
        from repro_torch.models import moe as M
        from repro_torch.training import Trainer, init_opt_state
        from repro_torch.training.optimizer import tree_leaves, tree_map

        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        mesh = make_debug_mesh(2, 2, device_type="cpu")

        # the expert-parallel MoE and decode2d against the dense oracle
        mp, x, r, _, _ = moe
        mcfg = reduced_config("qwen3-moe-235b-a22b").replace(
            dtype="float32", capacity_factor=8.0, num_experts=8, top_k=2)
        p = params_from_numpy(mp, "cpu")
        y, aux = M.moe_forward(p, torch.from_numpy(x), mcfg, "auto",
                               mesh=mesh)
        y2, _ = M.moe_forward(p, torch.from_numpy(x), mcfg, "decode2d",
                              mesh=mesh)
        out["moe"] = (y.full_tensor().numpy(), float(aux.full_tensor()),
                      y2.full_tensor().numpy())
        rep = [Replicate()] * 2
        pd = {k: distribute(v, mesh, rep).requires_grad_()
              for k, v in p.items()}
        xd = distribute(torch.from_numpy(x), mesh, rep).requires_grad_()
        yd, _ = M.moe_forward(pd, xd, mcfg, "dropping", mesh=mesh)
        loss = (yd * distribute(torch.from_numpy(r), mesh, rep)).sum()
        moe_grads = torch.autograd.grad(loss, [xd] + list(pd.values()))
        out["moe_grads"] = [g.full_tensor().numpy() for g in moe_grads]

        # meshed inference and the optimizer on sharded leaves
        for name, case in infer.items():
            out[f"infer_{name}"] = _infer_on_mesh(name, case, mesh)

        # the reduced trainer on the mesh, from the converted JAX weights
        cfg = reduced_config(ARCH).replace(dtype="float32")
        t = Trainer(TrainConfig(optimizer=OptimizerConfig(
            lr=LR, total_steps=STEPS), **_train_kw(Path(tmp) / "mesh")),
            model=build_model(cfg, param_dtype="float32", device="cpu",
                              mesh=mesh), mesh=mesh)
        t.params = tree_map(lambda v: distribute(v, mesh, rep),
                            params_from_numpy(jparams, "cpu"))
        t.opt_state = init_opt_state(t.params, t.cfg.optimizer)
        t.save(async_=False)  # step 0: the converted weights
        out["losses"] = [loss for _, loss in t.train()]
        out["placements"] = sorted({str(v.placements)
                                    for v in tree_leaves(t.params)})

        # every layout param_shardings gives the model, reassembled
        specs = t.model.specs()
        out["optimizer"] = _optimizer_on_mesh(jparams, grads, specs, mesh)
        pod = init_device_mesh("cpu", (2, 2, 1),
                               mesh_dim_names=("pod", "data", "model"))
        n_leaves, bad = 0, []
        for m in (mesh, pod):
            for fsdp in ((), ("data", "pod")):
                on = params_on_mesh(jparams, specs, m, fsdp_axes=fsdp)
                ref = params_from_numpy(jparams, "cpu")
                for a, b in zip(tree_leaves(on), tree_leaves(ref)):
                    n_leaves += 1
                    if not torch.equal(a.full_tensor(), b):
                        bad.append((str(m.mesh_dim_names), fsdp,
                                    str(a.placements)))
        out["full_tensor"] = (n_leaves, bad)
        dist.barrier()
        dist.destroy_process_group()

        # elastic restore of the trained checkpoint onto 2 ranks, then 1
        ckpt = Checkpointer(str(Path(tmp) / "mesh"))
        like = {"params": tree_map(lambda v: v.full_tensor(), t.params)}
        for world, shape, port_ in ((2, (2, 1), port + 1),
                                    (1, (1, 1), port + 2)):
            if rank >= world:
                break
            dist.init_process_group("gloo",
                                    init_method=f"tcp://localhost:{port_}",
                                    rank=rank, world_size=world)
            m = make_debug_mesh(*shape, device_type="cpu")
            out[f"elastic_{world}"] = _check_restored(
                ckpt, like, {"params": specs}, m, STEPS, ("data",))
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the test process
        import traceback

        out["error"] = traceback.format_exc()
    queue.put(out)


@pytest.fixture(scope="module")
def ranks():
    # JAX is imported here, not at the top: each spawned rank imports this
    # module to find its worker, and needs torch only
    import multiprocessing
    import pickle

    import jax
    import jax.numpy as jnp

    from repro.config import OptimizerConfig as JOpt
    from repro.config import TrainConfig as JTrainConfig
    from repro.configs import reduced_config as j_reduced
    from repro.models import build_model as j_build
    from repro.training import Trainer as JTrainer
    from repro.training import init_opt_state as j_init_opt

    tmp = tempfile.mkdtemp(prefix="test_torch_distributed_")
    moe = _moe_case()
    jcfg = j_reduced(ARCH).replace(dtype="float32")
    jparams = jax.tree.map(np.asarray, j_build(jcfg).init(
        jax.random.PRNGKey(0)))
    infer = {name: _infer_case(name, seed)
             for seed, name in enumerate(INFER)}
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jparams)
    # the inputs go by file: spawn's start() blocks until the child has read
    # its arguments, which would start the ranks one after another
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump((moe, jparams, infer, grads), f)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, tmp, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    # meanwhile, the references in this process: JAX's mesh-free trainer
    # and the port's mesh-free trainer from the same weights
    jt = JTrainer(JTrainConfig(optimizer=JOpt(lr=LR, total_steps=STEPS),
                               **_train_kw(Path(tmp) / "jax")),
                  model=j_build(jcfg, param_dtype="float32"))
    jt.params = jax.tree.map(jnp.asarray, jparams)
    jt.opt_state = j_init_opt(jt.params, jt.cfg.optimizer)
    jax_losses = [loss for _, loss in jt.train()]
    jax_infer = {name: _infer_jax(name, case) for name, case in infer.items()}

    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.training import Trainer, init_opt_state

    tt = Trainer(TrainConfig(optimizer=OptimizerConfig(
        lr=LR, total_steps=STEPS), **_train_kw(Path(tmp) / "plain")),
        model=build_model(reduced_config(ARCH).replace(dtype="float32"),
                          param_dtype="float32", device="cpu"))
    tt.params = params_from_numpy(jparams, "cpu")
    tt.opt_state = init_opt_state(tt.params, tt.cfg.optimizer)
    tt.save(async_=False)
    port_losses = [loss for _, loss in tt.train()]
    results = {}
    for _ in procs:
        r = queue.get(timeout=600)
        results[r["rank"]] = r
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    errors = {r: v["error"] for r, v in results.items() if "error" in v}
    assert not errors, errors
    return {"results": results, "moe": moe, "jax_losses": jax_losses,
            "port_losses": port_losses, "jax_infer": jax_infer,
            "tmp": Path(tmp)}


def test_expert_parallel_moe_matches_the_dense_oracle(ranks):
    _, _, _, y_ref, aux_ref = ranks["moe"]
    for r in ranks["results"].values():
        y, aux, _ = r["moe"]
        assert float(np.max(np.abs(y - y_ref))) < 5e-4
        # aux is the mean of the token shards' own estimates
        assert abs(aux - aux_ref) < 2e-3


def test_decode2d_matches_the_dense_oracle(ranks):
    _, _, _, y_ref, _ = ranks["moe"]
    for r in ranks["results"].values():
        assert float(np.max(np.abs(r["moe"][2] - y_ref))) < 5e-4


def test_expert_parallel_gradients_match_the_dense_oracle(ranks):
    from repro_torch.configs import reduced_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import moe as M

    mp, x, r, _, _ = ranks["moe"]
    cfg = reduced_config("qwen3-moe-235b-a22b").replace(
        dtype="float32", capacity_factor=8.0, num_experts=8, top_k=2)
    p = {k: v.requires_grad_() for k, v in
         params_from_numpy(mp, "cpu").items()}
    xt = torch.tensor(x).requires_grad_()
    y, _ = M.moe_dense_forward(p, xt, cfg)
    want = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                               [xt] + list(p.values()))
    for res in ranks["results"].values():
        for g, w in zip(res["moe_grads"], want):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-4)


def test_meshed_trainer_matches_jax(ranks):
    jl = ranks["jax_losses"]
    for r in ranks["results"].values():
        assert len(r["losses"]) == STEPS
        np.testing.assert_allclose(r["losses"], jl, rtol=0, atol=1e-5)
        assert r["placements"] == ["(Replicate(), Replicate())"]
    np.testing.assert_allclose(ranks["port_losses"], jl, rtol=0, atol=1e-5)


def test_meshed_checkpoint_files_match_the_mesh_free_port(ranks):
    tmp = ranks["tmp"]
    for step, exact in ((0, True), (STEPS, False)):
        a, b = (tmp / d / f"step_{step:08d}" for d in ("mesh", "plain"))
        assert (a / "manifest.json").read_bytes() == (
            b / "manifest.json").read_bytes()
        names = sorted(p.name for p in a.iterdir())
        assert names == sorted(p.name for p in b.iterdir())
        for n in names:
            if exact:  # the same weights: the same bytes
                assert (a / n).read_bytes() == (b / n).read_bytes(), n
            elif n.endswith(".npy"):
                np.testing.assert_allclose(np.load(a / n), np.load(b / n),
                                           rtol=0, atol=1e-6)


def test_param_shardings_reassemble_bitwise(ranks):
    for r in ranks["results"].values():
        n, bad = r["full_tensor"]
        assert n > 0 and not bad, bad


def test_elastic_restore_onto_two_ranks_and_one(ranks):
    res = ranks["results"]
    for world in (2, 1):
        for rank in range(world):
            got = res[rank][f"elastic_{world}"]
            assert not isinstance(got, str), got
            step, n, n_sharded = got
            assert step == STEPS and n > 0
            # FSDP over data: some leaves sharded on 2 ranks, none on 1
            assert (n_sharded > 0) == (world == 2)


@pytest.mark.parametrize("name", sorted(INFER))
def test_meshed_prefill_and_decode_match_jax(ranks, name):
    want = ranks["jax_infer"][name]
    for r in ranks["results"].values():
        got, faults = r[f"infer_{name}"]
        assert len(got) == len(want) == 1 + DECODE_STEPS
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        # the KV caches stay on the mesh as cache_axes lay them out (the
        # batch over "data", KV heads over "model" where they divide it)
        assert not faults, faults


def test_global_norm_and_zero_adamw_on_sharded_leaves(ranks):
    for r in ranks["results"].values():
        (meshed, plain), diff, finer = r["optimizer"]
        assert finer > 0  # some moments sharded finer than their params
        assert abs(meshed - plain) <= 1e-6 * plain, (meshed, plain)
        assert diff <= 1e-6, diff
