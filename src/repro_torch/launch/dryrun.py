"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on fake
tensors as rank 0 of the production mesh, and count it. Counterpart of
``repro/launch/dryrun.py``.

Proves the distribution config is coherent without hardware: the model
built on the 16x16 single-pod mesh AND the (2,16,16) multi-pod mesh, its
parameters, optimizer state, cache and batch laid out by the logical-axis
rules as DTensors, must run its train step, prefill or decode step, and
report per-rank FLOPs, bytes and collective bytes
(``repro_torch.launch.cost_analysis``) and the exact local bytes of its
arguments.

Each cell runs in one process under ``torch.distributed``'s fake process
group (``FakeStore``: a world of 256 or 512 ranks in which this process is
rank 0 and every collective returns at once), its DTensors' local blocks
on the ``meta`` device (shapes and dtypes, no storage, no arithmetic: what
``FakeTensorMode`` gives, at a third of its dispatch cost). The train
step's accumulation microbatches are alike, so one is run and its counts
multiplied by ``gradient_accum``, as the JAX dry-run multiplies a scan
body by its trip count (:class:`TrainCell`). Where
the JAX package reads XLA's compile (``compile_s``, the code size, temp
and peak memory), the port has no compiled program: those keys are left
out, and only ``argument_size_in_bytes`` is given in ``memory``.

The roofline divides by an NVIDIA H100 SXM's data-sheet figures
(:data:`H100_DATASHEET`), never the TPU figures of ``config.ROOFLINE``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out results_torch/
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.config import OptimizerConfig, ShardingConfig, SHAPES
from repro_torch.configs import get_config, iter_dryrun_cells
from repro_torch.distributed.sharding import (DEFAULT_RULES, batch_shardings,
                                              param_shardings)
from repro_torch.launch.cost_analysis import analyze_step
from repro_torch.launch.mesh import make_production_mesh, mesh_config
from repro_torch.models import build_model
from repro_torch.training.optimizer import (OptState, adamw_update,
                                            tree_leaves, tree_map)
from repro_torch.training.train_loop import (loss_and_grads,
                                             make_train_step, microbatch)

#: one NVIDIA H100 SXM, NVIDIA's data sheet (dense, no sparsity): the
#: roofline's denominators
H100_DATASHEET = {"source": "NVIDIA H100 SXM data sheet",
                  "peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                  "hbm_per_chip": 80e9, "nvlink_bw_per_direction": 450e9}


# ---------------------------------------------------------------------------
# fake ranks and fake tensors
# ---------------------------------------------------------------------------


def fake_world(multi_pod: bool) -> int:
    """Ranks of the fake process group: the production mesh's, or
    ``REPRO_DRYRUN_RANKS`` (a smaller mesh for tests)."""
    n = os.environ.get("REPRO_DRYRUN_RANKS")
    return int(n) if n else mesh_config(multi_pod).num_devices


@contextlib.contextmanager
def fake_process_group(world: int):
    """This process as rank 0 of a ``world``-rank fake process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(meta: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A DTensor of ``meta``'s global shape and dtype laid out as
    ``placements``, its local block a ``meta`` tensor (shape and dtype, no
    storage)."""
    from torch.distributed.tensor import DTensor

    local = list(meta.shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=meta.dtype,
                                          device="meta"), mesh,
                              placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _fake_tree(metas, placements, mesh):
    if isinstance(metas, dict):
        return {k: _fake_tree(v, placements[k], mesh)
                for k, v in metas.items()}
    return _fake(metas, mesh, placements)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):  # NamedTuples too
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _local_bytes(tree) -> int:
    total = 0
    for x in _leaves(tree):
        x = x.to_local() if hasattr(x, "to_local") else x
        total += x.numel() * x.element_size()
    return total


def _axes_shardings(metas, axes, mesh, rules):
    if isinstance(metas, dict):
        return {k: _axes_shardings(v, axes[k], mesh, rules)
                for k, v in metas.items()}
    return batch_shardings(axes, tuple(metas.shape), mesh, rules)


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, mesh, *,
               sharding_cfg: Optional[ShardingConfig] = None,
               rules: Optional[dict] = None,
               cache_rules: Optional[dict] = None,
               moe_2d: bool = False):
    """Returns (step fn, DTensor args on ``meta`` local blocks, meta,
    cfg)."""
    rules = rules or DEFAULT_RULES
    cache_rules = cache_rules or rules
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    moe_impl = "auto"
    if moe_2d and cfg.num_experts and shape.kind == "decode":
        # weight-stationary 2D expert parallelism (decode): experts over
        # data, expert-FFN over model -> weights never move at decode time
        rules = dict(rules)
        rules.update({"experts": ("data",), "expert_ffn": ("model",)})
        cache_rules = dict(cache_rules) if cache_rules else rules
        moe_impl = "decode2d"
    big = cfg.param_count() > 60e9
    if sharding_cfg is None:
        # baseline defaults (the JAX package's):
        # · full remat (recompute-everything) — lowest activation memory;
        # · gradient accumulation so the per-layer saved residual stack
        #   (L x B_local/accum x S x D, the irreducible remat footprint)
        #   stays under ~2 GB/device;
        # · sequence-parallel residuals for wide models.
        accum = 1
        if shape.kind == "train":
            sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
            dp = max(1, sizes.get("data", 1) * sizes.get("pod", 1))
            tp = max(1, sizes.get("model", 1))
            b_local = max(1, shape.global_batch // dp)
            seq_shard = tp if cfg.d_model % tp == 0 and cfg.d_model >= 4096 else 1
            saved = (cfg.num_layers * b_local * shape.seq_len
                     * cfg.d_model * 2 / seq_shard)
            while accum < b_local and saved / accum > 2e9:
                accum *= 2
        sharding_cfg = ShardingConfig(
            zero_stage=3 if big else 1, remat_policy="full",
            gradient_accum=accum,
            sequence_parallel=cfg.d_model >= 4096)
    model = build_model(cfg, mesh=mesh, sharding=sharding_cfg,
                        moe_impl=moe_impl)

    pspecs = model.specs()
    fsdp = ("data", "pod") if sharding_cfg.zero_stage >= 3 else ()
    if moe_impl == "decode2d":
        fsdp = ()  # weights are statically 2D-sharded; never re-gathered
    p_shard = param_shardings(pspecs, mesh, rules, fsdp_axes=fsdp)
    params = _fake_tree(model.param_shapes(), p_shard, mesh)

    in_specs, in_axes = model.input_specs(shape)
    batch = _fake_tree(in_specs, _axes_shardings(in_specs, in_axes, mesh,
                                                 rules), mesh)

    if shape.kind == "train":
        opt_cfg = OptimizerConfig(state_dtype="bfloat16" if big else "float32")
        st_dt = getattr(torch, opt_cfg.state_dtype)
        # ZeRO >= 1: optimizer states always FSDP-sharded over data(+pod)
        mv_shard = param_shardings(pspecs, mesh, rules,
                                   fsdp_axes=("data", "pod"))
        mv = lambda: _fake_tree(_retype(model.param_shapes(), st_dt),
                                mv_shard, mesh)
        opt = OptState(torch.zeros((), dtype=torch.int32, device="meta"),
                       mv(), mv())
        fn = TrainCell(model, opt_cfg, sharding_cfg.gradient_accum)
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        cap = shape.seq_len
        fn = lambda p, b: model.prefill(p, b, cap)
        args = (params, batch)
    else:  # decode
        cap = shape.seq_len
        c_meta = model.cache_specs(shape.global_batch, cap)
        c_axes = model.cache_axes(shape.global_batch, cap)
        cache = _fake_tree(c_meta, _axes_shardings(c_meta, c_axes, mesh,
                                                   cache_rules), mesh)
        fn = model.decode_step
        args = (params, cache, batch)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "zero_stage": sharding_cfg.zero_stage,
            "gradient_accum": sharding_cfg.gradient_accum}
    return fn, args, meta, cfg


class TrainCell:
    """The train step of a cell: calling it runs ``make_train_step``'s
    step; :meth:`analyze` counts it with the accumulation loop's body (one
    microbatch's loss and gradients, and its f32 accumulation) run once and
    multiplied by its trip count."""

    def __init__(self, model, opt_cfg, accum: int):
        self.model, self.opt_cfg, self.accum = model, opt_cfg, accum
        self.step = make_train_step(model, opt_cfg, accum)

    def __call__(self, params, opt, batch):
        return self.step(params, opt, batch)

    def analyze(self, params, opt, batch) -> Dict[str, Any]:
        n = self.accum
        micro = {k: microbatch(v, 0, n) for k, v in batch.items()}
        body, (_, _, grads) = analyze_step(loss_and_grads, self.model,
                                           params, micro)
        parts = [(body, n)]
        if n > 1:
            acc = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32,
                memory_format=torch.contiguous_format), params)

            def accumulate():
                with torch.no_grad():
                    for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                        a.add_(g.float())
                return tree_map(lambda a: a / n, acc)

            add, grads = analyze_step(accumulate)
            parts.append((add, n))
        update, _ = analyze_step(adamw_update, params, grads, opt,
                                 self.opt_cfg)
        parts.append((update, 1))
        return _scaled_sum(parts)


def _scaled_sum(parts) -> Dict[str, Any]:
    """Counts summed over (counts, times) parts."""
    out: Dict[str, Any] = {}
    for counts, times in parts:
        for k, v in counts.items():
            if isinstance(v, dict):
                d = out.setdefault(k, {})
                for kk, vv in v.items():
                    d[kk] = d.get(kk, 0) + vv * times
            else:
                out[k] = out.get(k, 0) + v * times
    return out


def _retype(tree, dtype):
    if isinstance(tree, dict):
        return {k: _retype(v, dtype) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N_active·D forward (decode: per step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             sharding_cfg: Optional[ShardingConfig] = None,
             rules=None, cache_rules=None, tag: str = "",
             moe_2d: bool = False) -> Dict[str, Any]:
    """One cell in this process: a fake process group of the production
    mesh's ranks, the step counted on fake tensors; the record is written
    to ``out_dir`` (if given) and returned."""
    t0 = time.perf_counter()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi_pod else "single",
                           "tag": tag}
    try:
        with fake_process_group(fake_world(multi_pod)):
            mesh = make_production_mesh(multi_pod=multi_pod)
            n_dev = mesh.size()
            rec["devices"] = int(n_dev)
            rec["mesh_shape"] = list(mesh.shape)
            fn, args, meta, cfg = build_cell(
                arch, shape_name, mesh, sharding_cfg=sharding_cfg,
                rules=rules, cache_rules=cache_rules, moe_2d=moe_2d)
            rec.update(meta)
            args_b = _local_bytes(args)
            t_build = time.perf_counter()
            if isinstance(fn, TrainCell):
                cost = fn.analyze(*args)
            else:
                cost, _ = analyze_step(fn, *args)
            t_run = time.perf_counter()
        shape = SHAPES[shape_name]
        mf = model_flops(cfg, shape)
        flops = cost["flops"]
        bytes_acc = cost["hbm_bytes"]
        coll_bytes = cost["collective_bytes"]
        total = flops * n_dev
        hw = H100_DATASHEET
        compute_t = flops / hw["peak_flops_bf16"]
        memory_t = bytes_acc / hw["hbm_bw"]
        coll_t = coll_bytes / hw["nvlink_bw_per_direction"]
        dominant = max((("compute", compute_t), ("memory", memory_t),
                        ("collective", coll_t)), key=lambda kv: kv[1])[0]
        rec.update({
            "ok": True,
            "build_s": round(t_build - t0, 2),
            "run_s": round(t_run - t_build, 2),
            "memory": {"argument_size_in_bytes": int(args_b)},
            "per_device_flops": flops,
            "per_device_bytes": bytes_acc,
            "collective_bytes_per_device": coll_bytes,
            "collective_per_op": cost["per_collective"],
            "collective_counts": cost["collective_counts"],
            "num_dots": cost["num_dots"],
            "model_flops": mf,
            "hlo_flops_total": total,
            "useful_flops_ratio": mf / total if total else 0,
            "roofline": {"compute_s": compute_t, "memory_s": memory_t,
                         "collective_s": coll_t, "dominant": dominant,
                         "hardware": hw},
            # arguments only: the port has no compiled temp/peak figure
            "fits_hbm": bool(args_b <= hw["hbm_per_chip"]),
        })
        print(f"[dryrun] {arch} {shape_name} {rec['mesh']}: OK "
              f"run={rec['run_s']}s flops/dev={flops:.4g} "
              f"coll={coll_bytes:.4g}B dom={dominant} "
              f"useful={rec['useful_flops_ratio']:.2f} "
              f"args={args_b / 1e9:.3f}GB")
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} {shape_name} {rec['mesh']}: FAIL "
              f"{rec['error'][:300]}")
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fname = os.path.join(
            out_dir, f"dryrun_{arch}_{shape_name}_{rec['mesh']}{suffix}.json")
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def _run_cell_child(queue, args, kwargs) -> None:
    queue.put(run_cell(*args, **kwargs))


def run_cell_process(*args, **kwargs) -> Dict[str, Any]:
    """``run_cell`` in a spawned process of its own (one fake process
    group a process)."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_run_cell_child, args=(queue, args, kwargs))
    proc.start()
    try:
        rec = queue.get()
    finally:
        proc.join()
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results")
    ap.add_argument("--zero", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--seq-par", type=int, default=None, choices=[0, 1])
    ap.add_argument("--cache-seq-shard", action="store_true",
                    help="shard decode KV cache sequence dim over model axis")
    ap.add_argument("--moe-2d", action="store_true",
                    help="weight-stationary 2D expert parallelism for decode")
    ap.add_argument("--tag", default="", help="variant tag for perf iterations")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    shard_cfg = None
    if any(v is not None for v in (args.zero, args.remat, args.accum,
                                   args.seq_par)):
        shard_cfg = ShardingConfig(
            zero_stage=args.zero if args.zero is not None else 3,
            remat_policy=args.remat or "full",
            gradient_accum=args.accum or 1,
            sequence_parallel=bool(args.seq_par)
            if args.seq_par is not None else True)
    cache_rules = None
    if args.cache_seq_shard:
        cache_rules = dict(DEFAULT_RULES)
        cache_rules["seq"] = ("model",)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells = []
    if args.all:
        for arch, shape_name, skip in iter_dryrun_cells():
            cells.append((arch, shape_name, skip))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells.append((args.arch, args.shape, None))

    results = []
    for arch, shape_name, skip in cells:
        for mp in meshes:
            if skip:
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": "multi" if mp else "single",
                                "ok": None, "skipped": skip})
                print(f"[dryrun] {arch} {shape_name}: SKIP ({skip[:60]}…)")
                continue
            if args.skip_existing:
                fname = os.path.join(
                    args.out, f"dryrun_{arch}_{shape_name}_"
                    f"{'multi' if mp else 'single'}.json")
                if os.path.exists(fname):
                    with open(fname) as f:
                        prev = json.load(f)
                    if prev.get("ok"):
                        results.append(prev)
                        continue
            results.append(run_cell_process(
                arch, shape_name, mp, args.out, sharding_cfg=shard_cfg,
                cache_rules=cache_rules, tag=args.tag, moe_2d=args.moe_2d))
    ok = sum(1 for r in results if r.get("ok"))
    skipped = sum(1 for r in results if r.get("ok") is None)
    fail = sum(1 for r in results if r.get("ok") is False)
    print(f"[dryrun] done: {ok} ok, {skipped} skipped-by-design, {fail} failed")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "dryrun_summary.json"), "w") as f:
            json.dump(results, f, indent=1, default=str)


if __name__ == "__main__":
    main()
