"""Whole runs of each cell on the CPU at a reduced size: set-up, window,
drain, reference and result, with no chip. Also the check's teeth: the
same run with the timed path broken underneath must come out not
correct, once for each fault a serving cell can have."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from moabench import run, spec, testing

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 4242
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
QUIET = dict(log=lambda s: None)
#: the closed loop, which no cell runs yet, on the first cell's
#: configuration and limits
CLOSED = dict(spec.cell(CELLS[0]), name="describe-closed",
              traffic="describe-closed", params={}, sample_tokens=256,
              sample_max_requests=6)


@pytest.fixture(autouse=True)
def _one_thread():
    """The runs' matrices are tiny: one intra-op thread keeps a run from
    fighting the other test workers for every core."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name, seconds=1.5, **kw):
    cell = CLOSED if name == CLOSED["name"] else None
    config = CELLS[0] if cell is not None else name
    return run.run_cell(name, SEED, seconds, False, device="cpu",
                        rate=kw.pop("rate", None) or (
                            4.0 if name == "qwen-vqa-poisson" else None),
                        cfg_override=testing.small_config(config),
                        params_override=testing.SMALL_TRAFFIC,
                        cell_override=cell, **QUIET, **kw)


def test_closed_loop_runs_correct():
    res = _run(CLOSED["name"])
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_dry_runs_load_neither_jax_nor_the_jax_package():
    """Both cells' CPU paths, in a fresh process: correct, every
    end-to-end metric present, and no module named jax, jaxlib, flax or
    repro (compared by whole top-level name) loaded afterwards."""
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from moabench import run, testing\n"
        "out = {}\n"
        f"for name in {CELLS!r}:\n"
        f"    res = run.run_cell(name, {SEED}, 1.0, False, device='cpu',\n"
        "        rate=4.0 if name == 'qwen-vqa-poisson' else None,\n"
        "        cfg_override=testing.small_config(name),\n"
        "        params_override=testing.SMALL_TRAFFIC, log=lambda s: None)\n"
        "    out[name] = [res['correct'], sorted(res['metrics'])]\n"
        "out['forbidden'] = run.forbidden_modules()\n"
        "out['repro_torch'] = 'repro_torch' in sys.modules\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("forbidden") == []
    assert out.pop("repro_torch") is True
    bench = spec.benchmark()
    for name, (correct, metrics) in out.items():
        assert correct, name
        assert metrics == sorted(m["name"] for m in spec.metrics_for(
            bench, name, False)), name


def test_trace_run_reads_the_host_side_layer_metrics():
    res = run.run_cell("qwen-vqa-poisson", SEED, 2.0, True, device="cpu",
                       rate=6.0, cfg_override=testing.small_config(
                           "qwen-vqa-poisson"),
                       params_override=testing.SMALL_TRAFFIC, **QUIET)
    assert res["correct"]
    m = res["metrics"]
    # the device-trace metrics need the card; the host-side ones are read
    for name in ("runtime.wan_ms", "scheduler.score_ms", "policy.cloud_pct",
                 "engine.prefill_ms", "engine.decode_step_ms.poisson"):
        assert name in m and m[name]["value"] >= 0, name
    assert "flash_attention_roofline" not in m
    assert 0 <= m["policy.cloud_pct"]["value"] <= 100


def _alter_token(built):
    """A token altered where it is produced: the fused block's first live
    token of every block, shifted by one."""
    for eng in built.engines.values():
        fused = eng._fused

        def broken(tokens, positions, budgets, teff, k, rids, _f=fused,
                   _v=eng.cfg.vocab_size):
            out = fused_out = _f(tokens, positions, budgets, teff, k, rids)
            live = np.flatnonzero(np.asarray(budgets) > 0)
            if live.size:
                out = fused_out.copy()
                out[live[0], 0] = (out[live[0], 0] + 1) % _v
            return out
        eng._fused = broken


def _state_unchanged(built):
    """A decode step that returns its state unchanged: the logits are
    computed, but the new K/V rows and positions never land in the cache."""
    import copy

    for eng in built.engines.values():
        model = eng.model
        step = model.decode_step

        def broken(params, cache, batch, ctx=None, _s=step):
            logits, _ = _s(params, copy.deepcopy(cache), batch, ctx=ctx)
            return logits, cache
        model.decode_step = broken


def _half_batch(built):
    """Half of the batch left out: the second half of a block's live slots
    get the first live slot's tokens instead of their own."""
    for eng in built.engines.values():
        fused = eng._fused

        def broken(tokens, positions, budgets, teff, k, rids, _f=fused):
            out = _f(tokens, positions, budgets, teff, k, rids).copy()
            live = np.flatnonzero(np.asarray(budgets) > 0)
            for i in live[(len(live) + 1) // 2:]:
                out[i] = out[live[0]]
            return out
        eng._fused = broken


def _score_altered(built):
    """An answer altered where it is produced: every image score off by
    one thousandth."""
    sched = built.server.scheduler
    score = sched.score

    def broken(request):
        out = score(request)
        if "image" in out:
            request.modalities["image"].complexity = out["image"] + 1e-3
            out["image"] += 1e-3
        return out
    sched.score = broken


def _all_to_edge(built):
    """A policy that keeps every modality on the edge, whatever its score
    and the system's state."""
    policy = built.server.scheduler.policy
    local = policy.topology.default_local.name
    policy._route_modality = lambda *a, **k: local


def _wan_free(built):
    """A WAN model that charges nothing for a transfer."""
    built.server.runtime._link_seconds = lambda *a, **k: 0.0


FAULTS = {"token_altered": _alter_token, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch, "score_altered": _score_altered,
          "all_to_edge": _all_to_edge, "wan_free": _wan_free}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS + [CLOSED["name"]])
def test_a_broken_timed_path_is_not_correct(name, fault):
    if fault == "half_batch" and name == "qwen-vqa-poisson":
        kw = {"rate": 8.0}  # enough load that blocks hold several slots
    else:
        kw = {}
    res = _run(name, before_window=FAULTS[fault], **kw)
    assert res["correct"] is False, res["checks"]
