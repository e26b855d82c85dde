"""Run one cell of the benchmark: set-up, one measured window, the check
of ``correct``, and one JSON result line.

    python3 moabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes both tiers' weights on the card from the seed, builds the
engines and the server, draws the traffic's image pool and runs the mix's
warm-up burst (a closed loop's ramp instead). The window then runs the
cell's traffic for ``--seconds``; an open loop drains after it. The
program's state is freed, the float32 reference re-scores what the window
served, and the last line of standard output is the result; the numbers
compared, each beside its limit, are also the last lines of standard
error. With ``--trace 1`` the profiler records the card over the window
and the line carries the cell's per-layer metrics instead of its
end-to-end ones. ``--rate`` overrides an open loop's offered rate (for the
sweep that finds the knee); the cells never use it.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    nothing that would load JAX."""
    cache = ROOT / "build" / "moabench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclass
class Run:
    """What the metric readers read (``metrics/*.py``)."""

    archs: Dict
    remote: str
    setup_s: float
    t0: float
    t1: float
    requests: List[Dict]
    token_t: List[float]
    c0: Dict
    c1: Dict
    probe: object
    drain_end: float
    trace: Optional[object] = None


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def environment(torch) -> Dict:
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0]}
    if torch.cuda.is_available():
        out["device"] = torch.cuda.get_device_name(0)
        try:
            out["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
                 "clocks.sm,clocks.max.sm,temperature.gpu",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            out["nvidia_smi"] = f"unavailable: {e}"
    return out


def requests_of(drv, probe, window, loop: str, cfg: Dict) -> List[Dict]:
    """One record per request of the window: its timings on the harness's
    own stream clock, its outcome, and what the check needs. A request
    served on a remote tier gets the modelled return leg to the user added
    (its first token's to the TTFT, the whole answer's to the latency), as
    the configuration's WAN states it."""
    from moabench.reference.policy import downlink_seconds

    rt = drv.server.runtime
    tiers = {t["name"]: t for t in cfg["tiers"]}
    out = []
    for rid in window.rids:
        s = drv.sent[rid]
        r = drv.resolved.get(rid)
        toks = probe.tokens.get(rid, [])
        finished = r is not None and not r.failed
        # open loop: unresolved after the drain counts as failed
        failed = (r is not None and r.failed) or (loop == "open"
                                                  and r is None)
        first, last = probe.first.get(rid), probe.last.get(rid)
        inf = float("inf")
        if finished:
            tier = tiers[r.tier]
            ttft = first - s.due + downlink_seconds(tier, 1, cfg["wan"])
            lat = last - s.due + downlink_seconds(tier, len(toks),
                                                  cfg["wan"])
            tpot = (lat - ttft) / (len(toks) - 1) if len(toks) > 1 else 0.0
        else:
            ttft = lat = tpot = inf
        mods = s.request.modalities
        img = mods.get("image")
        rec = rt.records.get(rid)
        out.append({
            "rid": rid, "due": s.due, "finished": finished, "failed": failed,
            "tier": r.tier if r is not None else None,
            "ttft": ttft, "latency": lat, "tpot": tpot,
            "first": first, "last": last,
            "wan_s": rec.wan_s if rec is not None else None,
            "max_new": s.spec.max_new, "ids": s.ids,
            "image_index": s.spec.image,
            "image_hw": tuple(img.data.shape) if img is not None else None,
            "c_image": img.complexity if img is not None else None,
            "c_text": mods["text"].complexity,
            "tokens": list(toks),
            "result_tokens": list(r.tokens) if r is not None else None})
    return out


def decided_of(drv, probe) -> List[Dict]:
    """Every decision of the run (the warm-up's too), in the order the
    program made them, with what the check of routes and WAN needs: the
    request's arrival, the sizes of its modalities, its WAN time once its
    payload landed, and the tier that served it."""
    rt = drv.server.runtime
    out = []
    for d in probe.decisions:
        s = drv.sent[d["rid"]]
        sizes = {}
        for m, mod in s.request.modalities.items():
            sizes[m] = (("image", int(mod.data.size)) if mod.kind == "image"
                        else ("text", len(s.ids)))
        rec = rt.records.get(d["rid"])
        landed = rec is not None and any(e[0] == "enqueue"
                                         for e in rec.events)
        r = drv.resolved.get(d["rid"])
        out.append(dict(d, arrival=s.request.arrival_s, sizes=sizes,
                        wan_s=rec.wan_s if landed else None,
                        served=(r.tier if r is not None and not r.failed
                                else None)))
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", rate: Optional[float] = None,
             cfg_override: Optional[Dict] = None,
             bench: Optional[Dict] = None, log=print,
             before_window=None, controls: bool = False,
             params_override: Optional[Dict] = None,
             cell_override: Optional[Dict] = None) -> Dict:
    """One run; returns the result (the last line's object). The tests
    call it on the CPU with a reduced configuration (``cfg_override``) and
    smaller traffic (``params_override``, over the mix's parameters);
    ``before_window(built)`` may break the program under test (the fault
    tests); ``cell_override`` stands for the cell's file. With ``controls``, the result also carries the control's
    numbers under ``"control"`` (``calibrate.py``)."""
    import numpy as np
    import torch

    from moabench import readers, serve, spec
    from moabench.reference import check
    from moabench.trace import DeviceTrace
    from moabench.traffic.generator import Traffic, load_mix

    cell = cell_override or spec.cell(workload)
    cfg = cfg_override or spec.config(cell["config"])
    mix = load_mix(cell["traffic"])
    params = dict(cell.get("params", {}), **(params_override or {}))
    if rate is not None:
        params["rate"] = rate
    traffic = Traffic(mix, params, seed)
    bench = bench if bench is not None else spec.benchmark()
    limits = cell["limits"]

    stages = {"imports": time.monotonic() - T_START}
    built = serve.build(cfg, seed, device)
    stages["build"] = time.monotonic() - T_START
    probe = serve.Probe()
    probe.attach(built)
    images = traffic.images()
    stages["images"] = time.monotonic() - T_START
    drv = serve.Driver(built, traffic, images)
    drv.warm()
    stages["warm"] = time.monotonic() - T_START
    if trace:
        probe.attach_detail(built)
    if before_window is not None:
        before_window(built)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dtrace = DeviceTrace() if trace and device == "cuda" else None
    setup_s = time.monotonic() - T_START
    log("setup: " + json.dumps(dict(stages, window_start=setup_s)))
    if traffic.loop == "open":
        window = serve.open_loop(drv, seconds, dtrace)
    else:
        window = serve.closed_loop(drv, seconds, dtrace, probe)
    if device == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    else:
        peak = 0
    reqs = requests_of(drv, probe, window, traffic.loop, cfg)
    decided = decided_of(drv, probe)
    run = Run(archs=built.archs, remote=built.remote,
              setup_s=setup_s, t0=window.t0, t1=window.t1,
              requests=reqs, token_t=probe.token_t, c0=window.counters0,
              c1=window.counters1, probe=probe,
              drain_end=window.drain_end, trace=dtrace)
    split = {}
    for r in reqs:
        split[r["tier"] or "unresolved"] = split.get(r["tier"] or
                                                     "unresolved", 0) + 1
    late = [x[3] for x in probe.scores if x[0] in set(window.rids)]
    on_time = sum(1 for r in reqs if r["latency"] <= traffic.slo_s)
    backlog = sum(1 for r in reqs
                  if not r["finished"] or r["last"] > window.t1)
    log("window: " + json.dumps({
        "loop": traffic.loop, "rate": traffic.mix.get("rate"),
        "seconds": window.t1 - window.t0, "requests": len(reqs),
        "tier_split": split, "on_time_share": on_time / max(1, len(reqs)),
        "unresolved_at_window_end": backlog,
        "generator_late_ms_p50": (1e3 * float(np.median(late))
                                  if late else None),
        "generator_late_ms_max": 1e3 * float(max(late)) if late else None,
        "tail_samples": len(reqs), "drain_s": window.drain_end - window.t1,
        "tokens_per_step": {
            t: (readers.counter_delta(run, f"{t}.decode_tokens")
                / max(1, readers.counter_delta(run, f"{t}.steps")))
            for t in built.engines},
        "tau_at_window_end": (probe.decisions[-1]["taus"]
                              if probe.decisions else None)}))

    # -- the program's state goes; the reference re-scores what it served
    weights, archs = built.weights, built.archs
    drv.server.close()
    drv.server = built.server = None
    built.engines = {}
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    picked = check.sample(reqs, seed, int(cell["sample_tokens"]),
                          int(cell["sample_max_requests"]))
    t_ref = time.monotonic()
    nums = check.numbers(reqs, picked, archs, weights, images, device,
                         decided, probe.observations, cfg)
    correct, rows = check.verdict(nums, limits)
    control = (check.control_numbers(reqs, picked, archs, weights, images,
                                     device) if controls else None)
    log("reference: " + json.dumps({
        "seconds": time.monotonic() - t_ref,
        "sampled": {t: [len(r["tokens"]) for r in rs]
                    for t, rs in picked.items()}}))

    names = spec.metrics_for(bench, workload, trace)
    metrics = {}
    if dtrace is not None:
        t_read = time.monotonic()
        dtrace.read()
        log("trace: " + json.dumps({
            "read_s": time.monotonic() - t_read,
            "device_intervals": int(len(dtrace.intervals)),
            "kernel_names": len(dtrace.kernels)}))
    for m in names:
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(reqs),
              "failed": sum(1 for r in reqs if r["failed"]),
              "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.top_ops(10),
                               "idle_gaps": dtrace.idle_gaps(probe.spans, 10)}
    if control is not None:
        result["control"] = control
    result["checks"] = {name: {"value": val, "limit": lim}
                        for name, val, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)
    _caches()
    import torch

    from moabench import spec

    cell = spec.cell(args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print("env: " + json.dumps(environment(torch)), flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), rate=args.rate,
                      log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
