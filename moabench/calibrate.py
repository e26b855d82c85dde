"""Readings that the limits of ``correct`` are set from.

Runs a cell's whole path (set-up, a short window at the cell's own load,
the reference) on many seeds in one process, and on the first
``--control-seeds`` of them also the control: the reference in the
program's place one precision below the configuration's. Prints one JSON
line a seed, then the largest program reading and the smallest control
reading of each number.

    python3 moabench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 12 --first-seed <n>
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def readings(workload: str, seeds, seconds: float, control_seeds: int,
             device: str = "cuda", cfg_override=None, log=print):
    import torch

    from moabench import run

    prog, ctrl = {}, {}
    quiet = {"end_to_end": [], "per_layer": []}
    for i, seed in enumerate(seeds):
        res = run.run_cell(workload, seed, seconds, False, device=device,
                           cfg_override=cfg_override, bench=quiet,
                           controls=i < control_seeds,
                           log=lambda s: None)
        nums = {k: v["value"] for k, v in res["checks"].items()}
        log(json.dumps({"seed": seed, "correct": res["correct"],
                        "program": nums, "control": res.get("control")}))
        for k, v in nums.items():
            prog[k] = max(prog.get(k, 0.0), v)
        for k, v in (res.get("control") or {}).items():
            ctrl[k] = min(ctrl.get(k, float("inf")), v)
        del res
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return prog, ctrl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=1 << 31)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    from moabench import run

    run._caches()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    prog, ctrl = readings(args.workload, seeds, args.seconds,
                          args.control_seeds,
                          log=lambda s: print(s, flush=True))
    print(json.dumps({"program_max": prog, "control_min": ctrl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
