"""Where a warm fused decode block spends its time, per tier, at full width.

Builds the ``edge-cloud`` pair at the published widths (bf16, random
weights from the per-tier seeds), fills each tier's slots with requests of
a fixed prompt length plus the vision patches, runs one untimed step
(admission + prefill + a block), times the next fused block of
``fused_steps`` decode steps, and profiles the one after. Prints both wall
clocks, the kernel time ``torch.profiler`` recorded (and so the device's
idle share) and the kernels that took the most device time.

    python -m repro_torch.launch.profile            # needs one CUDA device
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.config import ServingConfig, get_topology
from repro_torch.serving.tiers import build_cluster_engines


def profile_block(eng, prompt_len: int, top: int) -> None:
    cfg = eng.cfg
    rng = np.random.default_rng(7)
    slots = eng.serving.max_batch
    for rid in range(slots):
        extras = {}
        if cfg.frontend == "vision_stub":
            extras["patches"] = rng.standard_normal(
                (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        eng.submit(rid, rng.integers(4, cfg.vocab_size, prompt_len)
                   .astype(np.int32), max_new=4 * eng.fused_steps,
                   extras=extras)
    eng.step()  # admission + prefill + a first block, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()  # one block without the profiler
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_until_drained()
    # kernel events only: a CPU op's self device time repeats its kernels'
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{cfg.name}: fused block ({slots} slots x {eng.fused_steps} "
          f"steps, context ~{prompt_len + cfg.num_patches}): wall "
          f"{wall_plain * 1e3:.2f} ms unprofiled, {wall * 1e3:.2f} ms "
          f"profiled; device busy {busy * 1e3:.2f} ms, idle share "
          f"{1 - busy / wall:.3f} of the profiled block")
    if not rows:
        print("  the profiler recorded no device time")
    for dev_us, key, n in sorted(rows, reverse=True)[:top]:
        print(f"  {dev_us / 1e3:9.3f} ms {dev_us / 1e6 / busy:6.1%} "
              f"x{n:<6d} {key[:100]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompt-len", type=int, default=100)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    sv = ServingConfig(max_batch=4, max_seq=512, paged=True, kv_page_size=64,
                       fused_steps=8)
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    engines = build_cluster_engines(get_topology("edge-cloud"), sv,
                                    dtype="bfloat16", device="cuda",
                                    full_width=True)
    for eng in engines.values():
        profile_block(eng, args.prompt_len, args.top)


if __name__ == "__main__":
    main()
