#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero and no phase catches its own:
  1. device name, count, and nvidia-smi's name and power limit;
  2. build every CUDA source with nvcc (one process per source, in
     parallel) and print each kernel instance's registers and spilled
     bytes from -Xptxas -v (and the warp-specialised flash kernel's dynamic
     shared memory); fails if a bf16 instance spills;
  3. hold the image-statistics kernel against its plain version at the
     serving, degenerate, flat and 1024x1024 shapes (histogram exact, the
     five scores within 1e-6, repeated calls bitwise equal) and time it
     from a replayed CUDA graph beside an empty kernel's launch floor;
     hold each attention kernel against its plain PyTorch version, in f32
     and bf16, at the serving shapes and at head dims 32 and 64, with an
     all-masked slot, a window, a ragged context or sequence, a
     context-bucket view, a non-causal case and non-contiguous q (decode
     also at T = 1, 33, 97, 300 and 4096, pages of 16 and 64, one live
     split among masked ones, a forced single split, and dense at B=1,
     the draft block's batch), and at the zoo's other attention shapes
     (hd 96 32/32, hd 192 96/8, hd 256 16/1 with a wrapped ring of 2048
     rows under window 2048 and flash at S=2500 under that window, hd 128
     64/4, whisper-small's hd 64 12/12: decode over 1500 frames with the
     query at 10**9 and over a 448-row self cache, flash non-causal at
     S=1500 and causal at S=16, the small hd at group 16); time the
     kernel, the plain version and, where one PyTorch call computes the same
     function, that call (the port never calls it). Decode is timed as the
     decode loop meets it: launches rotate over a stacked cache larger than
     the L2, the device time per call comes from a replayed CUDA graph
     (which proves the kernel can be captured; its outputs must equal eager
     calls), with SDPA timed the same way in turns and the eager wall per
     call beside it, at T=384 and T=4096, and at phi-3-vision's,
     recurrentgemma's, qwen3-moe's and whisper-small's decode and prefill
     shapes (the encoder's non-causal S=1500 against SDPA, is_causal=False).
     bf16 flash must run the wgmma kernel at hd 64, 96 and 128, the
     warp-specialised one (flash_bf16_ws_kernel) at hd 192 and 256 and the
     mma.sync one at hd 32, and every bf16 case also holds to its tile loop
     at that kernel's tile sizes (8e-3) and repeats bitwise; every lean bf16
     decode instance also holds to its bf16-P split mirror (8e-3). Each
     flash shape prints the exponentials' bound beside the bound (and, at
     recurrentgemma's windowed shape, torch's compiled flex_attention with
     a sliding-window block mask beside the boolean-mask SDPA); nemotron's
     hd 192 96/8 is timed at R=1 S=4096 and R=4 S=512, and the
     warp-specialised kernel pinned at hd 128 in turns with the routed
     wgmma kernel, a record. With ``--parent-csrc DIR`` the attention
     kernels built from DIR (another tree's csrc/) are timed in turns with
     this tree's at every timed shape. The paged kernel with extents
     (``lens``) is held to its plain version (and, lean, its split mirror
     at the device's split length) at extents 0, 1, a page - 1, a page, a
     split +- 1 and T, a dead slot exactly 0, and without them bitwise to
     the parent's kernel; it is timed at the benchmark cells' ragged decode
     (phi-3-vision B 32 T 4096 with 12 live slots of 2650-3960 rows, the
     Qwen tiers at T 2048 with 3 live) and at full occupancy, with
     extents, without, on the parent's kernel and under each plan of
     EXTENT_PLANS, beside the live rows' byte bound;
  4. at full width and depth (qwen2-vl-2b edge, qwen2.5-vl-7b cloud, bf16,
     random weights from a seed): one prefill batch of the serving shapes
     through attn_impl "auto" and "cuda" on the same weights (logit
     difference, argmax agreement, wall time), then serve 8 requests of the
     launcher's mix through ClusterServer on the paged KV pool with
     attn_impl "cuda" (prefill through the flash-attention kernel),
     then time the two-step image score against the fused launch and the
     copy of a numpy image to the card;
  5. the "auto" models on the dense KV pool, 2 requests (plain prefill);
     both serves print the score time per request and fail unless each
     scored image made one kernel launch whose c_img matches the plain CPU
     path's (1e-6) with the same route;
  6. at reduced size in f32, attn_impl and decode_impl "cuda" and "torch"
     give the same tokens, paged and dense, with prompts whose length falls
     on and off a multiple of 64;
  8. warm serving and migration: (a) at full width (bf16, paged, attn_impl
     "cuda") 3 sessions of 3 turns with an image each, then 4 text
     requests sharing a long prefix, through ClusterServer(sessions=True):
     fails unless a turn resumed, a prefix hit shared its pages copy-free,
     every warm admission was charged only its suffix and the drained
     pools' references are the prefix stores'; prints each tier's counts,
     the warm against the cold prefill charge and one resumed turn's
     first-token logits against a cold prefill; (b) a full-width
     qwen2-vl-2b request moved paged -> dense and dense -> paged through
     the wire (size printed, leaves bitwise) finishes with the tokens of
     the same move made in process, its source blocks' tokens those it
     decodes alone on the source kind (the paged decode's extents round a
     bf16 sum apart from the dense kernel's: the tokens both kinds share
     alone are printed); (c) at reduced size in f32 with the
     kernels ("cuda"), a prefix hit and a resumed session equal cold
     serving, paged and dense, and a temperature-0.7 migration equals the
     unmigrated run;
  9. speculative decoding and process replicas: (a) at full width (bf16,
     paged, attn_impl "cuda") the launcher's mix through
     ClusterServer(spec=edge:cloud, k=4), failing unless 2+ requests
     speculated, verify rounds ran, the drained pools hold no page and the
     cloud's decode_tokens are its committed tokens; then a self-draft
     pair on qwen2.5-vl-7b at k = 4 and 8, printing acceptance, agreement
     with target-only decode, the verify round's time against a fused
     block of k steps on the slot, the draft block's and the draft-side
     sync's times, a round's whole cost per committed token against a fused
     step's, and the draft's dense decode-attention launches (phase 3 holds
     the dense kernel at the draft's batch-1 shapes); (b) at reduced size
     in f32 with the kernels, paged and dense, at temperature 0 and 0.7:
     perfect, garbage and partial drafts commit the fused tokens, and a
     two-engine co-drive drafts the draft engine's own fused tokens and
     commits the target's; (c) two spawned edge
     replicas on "cuda" give the tokens of local replicas, and a killed
     worker's rid is rescued by its sibling;
  10. the recurrent families: (a) recurrentgemma-9b at full width and
     depth (bf16, random weights): the 3000-token prompt's prefill logits
     under attn_impl "cuda" against "auto", then three requests (64- and
     200-token prompts with 32 new tokens, the 3000-token one with 64) on a
     TierEngine under "cuda"; fails unless the flash kernel and the dense
     decode kernel launched at hd 256, group 16 (window 2048, the ring
     wrapped); (b) mamba2-2.7b at full width and depth, four requests of 32
     new tokens, no attention kernel launched; (c) reduced f32 hybrid and
     ssm engines on the card (kernels) decode the tokens of the same
     weights on the CPU (plain versions), fused and per token, paged and
     dense, and a resumed session and speculative drafts (perfect,
     garbage, partial) commit the fused tokens;
  11. (a) phi-3-vision-4.2b at full width and depth (hd 96, MHA) at its
     processor's 2509 image tokens (4096-wide projector inputs), four
     requests of the launcher's mix through ClusterServer on paged pools of
     4096-row slots under "cuda"; fails unless both attention kernels
     launched at hd 96, or if a prefill group's peak device memory above
     the resident set passes one layer's K/V plus the group's activations
     (``prefill_bytes_per_position``) by more than 2 GB (the paged prefill
     writes each layer's K/V into the pages; the capacity-wide copy it
     replaced held every layer's K/V twice over); then a two-row group
     prefilled straight into the pages against the capacity-wide copy
     scattered through the same tables, bf16 on the card: every page but
     the null page, pos, index and logits bitwise equal, both timed; (b) nemotron-4-340b at its published widths (hd 192,
     96/8 heads, vocab 256000), depth cut to 2 of 96 layers (16.4 B
     parameters, bf16): a 2048-token prefill under "cuda" against "auto"
     (finite, within a tenth of the largest |logit|, argmax equal; phase 10
     (a) holds recurrentgemma's prefill to the same gate), then two
     requests on a paged engine, which must launch flash and paged decode
     at (hd 192, group 12);
  12. (first reads the device memory still held from the phases before,
     with no collection, and fails above 1 GiB: a dropped engine or
     ClusterServer frees itself) the MoE and encoder-decoder families:
     (a) qwen3-moe-235b-a22b at full
     width, its depth cut to 8 of 94 layers (bf16, random weights, moe_impl
     "auto" = dense): a 320-token prefill under "cuda" against "auto" and
     under moe_impl "dropping" beside "dense" (CUDA events), four requests
     on a paged TierEngine under "cuda", failing unless the flash and the
     paged decode kernel launched at (hd 128, group 16), each request had
     its own prefill group and the drained pool holds no page; one decode
     step split into the MoE blocks and attention; (b) whisper-small at full
     width and depth: encoder output and prefill logits "cuda" against
     "auto", four requests (1500 x 80 frames each) on a dense and on a
     paged TierEngine, failing unless the flash kernel launched non-causal
     at (hd 64, group 1, S=1500) and the dense decode kernel at T=1500 (the
     cross read, query at 10**9) and at the 448-row self cache; (c) reduced
     f32 qwen3-moe, kimi-k2 and whisper-small engines on the card decode
     the CPU's tokens (plain versions), fused and per token, paged and
     dense; for the MoE pair a resumed session and a paged <-> dense
     migration equal cold serving;
  13. training: (a) qwen2-vl-2b at full width and depth in float32 (1.546
     B parameters, random weights, f32 AdamW state) through
     ``make_train_step`` at the launcher's B=8, S=256: one vlm batch's
     loss under remat "dots", "full" and "none" on the same weights (equal
     to 1e-5, every gradient leaf finite and nonzero), then 3 steps under
     "dots", one each under "full" and "none", 2 at accum=2 and one on a
     vlm batch with 256 patches, printing each step's wall (CUDA events),
     tokens/s, peak memory, loss, grad_norm, lr and model FLOPs as a share
     of the f32 peak (TF32 off); fails unless every value is finite, every
     leaf moved in step 1, peak memory falls none > dots > full, no hand
     kernel launched, and attn_impl "cuda" refuses ``loss``; (b) the
     training launcher on the card (reduced qwen2-vl-2b, 12 steps,
     checkpoints at 6 and 12), then again from its step-6 checkpoint: the
     step-12 checkpoints agree (1e-6); in process, the card's 12-step loss
     history against the CPU's from the same weights (1e-4), a resume from
     step 6 against the uninterrupted losses (1e-6), and the card's
     checkpoint restored on the CPU with equal leaves;
  14. the distribution layer, on a one-rank NCCL (1, 1) ("data", "model")
     mesh over the card: (a) full-width qwen3-moe (8 of 94 layers, bf16): a
     320-token prefill on the mesh (moe_impl "auto", the expert-parallel
     dropping path) bitwise equal to the mesh-free dropping path, two runs
     of each bitwise equal, timed in turns; decode2d on the mesh against
     the mesh-free one on a B=4 decode step's input; (b) the full-width
     qwen2-vl-2b f32 Trainer on the mesh against the mesh-free one, two
     steps each from the same seed, losses and grad norms within 1e-5,
     step walls in turns; (c) a reduced trainer's checkpoint restored onto
     the mesh by ``elastic_restore_tree`` bitwise equal to
     ``Checkpointer.restore``; (d) ``python -m repro_torch.launch.dryrun``
     on the host's CPU (started before phase 13, beside it and (a)-(c)):
     qwen3-0.6b train_4k on the 256- and 512-rank production meshes and
     qwen3-moe
     decode_32k with --moe-2d, each record printed (per-device FLOPs,
     argument, collective and HBM bytes, the H100 data-sheet roofline,
     the cell's wall). No hand kernel may launch on a mesh;
  15. the card against the JAX package itself, from its results recorded
     on the CPU (tests/data/jax_reference.json and .npz, read with numpy
     and repro_torch only; ``repro_torch.replay``): (a) each kernel against
     the recorded Pallas output at tests/test_kernels.py's tolerances
     (histogram exact, a fully masked decode slot against the recorded XLA
     output), the largest error printed per kernel and dtype; (b) every
     arch of the zoo, reduced f32 with the record's drawn weights, on
     engines under attn_impl and decode_impl "cuda" (TF32 off), paged and
     dense, fused 1 and 8 steps: tokens exactly JAX's (a miss prints the
     request, the step and JAX's margin there), the fused blocks of every
     family but ssm and hybrid replayed from CUDA graphs; (c) the edge-cloud
     ClusterServer case with the fused image kernel scoring: routes, tiers
     and tokens equal JAX's; (d) each recorded JAX slot injected into a
     paged and a dense engine finishes with JAX's tokens. Each case must
     have launched its kernels (ssm none of the attention kernels; encdec
     and hybrid the dense decode kernel only);
  16. the fused decode block of both Qwen tiers at full width (bf16, paged
     pool of 32 slots x 4096 rows in pages of 256, every slot live at
     context 1400, bucket 1536, k 8: the benchmark cell's decode shape),
     eager (the engine's graphs off) against CUDA graphs on one engine, in
     turns after two warm blocks each: block time by CUDA events, the host
     issue time by the engine's span, tokens equal in both modes; the
     graphed block with the extents dropped at the model's paged decode
     dispatcher and on again (nothing to skip at full occupancy: the
     control of the paged kernel's extents), the rows the live slots
     attended against the grid's; then one
     turn of each under the traced benchmark run's profiler;
  7. ``python -m repro_torch.launch.serve --requests 4 --max-new 4``, then
     with ``--sessions 2 --turns 2 --prefix-cache-mb 64 --migrate``, which
     must print its ``sessions:`` line (phase 8 (d)), with ``--speculate
     edge:cloud --draft-k 4`` (its ``speculation:`` line) and with
     ``--replicas edge=2 --transport process`` (its ``replicas:`` lines;
     phase 9 (d)). Phase 7 runs last.

The line before the last is the kernels' JSON record (launches: phases 4,
5, 8, 9, 10, 11, 12 and 15 (b)-(d) together, phases 13 and 14 launching
none; each attention
kernel's zoo shapes timed under "shapes", and every (dtype, hd, group)
held in phase 3 with its worst error under "instantiations"); the last
line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py                 # everything (one GPU)
    python3 chip_smoke.py --phases 1,2,3  # a subset, for debugging
    python3 chip_smoke.py --phases 1,2,3 --parent-csrc build/parent_csrc
        # phase 3 beside the parent's kernels, after
        # git show HEAD:src/repro_torch/csrc/<stem>.cu > build/parent_csrc/<stem>.cu
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 non-tensor, bf16 dense


MUFU_EX2_PER_CLOCK = 16  # exp2 results a clock an SM (sm_90)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sm_count() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_sm_hz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm), in Hz."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi clocks.max.sm: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name} x{count} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return name, count, card


def _ptxas_entries(log: str):
    """``{kernel instance: (registers, spill bytes)}`` from ``-Xptxas -v``
    output; an instance is named ``base<template args>`` (e.g.
    ``flash_bf16_wgmma_kernel<64>``, ``decode_bf16_kernel<256,16,1,0>``)."""
    entries, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", line)
        if m:
            mangled = m.group(1)
            # the last <length><identifier> of the nested name: the kernel's
            i, base = (3 if mangled.startswith("_ZN") else 2), mangled
            while i < len(mangled) and mangled[i].isdigit():
                j = i
                while mangled[j].isdigit():
                    j += 1
                base, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = base + (f"<{','.join(args)}>" if args else "")
            continue
        if name is None:
            continue
        regs, spill = entries.get(name, (None, 0))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
        entries[name] = (regs, spill)
    return entries


def phase_build():
    from repro_torch.kernels import runtime

    t0 = time.perf_counter()
    logs = runtime.build_all()
    for src in runtime.sources():
        runtime.load(src.stem)
    print(f"built {len(runtime.sources())} sources in "
          f"{time.perf_counter() - t0:.1f}s into {runtime.build_dir()}")
    spilled = []
    for stem, log in sorted(logs.items()):
        for name, (regs, spill) in sorted(_ptxas_entries(log).items()):
            print(f"  [{stem}] {name}: {regs} registers, {spill} bytes "
                  f"spilled")
            if "bf16" in name and spill:
                spilled.append(name)
    if spilled:
        fail(f"phase 2: bf16 kernel instances spill: {spilled}")
    import torch

    from repro_torch.kernels import flash_attention as fa
    ws = fa._kernel_id("flash_bf16_ws_kernel")  # hd 128: the record's pin
    for hd in (128, 192, 256):
        smem = fa._lib().flash_attention_smem_bytes(
            fa._DTYPES[torch.bfloat16], hd, ws)
        print(f"  [flash_attention] flash_bf16_ws_kernel<{hd}>: {smem} "
              f"bytes of dynamic shared memory")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _rand(shape, dtype, gen, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _image_cases(gen):
    """(label, (B, H, W) f32 batch on the card, real-valued?) for phase 3:
    integer pixels at the serving and test shapes, degenerate images, the
    paper's 1024x1024 reference resolution, flat images (every pixel of a
    warp in one bin) and the launcher's own 64x64 image."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_image

    def rand(shape):
        return torch.randint(0, 256, shape, generator=gen,
                             device="cuda").float()

    cases = [(str(s), rand(s), False) for s in (
        (1, 64, 64), (2, 33, 65), (3, 128, 96), (1, 256, 256), (1, 1, 1),
        (1, 1, 7), (1, 7, 1), (1, 1024, 1024), (8, 1024, 1024))]
    for v in (255.0, 0.0):
        cases.append((f"flat {v:g} (1, 1024, 1024)", torch.full(
            (1, 1024, 1024), v, device="cuda"), False))
    img = make_image(np.random.default_rng(0), 0.7, 64, 64)
    cases.append(("launcher 64x64", torch.as_tensor(
        img, dtype=torch.float32, device="cuda")[None], True))
    return cases


# The five scores against image_complexity_from_stats on the plain stats.
SCORE_TOL = 1e-6


def check_image(records):
    import torch

    from repro_torch.config import ComplexityConfig
    from repro_torch.kernels.image_complexity import (
        SCORE_KEYS, image_complexity_cuda, image_stats_cuda,
        image_stats_grid, image_stats_plain)
    from repro_torch.kernels.ops import image_complexity_from_stats

    gen = torch.Generator(device="cuda").manual_seed(0)
    cc = ComplexityConfig()
    worst = 0.0
    # The kernel sums in double, the plain version in f32. On integer-valued
    # pixels every stencil value is an integer, so the f32 sums are exact up
    # to 2^24 and rtol 2e-5 / atol 1e-3 hold; on the launcher's real-valued
    # images the near-zero Laplacian sum cancels, and its f32 rounding is
    # bounded by 2e-7 * sum|lap| <= 2e-7 * 8 * 255 * H * W.
    cases = _image_cases(gen)
    for label, imgs, real in cases:
        got, want = image_complexity_cuda(imgs, cc), image_stats_plain(imgs)
        again = image_stats_cuda(imgs)
        torch.cuda.synchronize()
        if not torch.equal(got["hist"], want["hist"]):
            fail(f"image_stats histogram differs at {label}")
        b, h, w = imgs.shape
        for k in ("sobel_sum", "lap_sum", "lap_sq_sum"):
            atol = 2e-7 * 8 * 255 * h * w if (real and k == "lap_sum") else 1e-3
            if not torch.allclose(got[k], want[k], rtol=2e-5, atol=atol):
                fail(f"image_stats {k} at {label}: {got[k]} vs {want[k]}")
            if not torch.equal(got[k], again[k]):
                fail(f"image_stats {label}: two eager calls differ in {k}")
        errs = {k: float((got[k] - want[k]).abs().max())
                for k in ("sobel_sum", "lap_sum", "lap_sq_sum")}
        scores = image_complexity_from_stats(want, h, w, cc)
        s_err = max(float((got[k] - scores[k]).abs().max())
                    for k in SCORE_KEYS)
        if s_err > SCORE_TOL:
            fail(f"image_complexity scores at {label}: max |err| {s_err}")
        if real:
            worst = max(errs.values())
        rows, bands = image_stats_grid(b, h, w)
        print(f"  image_stats {label} (grid {bands}x{b}, {rows} rows a "
              f"band): hist exact, |err| "
              + ", ".join(f"{k} {e:.3g} of {float(want[k].abs().max()):.6g}"
                          for k, e in errs.items())
              + f"; scores |err| {s_err:.3g} (tol {SCORE_TOL}); two calls "
              f"bitwise equal")
    # timing: at 64x64 sixteen calls on one input (a freshly copied request
    # image sits in L2; sixteen calls a graph spread the graph's own launch
    # cost); at 1024x1024, launches rotate over inputs larger than the 50 MB
    # L2
    big = [torch.randint(0, 256, (1, 1024, 1024), generator=gen,
                         device="cuda").float() for _ in range(16)]
    batch = [torch.randint(0, 256, (8, 1024, 1024), generator=gen,
                           device="cuda").float() for _ in range(4)]
    flat = [torch.full((1, 1024, 1024), 255.0, device="cuda")
            for _ in range(16)]
    shapes, replayed = [], []
    for label, inputs in (("(1,64,64) x16 one input", [cases[0][1]] * 16),
                          ("(1,1024,1024) x16 rotated", big),
                          ("(8,1024,1024) x4 rotated", batch),
                          ("flat 255 (1,1024,1024) x16 rotated", flat)):
        shape, outs = time_image(label, inputs)
        shapes.append(shape)
        replayed.append((label, inputs, outs))
    # bitwise: a graph replay equals an eager call, and two eager calls agree
    for label, inputs, outs in replayed:
        for x, out in zip(inputs, outs):
            a, b = image_stats_cuda(x), image_stats_cuda(x)
            for k in out:
                if not torch.equal(a[k], b[k]):
                    fail(f"image_stats {label}: two eager calls differ in {k}")
                if not torch.equal(out[k], a[k]):
                    fail(f"image_stats {label}: graph replay differs from "
                         f"eager in {k}")
    print("  image_stats: graph replays equal eager calls and repeated eager "
          "calls agree, bitwise, at every timed shape")
    main = shapes[0]
    records["image_stats"] = {
        "name": "image_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/image_stats.cu",
        "replaces": "src/repro/kernels/image_complexity.py:66",
        "max_abs_err": worst, "ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "device_ms": main["device_ms"], "eager_ms": main["eager_ms"],
        "shapes": shapes}


def _empty_launch():
    """A zero-argument call that launches an empty one-block kernel through
    the same ctypes path as the statistics kernel (the launch floor)."""
    import ctypes

    import torch

    from repro_torch.kernels import runtime

    lib = runtime.load("image_stats")
    fn = lib.image_stats_empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        runtime.check(fn(1, torch.cuda.current_stream().cuda_stream),
                      "empty kernel")
    return launch


def time_image(label, inputs):
    """Time the statistics kernel on ``inputs`` (one call each, in order):
    device time per call from a replayed CUDA graph (the kernel, then an
    empty kernel launched the same way, in turns: kernel, empty, empty,
    kernel), the eager wall per call of both, and the plain version's
    device time from a graph. Returns the record and the first graph's
    outputs (for the bitwise check against eager calls)."""
    from repro_torch.kernels.image_complexity import (image_stats_cuda,
                                                      image_stats_plain)
    n = len(inputs)
    fns = [lambda x=x: image_stats_cuda(x) for x in inputs]
    empty = [_empty_launch()] * n
    replays = max(10, -(-320 // n))
    k1, outs = graph_time_ms(fns, replays)
    f1, _ = graph_time_ms(empty, replays)
    f2, _ = graph_time_ms(empty, replays)
    k2, _ = graph_time_ms(fns, replays)
    dev, floor = (k1 + k2) / 2, (f1 + f2) / 2
    rounds = max(2, -(-200 // n))
    eager = eager_time_ms(fns, rounds)
    eager_floor = eager_time_ms(empty, rounds)
    plain_ms = graph_time_ms([lambda x=x: image_stats_plain(x)
                              for x in inputs], 2)[0]
    b, h, w = inputs[0].shape
    bd, by = bound_ms(4.0 * b * h * w + 4.0 * b * (4 + 256 + 5),
                      30.0 * b * h * w, "float32")
    print(f"  image_stats {label}: device {dev * 1e3:.3f} us "
          f"({k1 * 1e3:.3f}, {k2 * 1e3:.3f}), launch floor (empty kernel) "
          f"{floor * 1e3:.3f} us, eager wall {eager * 1e3:.2f} us (empty "
          f"{eager_floor * 1e3:.2f}), plain device {plain_ms * 1e3:.2f} us, "
          f"bound {bd * 1e3:.4f} us ({by}), {bd / dev:.1%} of it")
    return {"shape": label, "device_ms": dev, "eager_ms": eager,
            "floor_ms": floor, "eager_floor_ms": eager_floor,
            "plain_ms": plain_ms, "bound_ms": bd, "bound_by": by,
            "share_of_bound": bd / dev}, outs


def graph_time_ms(fns, replays: int):
    """Device time per call: warm each zero-argument call, capture all of
    them (in order, one launch sequence each) into one CUDA graph, and
    replay it ``replays`` times between CUDA events. Returns the time per
    call and what the captured calls returned (valid after each replay).
    A call that cannot be captured raises, and the phase fails."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as PyTorch asks
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in fns]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(fns)), outs


def eager_time_ms(fns, rounds: int) -> float:
    """Wall per eager call (CUDA events around ``rounds`` passes over the
    calls after one warm pass): what a caller without a graph pays."""
    return cuda_time_ms(lambda: [fn() for fn in fns], iters=rounds,
                        warmup=1) / len(fns)


#: the parent tree's kernel libraries by source stem (``--parent-csrc``),
#: timed in turns with this tree's in phase 3
PARENT_LIBS = {}


def build_parent(csrc_dir: str) -> None:
    """Build another tree's ``csrc/*.cu`` (the parent commit's, unpacked by
    the caller) with the port's nvcc flags into ``build/parent_kernels/``,
    one process per source, and load them; their C entry points must have
    this tree's signatures (argtypes are copied from this tree's libraries)."""
    import ctypes

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import runtime

    out = os.path.join(ROOT, "build", "parent_kernels")
    os.makedirs(out, exist_ok=True)
    procs = []
    for stem in ("flash_attention", "decode_attention"):
        src = os.path.join(csrc_dir, f"{stem}.cu")
        lib = os.path.join(out, f"lib{stem}.so")
        procs.append((stem, lib, subprocess.Popen(
            [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for stem, lib, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            fail(f"parent kernel {stem}: nvcc exit {proc.returncode}\n{err}")
        parent = ctypes.CDLL(lib)
        ours = (fa if stem == "flash_attention" else da)._lib()
        fn = f"{stem}_launch"
        getattr(parent, fn).argtypes = getattr(ours, fn).argtypes
        getattr(parent, fn).restype = getattr(ours, fn).restype
        PARENT_LIBS[stem] = parent
    print(f"  built the parent's kernels from {csrc_dir} into {out}")


def _on_parent(stem: str, fns):
    """``fns`` run against the parent's library of ``stem`` (the kernel
    module's ``_lib`` swapped during each call, so a graph captures the
    parent's launches); None without ``--parent-csrc``."""
    import importlib

    lib = PARENT_LIBS.get(stem)
    if lib is None:
        return None
    mod = importlib.import_module(f"repro_torch.kernels.{stem}")

    def call(fn):
        own = mod._lib
        mod._lib = lambda: lib
        try:
            return fn()
        finally:
            mod._lib = own
    return [lambda fn=fn: call(fn) for fn in fns]


def time_in_turns(fns, sdpa, replays, parent=None):
    """Device time per call of ``fns`` and ``sdpa`` (and of ``parent``, the
    same calls on the parent's kernel) from replayed CUDA graphs in turns:
    kernel, parent, SDPA, SDPA, parent, kernel. Returns ((k1, k2), (s1,
    s2), (p1, p2) or None, the kernel graph's outputs)."""
    k1, outs = graph_time_ms(fns, replays)
    p1 = graph_time_ms(parent, replays)[0] if parent else None
    s1, _ = graph_time_ms(sdpa, replays)
    s2, _ = graph_time_ms(sdpa, replays)
    p2 = graph_time_ms(parent, replays)[0] if parent else None
    k2, _ = graph_time_ms(fns, replays)
    return (k1, k2), (s1, s2), ((p1, p2) if parent else None), outs


def _parent_note(par):
    return (f", parent's kernel device {(par[0] + par[1]) / 2 * 1e3:.2f} us "
            f"({par[0] * 1e3:.2f}, {par[1] * 1e3:.2f})" if par else "")


KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _decode_case(b, h, kh, hd, t_cache, t_ctx, dtype, gen, *, fill=None,
                 dead_slot=False, window=None, live=None, layers=0,
                 ring=None, cross=False):
    """Dense-cache inputs: k/v (B, t_cache, K, hd), attended view t_ctx.
    ``live=(lo, hi)``: only rows lo..hi-1 hold positions (0..), every other
    entry is empty. ``ring=last``: a wrapped ring of t_cache rows (the
    hybrid family's window cache), position p at row p % t_cache for the
    t_cache positions up to ``last``, the query at ``last``. ``layers``: k/v
    are layer 0 of a stacked cache (2, layers, B, t_cache, K, hd) of k and
    v, returned as the last item. ``cross``: every row holds a frame
    (positions 0..t_cache-1) and the query sits at position 10**9, as an
    encoder-decoder's cross-attention decode reads its cache."""
    import torch

    q = _rand((b, 1, h, hd), dtype, gen)
    stack = _rand((2, max(layers, 1), b, t_cache, kh, hd), dtype, gen)
    k, v = stack[0, 0], stack[1, 0]
    fill = t_ctx - 3 if fill is None else fill
    pos = torch.full((b, t_cache), -1, dtype=torch.int32, device="cuda")
    if ring is not None:
        p = torch.arange(ring - t_cache + 1, ring + 1, dtype=torch.int32,
                         device="cuda")
        pos[:, p.long() % t_cache] = p
        fill = ring + 1
    elif live is not None:
        lo, hi = live
        pos[:, lo:hi] = torch.arange(hi - lo, dtype=torch.int32, device="cuda")
        fill = hi - lo
    elif cross:
        pos[:] = torch.arange(t_cache, dtype=torch.int32, device="cuda")
        fill = 10 ** 9 + 1
    else:
        pos[:, :fill] = torch.arange(fill, dtype=torch.int32, device="cuda")
    pq = torch.full((b,), fill - 1, dtype=torch.int32, device="cuda")
    if dead_slot:
        pos[b - 1] = -1  # an empty slot: every entry masked
    return q, k, v, pq, pos, window, stack


def _paged_case(b, h, kh, hd, page, n_pt, t_ctx, dtype, gen, *, window=None,
                dead_slot=False, live=None, layers=0):
    """Paged inputs: a shuffled page table over a pool with a null page 0;
    each slot reserves only the pages its fill needs (tail entries map to
    the null page), and the attended width may end mid-page. ``live`` and
    ``layers`` as for :func:`_decode_case` (pools (2, layers, P, page, K, hd))."""
    import torch

    n_pages = b * n_pt + 1
    stack = _rand((2, max(layers, 1), n_pages, page, kh, hd), dtype, gen)
    kp, vp = stack[0, 0], stack[1, 0]
    q = _rand((b, 1, h, hd), dtype, gen)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(
        b * 1000 + t_ctx)) + 1
    pages = perm[:b * n_pt].reshape(b, n_pt).to(torch.int32)
    fill = t_ctx - 5 if live is None else live[1]
    used = -(-fill // page)
    pages[:, used:] = 0  # unreserved tail -> null page
    pages = pages.cuda()
    pos = torch.full((b, t_ctx), -1, dtype=torch.int32, device="cuda")
    if live is not None:
        lo, hi = live
        pos[:, lo:hi] = torch.arange(hi - lo, dtype=torch.int32, device="cuda")
        fill = hi - lo
    else:
        pos[:, :fill] = torch.arange(fill, dtype=torch.int32, device="cuda")
    pq = torch.full((b,), fill - 1, dtype=torch.int32, device="cuda")
    if dead_slot:
        pos[b - 1] = -1
        pages[b - 1] = 0
    npg = -(-t_ctx // page)
    return q, kp, vp, pages[:, :npg], pq, pos, window, stack


# A lean bf16 decode instance against its split mirror
# (decode_attention_split_plain with P rounded to bf16): the kernel rounds P
# at its warp's running max, the mirror at the split's max, so the two differ
# by the f32 summation order, one bf16 ulp of the output (at most 2^-7 of it)
# where the two f32 results round apart, and P's two roundings (each at most
# 2^-9 of a row's weight times |v|): 8e-3, as for flash's tile loop.
LEAN_TOL = 8e-3


def _hold(label, got, want, dtype, v_rows=None, mirror=None):
    """got against want at the dtype's tolerance; with ``v_rows`` (the last
    slot's attended (T, K, hd) value rows) also that slot against mean(V);
    with ``mirror`` (a lean instance's split mirror) also against it at
    LEAN_TOL."""
    import torch

    t = KERNEL_TOL[str(dtype)[6:]]
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=t, atol=t):
        fail(f"{label} {dtype}: max |err| {err}")
    merr = None
    if mirror is not None:
        merr = float((got.float() - mirror.float()).abs().max())
        if not torch.allclose(got.float(), mirror.float(), rtol=LEAN_TOL,
                              atol=LEAN_TOL):
            fail(f"{label} {dtype} against its bf16-P split mirror: max "
                 f"|err| {merr}")
    if v_rows is not None:
        kh, hd = v_rows.shape[1:]
        mean_v = v_rows.float().mean(dim=0)  # (K, hd)
        row = got[-1, 0].float().reshape(kh, -1, hd)
        if not torch.allclose(row, mean_v[:, None].expand_as(row), rtol=t,
                              atol=t):
            fail(f"{label} {dtype}: the all-masked slot does not return "
                 f"mean(V)")
    print(f"  {label} {str(dtype)[6:]}: max |err| {err:.3g} (tol {t})"
          + (", all-masked slot = mean(V)" if v_rows is not None else "")
          + (f"; lean, against its bf16-P split mirror {merr:.3g} (tol "
             f"{LEAN_TOL})" if merr is not None else ""))
    return err


def _lean_mirror(q, k, v, pq, pos, window, rows, dtype, pages=None):
    """The split mirror of a lean bf16 instance (None for any other call):
    ``decode_attention_split_plain`` with P rounded to bf16, over the rows
    the kernel's splits take (``rows``: forced, or the wrapper's choice);
    paged, over the context gathered through ``pages``."""
    import torch

    from repro_torch.kernels.decode_attention import (
        decode_attention_split_plain, lean_instance, split_rows_for)
    b, _, h, hd = q.shape
    kh, t = k.shape[2], pos.shape[1]
    if dtype != torch.bfloat16 or not lean_instance(hd, h // kh):
        return None
    page = None
    if pages is not None:
        page, idx = k.shape[1], pages.long()
        k = k[idx].reshape(b, -1, kh, hd)[:, :t]
        v = v[idx].reshape(b, -1, kh, hd)[:, :t]
    if rows is None:
        rows = split_rows_for(b, kh, t, _sm_count(), page)
    return decode_attention_split_plain(q, k, v, pq, pos, window=window,
                                        split_rows=rows,
                                        p_dtype=torch.bfloat16)


# The attention shapes of the model zoo beyond the serving pair's hd 128 /
# group <= 8: phi-3-vision (hd 96, MHA), nemotron-4 (hd 192, group 12),
# recurrentgemma (hd 256, MQA group 16, window 2048 over a ring of 2048
# rows), qwen3-moe (hd 128, group 16), whisper-small (hd 64, MHA: the
# cross-attention decode over 1500 frames with the query at 10**9, the
# self-attention decode over its 448-row cache, the encoder's non-causal
# S=1500 and the decoder's causal prefill), and the small hd at group 16.
ZOO_DECODE_DENSE = [
    # (label, b, h, kh, hd, t_cache, t_ctx, kwargs)
    ("phi-3-vision hd96 32/32", 4, 32, 32, 96, 1024, 640, {}),
    ("phi-3-vision hd96 all-masked slot", 2, 32, 32, 96, 256, 200,
     {"dead_slot": True}),
    ("nemotron hd192 96/8", 2, 96, 8, 192, 256, 200, {}),
    ("recurrentgemma hd256 16/1", 4, 16, 1, 256, 512, 384, {}),
    ("recurrentgemma hd256 wrapped ring 2048, window 2048", 4, 16, 1, 256,
     2048, 2048, {"ring": 3063, "window": 2048}),
    ("recurrentgemma hd256 ring, one split", 2, 16, 1, 256, 2048, 2048,
     {"ring": 2500, "window": 2048, "split_rows": 4096}),
    ("qwen3-moe hd128 64/4", 4, 64, 4, 128, 512, 384, {}),
    ("whisper cross hd64 12/12 T=1500 q at 10**9", 4, 12, 12, 64, 1500,
     1500, {"cross": True}),
    ("whisper cross hd64 12/12 B=1", 1, 12, 12, 64, 1500, 1500,
     {"cross": True}),
    ("whisper self hd64 12/12 T=448", 4, 12, 12, 64, 448, 448, {"fill": 40}),
    ("hd256 4/1 window 48", 2, 4, 1, 256, 128, 100, {"window": 48}),
    ("hd32 16/1", 2, 16, 1, 32, 64, 48, {}),
    ("hd64 32/2", 2, 32, 2, 64, 128, 97, {}),
    ("hd192 12/1 T=1", 2, 12, 1, 192, 16, 1, {"fill": 1}),
]
ZOO_DECODE_PAGED = [
    # (label, b, h, kh, hd, page, n_pt, t_ctx, kwargs)
    ("phi-3-vision hd96 32/32", 4, 32, 32, 96, 64, 16, 640, {}),
    ("phi-3-vision hd96 partial page + dead slot", 2, 32, 32, 96, 64, 4,
     200, {"dead_slot": True}),
    ("nemotron hd192 96/8", 2, 96, 8, 192, 64, 4, 200, {}),
    ("recurrentgemma hd256 16/1 window 2048", 4, 16, 1, 256, 64, 40, 2500,
     {"window": 2048}),
    ("qwen3-moe hd128 64/4", 4, 64, 4, 128, 64, 8, 384, {}),
    ("hd32 16/1 page 16", 2, 16, 1, 32, 16, 4, 48, {}),
]
# timed, B=4: (label, h, kh, hd, T, window, dense cache only, cross read)
ZOO_DECODE_TIMED = [
    ("phi-3-vision", 32, 32, 96, 640, None, False, False),
    ("recurrentgemma ring", 16, 1, 256, 2048, 2048, True, False),
    ("qwen3-moe", 64, 4, 128, 384, None, False, False),
    ("whisper cross", 12, 12, 64, 1500, None, True, True),
    ("whisper self", 12, 12, 64, 448, None, True, False),
]
ZOO_FLASH = [
    # (label, b, s, h, kh, hd, causal, window, q layout)
    ("phi-3-vision hd96 32/32", 2, 640, 32, 32, 96, True, None, "contiguous"),
    ("hd96 window 64 ragged S=97", 2, 97, 4, 4, 96, True, 64, "contiguous"),
    ("nemotron hd192 96/8", 1, 256, 96, 8, 192, True, None, "contiguous"),
    # the shapes phase 11 (b) and the timed rows give the kernel: 32 key
    # tiles at S=2048, so the K/V rings and their mbarrier parities wrap
    # many times
    ("nemotron hd192 96/8 S=2048", 1, 2048, 96, 8, 192, True, None,
     "contiguous"),
    ("nemotron hd192 96/8 R=4 S=512", 4, 512, 96, 8, 192, True, None,
     "contiguous"),
    ("recurrentgemma hd256 16/1", 1, 320, 16, 1, 256, True, None,
     "contiguous"),
    ("recurrentgemma hd256 S=2500 window 2048", 1, 2500, 16, 1, 256, True,
     2048, "contiguous"),
    ("hd256 q (B,H,S,hd) view", 2, 130, 16, 1, 256, True, None, "bhsd"),
    # the warp-specialised kernel: rows TMA cannot address (element copies),
    # a non-causal and a ragged case, a 128-row tile that is half past S
    ("hd256 q unaligned view", 2, 100, 4, 1, 256, True, None, "unaligned"),
    ("hd192 q unaligned view window 40", 2, 200, 12, 1, 192, True, 40,
     "unaligned"),
    ("hd192 12/1 non-causal ragged S=97", 2, 97, 12, 1, 192, False, None,
     "contiguous"),
    ("hd256 16/1 S=1", 2, 1, 16, 1, 256, True, None, "contiguous"),
    ("hd192 96/8 S=65", 1, 65, 96, 8, 192, True, None, "contiguous"),
    ("qwen3-moe hd128 64/4", 2, 320, 64, 4, 128, True, None, "contiguous"),
    ("whisper encoder hd64 12/12 non-causal S=1500", 2, 1500, 12, 12, 64,
     False, None, "contiguous"),
    ("whisper decoder hd64 12/12 causal S=16", 4, 16, 12, 12, 64, True, None,
     "contiguous"),
    # the head dims the wgmma kernel took over from mma.sync: hd 96 staged
    # into the hd-128 tile, hd 64 on one 128-byte atom
    ("hd96 non-causal", 2, 200, 8, 8, 96, False, None, "contiguous"),
    ("hd96 q unaligned view", 2, 100, 4, 2, 96, True, None, "unaligned"),
    ("hd96 q (B,H,S,hd) view", 2, 160, 8, 2, 96, True, None, "bhsd"),
    ("hd96 S=1", 2, 1, 4, 4, 96, True, None, "contiguous"),
    ("hd64 window 40 ragged S=300", 2, 300, 8, 2, 64, True, 40,
     "contiguous"),
    ("hd64 16/1 S=65", 2, 65, 16, 1, 64, True, None, "contiguous"),
]
#: the bf16 flash kernel each head dim runs (``kernel_of``)
FLASH_BF16_ROUTE = {32: "flash_bf16_kernel", 64: "flash_bf16_wgmma_kernel",
                    96: "flash_bf16_wgmma_kernel",
                    128: "flash_bf16_wgmma_kernel",
                    192: "flash_bf16_ws_kernel", 256: "flash_bf16_ws_kernel"}
# timed: (label, b, s, h, kh, hd, window, causal)
ZOO_FLASH_TIMED = [
    ("phi-3-vision", 4, 640, 32, 32, 96, None, True),
    ("recurrentgemma", 1, 3000, 16, 1, 256, 2048, True),
    ("whisper encoder", 4, 1500, 12, 12, 64, None, False),
    ("nemotron", 1, 4096, 96, 8, 192, None, True),
    ("nemotron", 4, 512, 96, 8, 192, None, True),
]
#: the warp-specialised kernel pinned at hd 128, off the route, timed as a
#: record beside the routed wgmma kernel: (label, b, s, h, kh)
WS_HD128_RECORD = [("cloud", 4, 320, 28, 4), ("cloud", 1, 4096, 28, 4)]


def _held(held, dtype, hd, group, err):
    """Keep the worst error of each (dtype, hd, group) held in phase 3."""
    key = (str(dtype)[6:], hd, group)
    held[key] = max(held.get(key, 0.0), err)


def _instantiations(held):
    return [{"dtype": d, "hd": hd, "group": g, "max_abs_err": e}
            for (d, hd, g), e in sorted(held.items())]


def check_decode_dense(records):
    import torch

    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        # (label, b, h, kh, hd, t_cache, t_ctx, kwargs)
        ("edge", 4, 12, 2, 128, 512, 384, {}),
        ("cloud", 4, 28, 4, 128, 512, 384, {}),
        ("cloud all-masked slot", 4, 28, 4, 128, 512, 384,
         {"dead_slot": True}),
        ("hd32 reduced", 2, 4, 2, 32, 64, 48, {}),
        # window edge (position 189) inside the split of rows 160-191
        ("window 64", 2, 8, 2, 64, 256, 256, {"window": 64}),
        ("cloud window 64", 4, 28, 4, 128, 512, 384, {"window": 64}),
        ("ragged T=97", 2, 4, 1, 128, 97, 97, {}),
        ("T=1", 2, 8, 2, 128, 16, 1, {"fill": 1}),
        ("T=33 (one row in the last split)", 2, 12, 2, 128, 64, 33,
         {"fill": 33}),
        ("cloud T=300 (not a multiple of the split)", 4, 28, 4, 128, 512,
         300, {}),
        # attended rows 208-223 lie in one split, every other split masked
        ("cloud one live split", 4, 28, 4, 128, 512, 512,
         {"live": (208, 224)}),
        ("cloud forced single split", 4, 28, 4, 128, 512, 384,
         {"split_rows": 4096}),
        ("cloud T=4096", 4, 28, 4, 128, 4096, 4096, {}),
        ("cloud T=4096 all-masked slot", 4, 28, 4, 128, 4096, 4096,
         {"dead_slot": True}),
        ("edge T=4096 forced single split", 4, 12, 2, 128, 4096, 4096,
         {"split_rows": 4096}),
        # the draft block (phase 9): a batch-1 dense copy of one slot,
        # attended through the context bucket of a 512-row cache
        ("cloud B=1 draft T=384", 1, 28, 4, 128, 512, 384, {}),
        ("cloud B=1 draft T=512", 1, 28, 4, 128, 512, 512, {}),
        ("edge B=1 draft T=384", 1, 12, 2, 128, 512, 384, {}),
        ("edge B=1 draft T=512", 1, 12, 2, 128, 512, 512, {}),
    ] + ZOO_DECODE_DENSE
    worst, held = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, h, kh, hd, tc, tx, kw in cases:
            kw = dict(kw)
            rows = kw.pop("split_rows", None)
            q, k, v, pq, pos, window, _ = _decode_case(b, h, kh, hd, tc, tx,
                                                       dtype, gen, **kw)
            kv, vv, pv = k[:, :tx], v[:, :tx], pos[:, :tx]  # bucket view
            got = decode_attention_cuda(q, kv, vv, pq, pv, window=window,
                                        split_rows=rows)
            want = decode_attention_plain(q, kv, vv, pq, pv, window=window)
            torch.cuda.synchronize()
            err = _hold(f"decode_attention {label}", got, want, dtype,
                        vv[b - 1] if kw.get("dead_slot") else None,
                        _lean_mirror(q, kv, vv, pq, pv, window, rows, dtype))
            _held(held, dtype, hd, h // kh, err)
            if label == "cloud" and dtype == torch.bfloat16:
                worst = err
    for t in (384, 4096):
        for label, h, kh in (("edge", 12, 2), ("cloud", 28, 4)):
            time_decode(records, False, label, h, kh, t, worst, gen)
    for label, h, kh, hd, t, window, _, cross in ZOO_DECODE_TIMED:
        time_decode(records, False, label, h, kh, t, worst, gen, hd=hd,
                    window=window, sweep=(32, 64, 128, 256, 512),
                    cross=cross)
    records["decode_attention"]["instantiations"] = _instantiations(held)


def check_decode_paged(records):
    import torch

    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_cuda, decode_attention_paged_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [
        # (label, b, h, kh, hd, page, n_pt, t_ctx, kwargs)
        ("edge", 4, 12, 2, 128, 64, 8, 384, {}),
        ("cloud", 4, 28, 4, 128, 64, 8, 384, {}),
        ("cloud partial page + dead slot", 4, 28, 4, 128, 64, 8, 300,
         {"dead_slot": True}),
        ("hd32 reduced", 2, 4, 2, 32, 16, 4, 48, {}),
        ("window 64", 2, 8, 2, 64, 64, 4, 256, {"window": 64}),
        ("T=1 page 16", 2, 8, 2, 128, 16, 2, 1, {"live": (0, 1)}),
        ("T=33 page 16", 2, 12, 2, 128, 16, 4, 33, {}),
        ("T=97 page 16", 2, 4, 1, 128, 16, 8, 97, {}),
        # width 390 ends 6 rows into its last page of 16
        ("cloud page 16 ends mid-page", 4, 28, 4, 128, 16, 32, 390, {}),
        ("cloud page 64 ends mid-page", 4, 28, 4, 128, 64, 8, 390, {}),
        ("cloud one live split", 4, 28, 4, 128, 64, 8, 512,
         {"live": (208, 224)}),
        ("cloud forced single split", 4, 28, 4, 128, 64, 8, 384,
         {"split_rows": 512}),
        ("cloud T=4096 page 64", 4, 28, 4, 128, 64, 64, 4096, {}),
        ("cloud T=4096 all-masked slot", 4, 28, 4, 128, 64, 64, 4096,
         {"dead_slot": True}),
    ] + ZOO_DECODE_PAGED
    worst, held = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, h, kh, hd, page, n_pt, tx, kw in cases:
            kw = dict(kw)
            rows = kw.pop("split_rows", None)
            q, kp, vp, pages, pq, pos, window, _ = _paged_case(
                b, h, kh, hd, page, n_pt, tx, dtype, gen, **kw)
            got = decode_attention_paged_cuda(q, kp, vp, pages, pq, pos,
                                              window=window, split_rows=rows)
            want = decode_attention_paged_plain(q, kp, vp, pages, pq, pos,
                                                window=window)
            torch.cuda.synchronize()
            # a dead slot's table is all null page: its T rows are page 0's
            dead = (vp[0].repeat(-(-tx // page), 1, 1)[:tx]
                    if kw.get("dead_slot") else None)
            err = _hold(f"decode_attention_paged {label}", got, want, dtype,
                        dead, _lean_mirror(q, kp, vp, pq, pos, window, rows,
                                           dtype, pages))
            _held(held, dtype, hd, h // kh, err)
            if label == "cloud" and dtype == torch.bfloat16:
                worst = err
    for t in (384, 4096):
        for label, h, kh in (("edge", 12, 2), ("cloud", 28, 4)):
            time_decode(records, True, label, h, kh, t, worst, gen)
    for label, h, kh, hd, t, window, dense_only, _ in ZOO_DECODE_TIMED:
        if not dense_only:  # the ring and encdec's caches stay dense
            time_decode(records, True, label, h, kh, t, worst, gen, hd=hd)
    records["decode_attention_paged"]["instantiations"] = _instantiations(
        held)


# The paged kernel with extents (lens): (label, b, h, kh, hd, page, t,
# extents). Extents at 0 (a dead slot: zeros), 1, a page - 1, a page, a
# split of 1024 +- 1 and T; the rest of the batch at T - 5.
EXTENT_CASES = [
    ("phi-3-vision hd96 32/32 T=4096", 8, 32, 32, 96, 256, 4096,
     (0, 1, 255, 256, 1023, 1025, 3960, 4096)),
    ("edge hd128 12/2 T=2048", 8, 12, 2, 128, 256, 2048,
     (0, 1, 255, 256, 1023, 1025, 1500, 2048)),
    ("cloud hd128 28/4 T=2048", 8, 28, 4, 128, 256, 2048,
     (2048, 1, 0, 256, 1023, 1025, 700, 255)),
    ("cloud hd128 28/4 T=390 page 16", 4, 28, 4, 128, 16, 390,
     (390, 15, 0, 17)),
    ("recurrentgemma hd256 16/1 (lean) T=4096", 8, 16, 1, 256, 256, 4096,
     (0, 1, 255, 256, 1023, 1025, 3000, 4096)),
]
# ragged decode at the benchmark cells' shapes (B 32, page 256): (label, h,
# kh, hd, T, live extents (lo, hi) or a fixed value, live slots); dead
# slots keep a stale table-less row (their pages are the null page, their
# positions the last request's), as ``TierEngine._release_pages`` leaves them
EXTENT_TIMED = [
    ("phi3v cloud, 12 live of 32", 32, 32, 96, 4096, (2650, 3960), 12),
    ("qwen cloud, 3 live of 32", 28, 4, 128, 2048, (900, 1900), 3),
    ("qwen edge, 3 live of 32", 12, 2, 128, 2048, (900, 1900), 3),
    # full occupancy, nothing to skip: phase 16's shape, and phi3v's
    ("qwen cloud, 32 live at 1401", 28, 4, 128, 1536, 1401, 32),
    ("qwen edge, 32 live at 1401", 12, 2, 128, 1536, 1401, 32),
    ("phi3v cloud, 32 live", 32, 32, 96, 4096, (2650, 3960), 32),
]
#: least split rows timed beside the default (``PLAN_MIN_ROWS``)
EXTENT_PLANS = (32, 128)


def _extent_case(b, h, kh, hd, page, t, extents, dtype, gen, *, layers=1,
                 live=None):
    """Paged inputs where slot i attends rows [0, extents[i]) (positions
    0..e-1, the query at e - 1; its pages reserved, the rest the null page);
    a slot whose extent is 0 (or not in ``live``) is dead: its table is the
    null page and its positions a stale request's 0..t-1."""
    import torch

    ext = [int(e) for e in extents]
    used = [-(-e // page) for e in ext]
    n_pages = sum(used) + 1
    stack = _rand((2, layers, n_pages, page, kh, hd), dtype, gen)
    q = _rand((b, 1, h, hd), dtype, gen)
    n_pt = -(-t // page)
    pages = torch.zeros((b, n_pt), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(b * 31 + t)) + 1
    at = 0
    for i, u in enumerate(used):
        pages[i, :u] = perm[at:at + u].to(torch.int32)
        at += u
    pos = torch.full((b, t), -1, dtype=torch.int32)
    pq = torch.zeros((b,), dtype=torch.int32)
    for i, e in enumerate(ext):
        if e > 0:
            pos[i, :e] = torch.arange(e, dtype=torch.int32)
            pq[i] = e - 1
        else:  # dead: stale positions behind the null page
            pos[i] = torch.arange(t, dtype=torch.int32)
            pq[i] = t - 1
    lens = torch.tensor(ext, dtype=torch.int32)
    dev = lambda x: x.cuda()  # noqa: E731
    return (q, stack, dev(pages), dev(pq), dev(pos), dev(lens))


def _plan_rows(ext, b, h, kh, hd, t, page, dtype):
    """(split rows, items, blocks) of the kernel's extent plan at its
    defaults, as the wrapper and the device choose them."""
    from repro_torch.kernels.decode_attention import (
        MAX_SPLIT_PAGES, MAX_SPLIT_ROWS, PLAN_MIN_ROWS, plan_blocks,
        plan_split_rows, resident_blocks)
    rmax = MAX_SPLIT_ROWS
    while -(-rmax // page) + 1 > MAX_SPLIT_PAGES:
        rmax //= 2
    rmin = min(PLAN_MIN_ROWS, rmax)
    blocks = plan_blocks(b, kh, t, resident_blocks(0, dtype, hd, h // kh),
                         rmin, rmax)
    ext = [min(int(e), t) for e in ext]
    rows = plan_split_rows(ext, kh, blocks, rmin, rmax)
    return rows, kh * sum(-(-e // rows) for e in ext), blocks


def check_decode_extents(records):
    """The paged kernel with extents against its plain version (and, lean,
    its split mirror at the plan's split length), a dead slot's output
    exactly 0; without extents bitwise the parent's kernel (with
    ``--parent-csrc``); then the cells' ragged shapes timed with extents,
    without, and on the parent's kernel, beside the live rows' byte bound."""
    import torch

    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_cuda, decode_attention_paged_plain,
        decode_attention_split_plain, lean_instance)
    gen = torch.Generator(device="cuda").manual_seed(30)
    held = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, h, kh, hd, page, t, ext in EXTENT_CASES:
            q, stack, pages, pq, pos, lens = _extent_case(
                b, h, kh, hd, page, t, ext, dtype, gen)
            kp, vp = stack[0, 0], stack[1, 0]
            got = decode_attention_paged_cuda(q, kp, vp, pages, pq, pos,
                                              lens=lens)
            want = decode_attention_paged_plain(q, kp, vp, pages, pq, pos,
                                                lens=lens)
            mirror = None
            if dtype == torch.bfloat16 and lean_instance(hd, h // kh):
                rows = _plan_rows(ext, b, h, kh, hd, t, page, dtype)[0]
                idx = pages.long()
                kc = kp[idx].reshape(b, -1, kh, hd)[:, :t]
                vc = vp[idx].reshape(b, -1, kh, hd)[:, :t]
                mirror = decode_attention_split_plain(
                    q, kc, vc, pq, pos, split_rows=rows, lens=lens,
                    p_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            err = _hold(f"decode_attention_paged extents {label}", got, want,
                        dtype, mirror=mirror)
            for i, e in enumerate(ext):
                if e == 0 and bool(got[i].abs().max() != 0):
                    fail(f"extents {label} {dtype}: a slot of extent 0 is not "
                         f"zero")
            _held(held, dtype, hd, h // kh, err)
            # forced splits: each a multiple of the page and inside one
            for rows in (page, 1024):
                forced = decode_attention_paged_cuda(
                    q, kp, vp, pages, pq, pos, lens=lens, split_rows=rows)
                _hold(f"decode_attention_paged extents {label} split {rows}",
                      forced, want, dtype)
            if PARENT_LIBS and dtype == torch.bfloat16:
                # without extents the launch is the parent's, bit for bit
                ours = decode_attention_paged_cuda(q, kp, vp, pages, pq, pos)
                par = _on_parent("decode_attention", [
                    lambda: decode_attention_paged_cuda(q, kp, vp, pages, pq,
                                                        pos)])[0]()
                torch.cuda.synchronize()
                if not torch.equal(ours, par):
                    fail(f"extents {label}: without lens the kernel differs "
                         f"from the parent's")
                print(f"  decode_attention_paged {label}: without lens "
                      f"bitwise the parent's kernel")
    records["decode_attention_paged"]["extent_instantiations"] = (
        _instantiations(held))
    for case in EXTENT_TIMED:
        time_extents(records, case, gen)


def time_extents(records, case, gen):
    """Device time a call at one ragged shape (bf16, B 32, page 256) from
    replayed CUDA graphs over rotated layers, in turns: with extents,
    without, the parent's kernel (without), and back; then each plan of
    EXTENT_PLANS with extents. Bound: the live slots' K/V rows read once,
    q read and out written once, over 3.35 TB/s."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_cuda)
    label, h, kh, hd, t, span, n_live = case
    b, page, dt = 32, 256, torch.bfloat16
    rng = torch.Generator().manual_seed(len(label) * 977 + t)
    if isinstance(span, tuple):
        live = torch.randint(span[0], span[1] + 1, (n_live,), generator=rng)
    else:
        live = torch.full((n_live,), span)
    ext = [0] * b
    for i, slot in enumerate(torch.randperm(b, generator=rng)[:n_live]):
        ext[int(slot)] = int(live[i])
    live_bytes = sum(ext) * kh * hd * 2 * 2
    layers = max(2, -(-100_000_000 // max(live_bytes, 1)) + 1)
    q, stack, pages, pq, pos, lens = _extent_case(b, h, kh, hd, page, t, ext,
                                                  dt, gen, layers=layers)

    def calls(**kw):
        return [lambda i=i: decode_attention_paged_cuda(
            q, stack[0, i], stack[1, i], pages, pq, pos, **kw)
            for i in range(layers)]

    with_lens, without = calls(lens=lens), calls()
    parent = _on_parent("decode_attention", without)
    replays = max(10, -(-280 // layers))
    e1, outs = graph_time_ms(with_lens, replays)
    n1, base = graph_time_ms(without, replays)
    p1 = graph_time_ms(parent, replays)[0] if parent else None
    p2 = graph_time_ms(parent, replays)[0] if parent else None
    n2, _ = graph_time_ms(without, replays)
    e2, _ = graph_time_ms(with_lens, replays)
    live_rows = [i for i, e in enumerate(ext) if e > 0]
    dead = [i for i, e in enumerate(ext) if e == 0]
    for i in range(layers):
        if not torch.allclose(outs[i][live_rows].float(),
                              base[i][live_rows].float(), rtol=2e-2,
                              atol=2e-2):
            fail(f"extents {label}: live slots differ with and without lens")
        if dead and bool(outs[i][dead].abs().max() != 0):
            fail(f"extents {label}: a dead slot is not zero")
    plans = {}
    for rmin in EXTENT_PLANS:  # the launches a graph captures read it
        default, da.PLAN_MIN_ROWS = da.PLAN_MIN_ROWS, rmin
        try:
            plans[rmin] = graph_time_ms(calls(lens=lens), replays)[0]
        finally:
            da.PLAN_MIN_ROWS = default
    nbytes = live_bytes + 2 * b * h * hd * 2 + b * t * 4
    bd = nbytes / HBM_BYTES_PER_S * 1e3
    dev, no_lens = (e1 + e2) / 2, (n1 + n2) / 2
    par = (p1 + p2) / 2 if parent else None
    rows, items, blocks = _plan_rows(ext, b, h, kh, hd, t, page, dt)
    grid_rows = b * t
    print(f"  decode_attention_paged extents {label} (B {b}, T {t}, hd {hd} "
          f"group {h // kh}, {n_live} live, {sum(ext)} live rows of "
          f"{grid_rows}, {layers} layers rotated): with lens device "
          f"{dev * 1e3:.2f} us ({e1 * 1e3:.2f}, {e2 * 1e3:.2f}; split "
          f"{rows} rows, {items} items on {blocks} blocks), without "
          f"{no_lens * 1e3:.2f} us ({n1 * 1e3:.2f}, {n2 * 1e3:.2f})"
          + (f", parent's kernel {par * 1e3:.2f} us ({p1 * 1e3:.2f}, "
             f"{p2 * 1e3:.2f})" if par else "")
          + f", bound {bd * 1e3:.3f} us (live bytes), {bd / dev:.1%} of it "
          f"with lens, {bd / no_lens:.1%} without; with the least split "
          f"at " + ", ".join(f"{k} rows {v * 1e3:.2f} us"
                             for k, v in plans.items()))
    records["decode_attention_paged"].setdefault("extents", []).append({
        "shape": label, "t": t, "live": n_live, "live_rows": sum(ext),
        "grid_rows": grid_rows, "device_ms": dev, "no_lens_ms": no_lens,
        "parent_ms": par, "bound_ms": bd, "share_of_bound": bd / dev,
        "split_rows": rows, "items": items, "blocks": blocks,
        "least_split_ms": plans})


def time_decode(records, paged, label, h, kh, t, worst, gen, hd=128,
                window=None, sweep=(), cross=False):
    """Time one decode shape (B=4, bf16, hd 128 unless given) the way the
    decode loop meets it: launches rotate over the layers of a stacked cache
    that does not fit the 50 MB L2 (28 layers at the serving T=384 of 512;
    otherwise enough caches to pass 100 MB). The zoo's shapes (other hd and
    groups) are added to the kernel's record under "shapes". ``sweep``:
    context rows per split to time the dense kernel at besides the
    wrapper's choice. ``cross``: the encoder-decoder's cross read (every
    row a frame, the query at 10**9). Device time per call from a replayed
    CUDA graph (the kernel, then SDPA on the same dense rows, in turns:
    kernel, SDPA, SDPA, kernel), the eager wall per call beside it; the
    graph's outputs must equal eager calls bitwise."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_paged_cuda,
        decode_attention_paged_plain, decode_attention_plain)
    b, dt = 4, torch.bfloat16
    layer_bytes = 2 * b * t * kh * hd * 2
    layers = 28 if t <= 512 else -(-100_000_000 // layer_bytes) + 1
    if paged:
        page = 64
        q, _, _, pages, pq, pos, _, stack = _paged_case(
            b, h, kh, hd, page, -(-t // page), t, dt, gen, layers=layers)
        fns = [lambda i=i: decode_attention_paged_cuda(
            q, stack[0, i], stack[1, i], pages, pq, pos)
            for i in range(layers)]
        plain = [lambda i=i: decode_attention_paged_plain(
            q, stack[0, i], stack[1, i], pages, pq, pos)
            for i in range(layers)]
        # SDPA reads the same rows, gathered once into a dense cache
        idx = pages.long()
        dense = [stack[j, i][idx].reshape(b, -1, kh, hd)[:, :t]
                 for i in range(layers) for j in (0, 1)]
        kv = [(dense[2 * i], dense[2 * i + 1]) for i in range(layers)]
    else:
        tc = max(512, t)
        q, _, _, pq, pos, _, stack = _decode_case(b, h, kh, hd, tc, t, dt,
                                                  gen, layers=layers,
                                                  cross=cross)
        pos = pos[:, :t]
        kv = [(stack[0, i][:, :t], stack[1, i][:, :t]) for i in range(layers)]
        fns = [lambda i=i: decode_attention_cuda(q, *kv[i], pq, pos,
                                                 window=window)
               for i in range(layers)]
        plain = [lambda i=i: decode_attention_plain(q, *kv[i], pq, pos,
                                                    window=window)
                 for i in range(layers)]
    dd = pq[:, None] - pos
    ok = (pos >= 0) & (dd >= 0)
    if window is not None:
        ok = ok & (dd < window)
    mask = ok[:, None, None, :]
    qs = q.transpose(1, 2)
    sdpa = [lambda i=i: F.scaled_dot_product_attention(
        qs, kv[i][0].transpose(1, 2), kv[i][1].transpose(1, 2),
        attn_mask=mask, enable_gqa=True) for i in range(layers)]
    replays = max(10, -(-280 // layers))
    (k1, k2), (s1, s2), par, outs = time_in_turns(
        fns, sdpa, replays, _on_parent("decode_attention", fns))
    for i, fn in enumerate(fns):
        if not torch.equal(outs[i], fn()):
            fail(f"decode {label} T={t}: graph replay differs from eager")
    dev, lib = (k1 + k2) / 2, (s1 + s2) / 2
    swept = {}
    for rows in sweep:
        swept[rows] = graph_time_ms([lambda i=i: decode_attention_cuda(
            q, *kv[i], pq, pos, window=window, split_rows=rows)
            for i in range(layers)], replays)[0]
    if swept:
        print(f"  decode_attention {label} hd {hd} group {h // kh} T={t}: "
              f"device us by rows a split: "
              + ", ".join(f"{r}: {ms * 1e3:.2f}" for r, ms in swept.items()))
    eager = eager_time_ms(fns, max(2, -(-100 // layers)))
    plain_ms = (graph_time_ms(plain, 2)[0] if t <= 2048 else None)
    nbytes = 2 * b * t * kh * hd * 2 + 2 * b * h * hd * 2 + b * t * 4
    if paged:
        nbytes += pages.numel() * 4
    bd, by = bound_ms(nbytes, 4.0 * b * h * t * hd, "bfloat16")
    name = "decode_attention_paged" if paged else "decode_attention"
    if hd != 128 or h // kh > 8:
        records[name].setdefault("shapes", []).append({
            "shape": f"{label} B=4 T={t} hd {hd} group {h // kh}"
                     + (f" window {window}" if window else "")
                     + (" query at 10**9" if cross else ""),
            "device_ms": dev, "eager_ms": eager, "plain_ms": plain_ms,
            "bound_ms": bd, "bound_by": by, "library_ms": lib,
            "share_of_bound": bd / dev,
            "parent_ms": (par[0] + par[1]) / 2 if par else None})
    print(f"  {name} {label} B=4 T={t} hd {hd} bf16 ({layers} layers "
          f"rotated): "
          f"device {dev * 1e3:.2f} us ({k1 * 1e3:.2f}, {k2 * 1e3:.2f}), "
          f"eager wall {eager * 1e3:.2f} us, sdpa device {lib * 1e3:.2f} us "
          f"({s1 * 1e3:.2f}, {s2 * 1e3:.2f})"
          + (f", plain device {plain_ms * 1e3:.2f} us" if plain_ms else "")
          + _parent_note(par)
          + f", bound {bd * 1e3:.3f} us ({by}), {bd / dev:.1%} of it")
    if label == "cloud" and t <= 512:
        records[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": ("src/repro/kernels/decode_attention.py:78" if paged
                         else "src/repro/kernels/decode_attention.py:146"),
            "max_abs_err": worst, "ms": dev, "device_ms": dev,
            "eager_ms": eager, "plain_ms": plain_ms, "bound_ms": bd,
            "bound_by": by, "library_ms": None if paged else lib}


def _flash_case(b, s, h, kh, hd, dtype, gen, layout):
    """q (B, S, H, hd), k/v (B, S, K, hd); ``layout`` "contiguous", "bhsd"
    (q a transposed view of a (B, H, S, hd) tensor, as a caller holding
    SDPA's layout would pass it) or "unaligned" (q a slice at an odd offset
    with a row stride of hd + 1: no 16-byte row alignment)."""
    if layout == "bhsd":
        q = _rand((b, h, s, hd), dtype, gen).transpose(1, 2)
    elif layout == "unaligned":
        q = _rand((b, s, h, hd + 1), dtype, gen)[..., 1:]
    else:
        q = _rand((b, s, h, hd), dtype, gen)
    kv = _rand((b, s, 2, kh, hd), dtype, gen)  # k, v: views of one tensor
    return q, kv[:, :, 0], kv[:, :, 1]


# The bf16 kernel against its own tile loop (flash_attention_tiled_plain with
# P rounded to bf16, as the kernel feeds it to the tensor cores): the two
# differ only in the f32 summation order and the exp2 rounding, so the error
# is one bf16 ulp of the output (at most 2^-7 of it) where the two f32 results
# round apart, plus rare one-ulp flips of a bf16 P (each moves the output by
# at most 2^-8 of that key's weight times |v - o|).
TILED_TOL = 8e-3


def check_flash(records):
    import torch

    from repro_torch.kernels.flash_attention import (
        blocks_per_sm, flash_attention_cuda, flash_attention_plain,
        flash_attention_tiled_plain, kernel_of, tiles)
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [
        # (label, b, s, h, kh, hd, causal, window, q layout)
        ("edge", 4, 320, 12, 2, 128, True, None, "contiguous"),
        ("cloud", 4, 320, 28, 4, 128, True, None, "contiguous"),
        ("hd32", 2, 128, 4, 2, 32, True, None, "contiguous"),
        ("hd64", 2, 192, 8, 2, 64, True, None, "contiguous"),
        ("ragged S=97", 2, 97, 4, 1, 128, True, None, "contiguous"),
        ("ragged S=272", 1, 272, 12, 2, 128, True, None, "contiguous"),
        ("non-causal", 2, 200, 8, 2, 64, False, None, "contiguous"),
        ("window 64", 2, 256, 8, 2, 64, True, 64, "contiguous"),
        ("non-causal window 64", 1, 160, 4, 2, 32, False, 64, "contiguous"),
        ("q (B,H,S,hd) view", 2, 160, 8, 2, 128, True, None, "bhsd"),
        ("q unaligned view", 2, 100, 4, 2, 64, True, None, "unaligned"),
        ("S=1", 2, 1, 12, 2, 128, True, None, "contiguous"),
        ("S=65", 2, 65, 12, 2, 128, True, None, "contiguous"),
        # a window whose first tiles are wholly masked for the last rows of
        # a query tile
        ("window 40", 2, 320, 12, 2, 128, True, 40, "contiguous"),
        ("cloud R=1 S=4096", 1, 4096, 28, 4, 128, True, None, "contiguous"),
    ] + ZOO_FLASH
    worst, held = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, s, h, kh, hd, causal, window, layout in cases:
            q, k, v = _flash_case(b, s, h, kh, hd, dtype, gen, layout)
            got = flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            t = KERNEL_TOL[str(dtype)[6:]]
            if not torch.allclose(got.float(), want.float(), rtol=t, atol=t):
                fail(f"flash_attention {label} {dtype}: max |err| {err}")
            _held(held, dtype, hd, h // kh, err)
            if label == "cloud" and dtype == torch.bfloat16:
                worst = err
            msg = (f"  flash_attention {label} {str(dtype)[6:]}: max |err| "
                   f"{err:.3g} (tol {t})")
            if dtype == torch.bfloat16:
                kern = kernel_of(dtype, hd)
                block_q, block_k = tiles(kern)
                tiled = flash_attention_tiled_plain(
                    q, k, v, causal=causal, window=window, block_q=block_q,
                    block_k=block_k, p_dtype=torch.bfloat16)
                terr = float((got.float() - tiled.float()).abs().max())
                if not torch.allclose(got.float(), tiled.float(),
                                      rtol=TILED_TOL, atol=TILED_TOL):
                    fail(f"flash_attention {label} bf16 against its tile "
                         f"loop: max |err| {terr}")
                msg += (f"; {kern} against its tile loop ({block_q} x "
                        f"{block_k}) {terr:.3g} (tol {TILED_TOL})")
                again = flash_attention_cuda(q, k, v, causal=causal,
                                             window=window)
                if not torch.equal(again, got):
                    fail(f"flash_attention {label} bf16: two calls differ")
            print(msg)
    for hd, want in FLASH_BF16_ROUTE.items():
        got = kernel_of(torch.bfloat16, hd)
        if got != want:
            fail(f"flash_attention bf16 hd {hd} runs {got}, not {want}")
        print(f"  flash_attention hd {hd}: bf16 runs {got}; resident blocks "
              f"an SM: bf16 {blocks_per_sm(torch.bfloat16, hd)}, f32 "
              f"{blocks_per_sm(torch.float32, hd)}")
    shapes = [time_flash(label, b, s, h, kh, gen)
              for label, b, s, h, kh in (("edge", 4, 320, 12, 2),
                                         ("cloud", 4, 320, 28, 4),
                                         ("cloud", 4, 512, 28, 4),
                                         ("edge", 1, 4096, 12, 2),
                                         ("cloud", 1, 4096, 28, 4))]
    main = shapes[1]
    records["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "max_abs_err": worst, "ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "device_ms": main["device_ms"], "eager_ms": main["eager_ms"],
        "shapes": shapes + [time_flash(lb, b, s, h, kh, gen, hd=hd, window=w,
                                       causal=c)
                            for lb, b, s, h, kh, hd, w, c in ZOO_FLASH_TIMED],
        "ws_hd128_record": [time_flash_ws_record(lb, b, s, h, kh, gen)
                            for lb, b, s, h, kh in WS_HD128_RECORD],
        "instantiations": _instantiations(held)}


def time_flash(label, b, s, h, kh, gen, hd=128, window=None, causal=True):
    """Time one prefill shape (bf16, hd 128 unless given, causal unless
    told otherwise, optional window) the way a prefill meets it: launches rotate over 28 layers'
    distinct (q, k, v), more bytes than the 50 MB L2 holds. Device time per call from a replayed CUDA graph
    of one rotation (the kernel, then SDPA on the same tensors, in turns:
    kernel, SDPA, SDPA, kernel), the eager wall per call beside it; the
    graph's outputs must equal eager calls bitwise. The plain version is
    timed (by a graph) at the serving lengths only."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    dt, layers = torch.bfloat16, 28
    qs = _rand((layers, b, s, h, hd), dt, gen)
    kvs = _rand((layers, 2, b, s, kh, hd), dt, gen)
    fns = [lambda i=i: flash_attention_cuda(qs[i], kvs[i, 0], kvs[i, 1],
                                            causal=causal, window=window)
           for i in range(layers)]
    if window is None:
        sdpa = [lambda i=i: F.scaled_dot_product_attention(
            qs[i].transpose(1, 2), kvs[i, 0].transpose(1, 2),
            kvs[i, 1].transpose(1, 2), is_causal=causal, enable_gqa=True)
            for i in range(layers)]
    else:
        r = torch.arange(s, device="cuda")
        dd = r[:, None] - r[None]
        wmask = (dd >= 0) & (dd < window)
        sdpa = [lambda i=i: F.scaled_dot_product_attention(
            qs[i].transpose(1, 2), kvs[i, 0].transpose(1, 2),
            kvs[i, 1].transpose(1, 2), attn_mask=wmask, enable_gqa=True)
            for i in range(layers)]
    replays = max(10, -(-280 // layers))
    (k1, k2), (s1, s2), par, outs = time_in_turns(
        fns, sdpa, replays, _on_parent("flash_attention", fns))
    flex_ms = flex_note = None
    if window is not None:
        flex_ms, flex_note = _flex_window_ms(qs, kvs, window, outs[0])
    for i, fn in enumerate(fns):
        if not torch.equal(outs[i], fn()):
            fail(f"flash {label} R={b} S={s}: graph replay differs from eager")
    del outs
    dev, lib = (k1 + k2) / 2, (s1 + s2) / 2
    eager = eager_time_ms(fns, max(2, -(-100 // layers)))
    plain_ms = None
    if s <= 1024:
        plain = [lambda i=i: flash_attention_plain(qs[i], kvs[i, 0],
                                                   kvs[i, 1], causal=causal,
                                                   window=window)
                 for i in range(layers)]
        plain_ms = graph_time_ms(plain, 2)[0]
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kh * hd)
    # the pairs this run attends: causal (or all), within the window if any
    if not causal:
        pairs = float(s * s)
    elif window is None:
        pairs = s * (s + 1) / 2
    else:
        pairs = sum(min(r + 1, window) for r in range(s))
    flops = 4.0 * b * h * hd * pairs
    bd, by = bound_ms(nbytes, flops, "bfloat16")
    # a second bound: one exp2 a score on the SMs' special-function units
    # (16 a clock an SM) at the card's top SM clock
    exp_bd = (b * h * pairs * 1e3
              / (MUFU_EX2_PER_CLOCK * _sm_count() * _max_sm_hz()))
    shape = (f"{label} R={b} S={s}" + (f" hd {hd}" if hd != 128 else "")
             + (f" group {h // kh}" if h // kh > 8 or hd != 128 else "")
             + (f" window {window}" if window else "")
             + ("" if causal else " non-causal"))
    print(f"  flash_attention {shape} bf16 ({layers} layers rotated): device "
          f"{dev * 1e3:.2f} us ({k1 * 1e3:.2f}, {k2 * 1e3:.2f}), eager wall "
          f"{eager * 1e3:.2f} us, sdpa device {lib * 1e3:.2f} us "
          f"({s1 * 1e3:.2f}, {s2 * 1e3:.2f})"
          + (f", plain device {plain_ms * 1e3:.2f} us" if plain_ms else "")
          + _parent_note(par)
          + (f", {flex_note}" if flex_note else "")
          + f", bound {bd * 1e3:.3f} us ({by}), {bd / dev:.1%} of it; "
          f"exponentials' bound {exp_bd * 1e3:.3f} us")
    del qs, kvs
    torch.cuda.empty_cache()
    return {"shape": shape, "device_ms": dev, "library_ms": lib,
            "eager_ms": eager, "plain_ms": plain_ms, "bound_ms": bd,
            "bound_by": by, "share_of_bound": bd / dev,
            "exp_bound_ms": exp_bd, "flex_ms": flex_ms,
            "parent_ms": (par[0] + par[1]) / 2 if par else None}


def _flex_window_ms(qs, kvs, window, ref):
    """torch's flex_attention, compiled, with a sliding-window block mask
    (``0 <= row - col < window``) over the same rotation of inputs: device
    time per call from CUDA events over eager passes (a compiled call is not
    captured), a library yardstick only. Returns (ms or None, a note: the
    time and its largest difference from the kernel on the first input, or
    why it did not run)."""
    import torch

    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def sliding(b, h, q_idx, kv_idx):
            return (q_idx >= kv_idx) & (q_idx - kv_idx < window)

        s = qs.shape[2]
        mask = create_block_mask(sliding, B=None, H=None, Q_LEN=s, KV_LEN=s,
                                 device="cuda")
        flex = torch.compile(flex_attention, dynamic=False)
        fns = [lambda i=i: flex(qs[i].transpose(1, 2),
                                kvs[i, 0].transpose(1, 2),
                                kvs[i, 1].transpose(1, 2), block_mask=mask,
                                enable_gqa=True)
               for i in range(len(qs))]
        diff = float((fns[0]().transpose(1, 2).float() - ref.float()).abs()
                     .max())
        ms = cuda_time_ms(lambda: [fn() for fn in fns], iters=3,
                          warmup=1) / len(fns)
    except Exception as exc:  # a yardstick: report why, the phase goes on
        return None, (f"flex_attention (sliding-window block mask) did not "
                      f"run: {type(exc).__name__}: "
                      f"{str(exc).strip().splitlines()[0][:160]}")
    return ms, (f"flex_attention (compiled, sliding-window block mask) "
                f"device {ms * 1e3:.2f} us (CUDA events, eager), max |diff| "
                f"from the kernel {diff:.3g}")


def time_flash_ws_record(label, b, s, h, kh, gen):
    """A record only, the route unchanged: the warp-specialised kernel
    pinned at hd 128 against the routed wgmma kernel on 28 layers' inputs,
    graphs in turns (routed, pinned, pinned, routed); the pinned graph's
    replays must equal eager pinned calls bitwise."""
    import torch

    from repro_torch.kernels.flash_attention import (_launch,
                                                     flash_attention_cuda)
    dt, layers, hd = torch.bfloat16, 28, 128
    qs = _rand((layers, b, s, h, hd), dt, gen)
    kvs = _rand((layers, 2, b, s, kh, hd), dt, gen)
    routed = [lambda i=i: flash_attention_cuda(qs[i], kvs[i, 0], kvs[i, 1])
              for i in range(layers)]
    pinned = [lambda i=i: _launch(qs[i], kvs[i, 0], kvs[i, 1], True, None,
                                  "flash_bf16_ws_kernel")
              for i in range(layers)]
    replays = max(10, -(-280 // layers))
    r1, _ = graph_time_ms(routed, replays)
    p1, outs = graph_time_ms(pinned, replays)
    p2, _ = graph_time_ms(pinned, replays)
    r2, _ = graph_time_ms(routed, replays)
    for i, fn in enumerate(pinned):
        if not torch.equal(outs[i], fn()):
            fail(f"flash hd 128 ws record {label} R={b} S={s}: graph replay "
                 f"differs from eager")
    del outs, qs, kvs
    torch.cuda.empty_cache()
    ws, wg = (p1 + p2) / 2, (r1 + r2) / 2
    print(f"  flash_attention {label} R={b} S={s} hd 128, a record (route "
          f"unchanged): flash_bf16_ws_kernel pinned device {ws * 1e3:.2f} us "
          f"({p1 * 1e3:.2f}, {p2 * 1e3:.2f}), the routed "
          f"flash_bf16_wgmma_kernel {wg * 1e3:.2f} us ({r1 * 1e3:.2f}, "
          f"{r2 * 1e3:.2f})")
    return {"shape": f"{label} R={b} S={s}", "ws_ms": ws, "wgmma_ms": wg}


# ---------------------------------------------------------------------------
# phase 4-7: serving
# ---------------------------------------------------------------------------


def launcher_mix(n: int, seed: int = 0):
    """The launcher's synthetic request mix (64x64 image + text)."""
    import numpy as np

    from repro_torch.data.synthetic import make_image

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        u = rng.beta(1.6, 1.6)
        img = make_image(rng, u, 64, 64)
        text = (f"Request {i}: describe the Scene {i * 3}. "
                + "and then explain why it matters. " * rng.integers(1, 12))
        out.append((text, img))
    return out


def _watch_image_routes(server):
    """Wrap the scheduler's policy so that each decision on an image request
    records its inputs (request, scores, state snapshot, thresholds); the
    route is recomputed from them after the run. Returns the unwrapped
    ``decide`` and the records."""
    policy = server.scheduler.policy
    decide, seen = policy.decide, []

    def watched(request, scores, state):
        mod = request.modalities.get("image")
        if mod is not None and mod.data is not None:
            seen.append((request, dict(scores), state, dict(policy.taus)))
        return decide(request, scores, state)

    policy.decide = watched
    return decide, seen


def _check_image_scores(server, decide, seen, launches: int, label: str):
    """Every scored image request went through one kernel launch, its c_img
    is within SCORE_TOL of the plain CPU path's, and the plain score routes
    it the same way under the same state and thresholds."""
    import numpy as np

    from repro_torch.core import complexity as cx

    sch = server.scheduler
    policy = sch.policy
    taus, worst = dict(policy.taus), 0.0
    for req, scores, state, taus_then in seen:
        img = np.asarray(req.modalities["image"].data, np.float32)[None]
        plain = float(cx.image_complexity(img, sch.cc,
                                          use_kernel=False)["c_img"][0])
        err = abs(scores["image"] - plain)
        worst = max(worst, err)
        if err > SCORE_TOL:
            fail(f"{label}: rid {req.rid} c_img {scores['image']} vs plain "
                 f"CPU {plain}")
        policy.taus = dict(taus_then)
        routes = decide(req, scores, state).routes
        if decide(req, dict(scores, image=plain), state).routes != routes:
            fail(f"{label}: rid {req.rid} routes differ under the plain "
                 f"score")
    policy.taus = taus
    n_img = len({req.rid for req, *_ in seen})
    if launches != n_img:
        fail(f"{label}: {launches} image_stats launches for {n_img} scored "
             f"image requests")
    print(f"  {label}: score time per request (MoAOffScheduler.score) "
          f"{sch.score_time_s / sch.n_scored * 1e3:.3f} ms over "
          f"{sch.n_scored}; {n_img} image requests scored in {launches} "
          f"image_stats launches; c_img vs the plain CPU path max |err| "
          f"{worst:.3g} (tol {SCORE_TOL}), routes unchanged")


def time_score_paths():
    """Host wall per image score on the card, to the score on the host (as
    ``MoAOffScheduler.score`` reads it), in turns on the launcher's eight
    64x64 images: the two-step path (the statistics kernel, then
    ``image_complexity_from_stats``'s ~30 eager ops) against the fused
    launch; and the host-to-device copy of a 64x64 and a 1024x1024 numpy
    image (``core/complexity.py::_as_tensor``). Medians."""
    import numpy as np
    import torch

    from repro_torch.config import ComplexityConfig
    from repro_torch.kernels.image_complexity import (image_complexity_cuda,
                                                      image_stats_cuda)
    from repro_torch.kernels.ops import image_complexity_from_stats

    cc = ComplexityConfig()
    arrays = [img for _, img in launcher_mix(8)]
    # as core/complexity.py hands them to the kernel (make_image's arrays
    # are not C-ordered)
    imgs = [torch.as_tensor(a[None], device="cuda").contiguous()
            for a in arrays]
    paths = {
        "two-step": lambda x: float(image_complexity_from_stats(
            image_stats_cuda(x), 64, 64, cc)["c_img"][0]),
        "fused": lambda x: float(image_complexity_cuda(x, cc)["c_img"][0])}
    walls = {name: [] for name in paths}
    for fn in paths.values():
        for x in imgs:
            fn(x)  # warm
    for _ in range(5):
        for name in ("two-step", "fused", "fused", "two-step"):
            t0 = time.perf_counter()
            for x in imgs:
                paths[name](x)
            walls[name].append((time.perf_counter() - t0) / len(imgs))
    big = np.random.default_rng(0).uniform(0, 255, (1024, 1024)).astype(
        np.float32)
    copies = {}
    for name, arr in (("64x64", arrays[0]), ("1024x1024", big)):
        t = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.as_tensor(arr[None], device="cuda")
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        copies[name] = statistics.median(t)
    med = {name: statistics.median(w) for name, w in walls.items()}
    print(f"  image score wall per 64x64 request, to a host float, median "
          f"of 10 passes over 8 images in turns: two-step (kernel + eager "
          f"epilogue) {med['two-step'] * 1e6:.1f} us, fused "
          f"{med['fused'] * 1e6:.1f} us | host-to-device copy of one numpy "
          f"image (pageable), median of 21: 64x64 "
          f"{copies['64x64'] * 1e6:.1f} us, 1024x1024 "
          f"{copies['1024x1024'] * 1e6:.1f} us")


def serve(engines, topo, n_requests: int, max_new: int, label: str):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.tiers import ClusterServer

    server = ClusterServer(engines, topology=topo)
    decide, seen = _watch_image_routes(server)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for text, img in launcher_mix(n_requests):
        server.submit(text, image=img, max_new=max_new, slo_s=30.0)
    results = server.run(timeout_s=300.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    server.close()
    _check_image_scores(server, decide, seen, counts["image_stats"], label)
    if len(results) != n_requests:
        fail(f"{label}: {len(results)}/{n_requests} requests resolved")
    for r in results:
        if r.failed:
            fail(f"{label}: rid {r.rid} failed ({r.fail_reason})")
        vocab = engines[r.tier].cfg.vocab_size
        if not r.tokens or not all(0 <= t < vocab for t in r.tokens):
            fail(f"{label}: rid {r.rid} tokens out of range: {r.tokens}")
        if len(r.tokens) != max_new and r.tokens[-1] != 2:
            fail(f"{label}: rid {r.rid} stopped early without EOS")
    dec = sum(e.decode_tokens for e in engines.values())
    pre = sum(e.prefill_tokens for e in engines.values())
    split = {}
    for r in results:
        split[r.tier] = split.get(r.tier, 0) + 1
    lat = sorted(r.latency_s for r in results)
    ttft = sorted(r.ttft_s for r in results)
    print(f"  {label}: {len(results)} served {split} in {wall:.3f}s | "
          f"{dec} decode tokens ({dec / wall:.1f} tok/s), {pre} prompt "
          f"tokens | latency mean {sum(lat) / len(lat):.3f}s max "
          f"{lat[-1]:.3f}s | ttft mean {sum(ttft) / len(ttft):.3f}s | "
          f"launches {counts} | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for r in sorted(results, key=lambda r: r.rid):
        print(f"    rid={r.rid} tier={r.tier} routes={r.routes} "
              f"lat={r.latency_s:.3f}s ttft={r.ttft_s:.3f}s "
              f"tokens={r.tokens[:6]}...")
    return counts


def compare_prefill(auto_model, cuda_model, params, label):
    """One prefill batch of the serving shapes (R=4 rows, 256 patches + a
    64-token text bucket: S=320) through attn_impl "auto" (plain dense
    attention) and "cuda" (the flash-attention kernel) on the same weights;
    after one warm-up call each, six calls of each in turns (auto, cuda,
    cuda, auto, three rounds), wall clock to a synchronize, median."""
    import numpy as np
    import torch

    cfg = auto_model.cfg
    rng = np.random.default_rng(7)
    batch = {
        "tokens": torch.as_tensor(rng.integers(4, cfg.vocab_size, (4, 64)),
                                  dtype=torch.int32, device="cuda"),
        "patches": torch.as_tensor(rng.standard_normal(
            (4, cfg.num_patches, cfg.frontend_dim)), dtype=torch.float32,
            device="cuda")}
    models = {"auto": auto_model, "cuda": cuda_model}
    for model in models.values():
        model.prefill(params, batch, 512)  # warm-up
    out, walls = {}, {"auto": [], "cuda": []}
    for _ in range(3):  # in turns, so drift between calls hits both alike
        for name in ("auto", "cuda", "cuda", "auto"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = models[name].prefill(params, batch, 512)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            out[name] = logits.float()
    wall = {name: statistics.median(w) for name, w in walls.items()}
    if not all(bool(torch.isfinite(x).all()) for x in out.values()):
        fail(f"{label}: prefill logits are not finite")
    diff = float((out["auto"] - out["cuda"]).abs().max())
    agree = int((out["auto"].argmax(-1) == out["cuda"].argmax(-1)).sum())
    print(f"  prefill {label} R=4 S=320: max |logit auto - cuda| {diff:.4g} "
          f"(of max |logit| {float(out['auto'].abs().max()):.4g}), argmax "
          f"agrees on {agree}/4 rows | wall, median of 6 in turns: auto "
          f"{wall['auto'] * 1e3:.2f} ms ({min(walls['auto']) * 1e3:.2f}-"
          f"{max(walls['auto']) * 1e3:.2f}), cuda {wall['cuda'] * 1e3:.2f} ms "
          f"({min(walls['cuda']) * 1e3:.2f}-{max(walls['cuda']) * 1e3:.2f})")


def full_width_models():
    """The edge-cloud pair at full width and depth in bf16, random weights
    from the tier's seed (0 edge, 1 cloud): tier -> (model under attn_impl
    "cuda", its parameters)."""
    import torch

    from repro_torch.config import ServingConfig, get_topology
    from repro_torch.models import build_model
    from repro_torch.serving.tiers import build_cluster_engines

    t0 = time.perf_counter()
    sv = ServingConfig(max_batch=4, max_seq=512, paged=True, kv_page_size=64,
                       fused_steps=8)
    engines = build_cluster_engines(get_topology("edge-cloud"), sv,
                                    dtype="bfloat16", device="cuda",
                                    full_width=True)
    torch.cuda.synchronize()
    print(f"  built full-width engines in {time.perf_counter() - t0:.1f}s")
    return engines, {name: (build_model(e.cfg, attn_impl="cuda",
                                        device="cuda"), e.params)
                     for name, e in engines.items()}


def phase_serve_full(records, engines, built):
    import torch

    from repro_torch.config import ServingConfig, get_topology
    from repro_torch.serving.engine import TierEngine

    torch.cuda.reset_peak_memory_stats()
    sv = ServingConfig(max_batch=4, max_seq=512, paged=True, kv_page_size=64,
                       fused_steps=8)
    topo = get_topology("edge-cloud")
    # phase 4: prefill through the flash-attention kernel, same weights
    flash = {}
    for name, e in engines.items():
        model = built[name][0]
        compare_prefill(e.model, model, e.params, f"{name} ({e.cfg.name})")
        flash[name] = TierEngine(model, e.params, sv)
    counts = serve(flash, topo, 8, 16, "paged full width, attn cuda")
    time_score_paths()
    for name in ("image_stats", "flash_attention", "decode_attention_paged"):
        if counts[name] <= 0:
            fail(f"paged serve never launched {name}")
        records[name]["launches"] = counts[name]
    del flash
    # phase 5: the library-default dense pool on the "auto" models
    sv_dense = ServingConfig(max_batch=4, max_seq=512, paged=False,
                             fused_steps=8)
    dense = {name: TierEngine(e.model, e.params, sv_dense)
             for name, e in engines.items()}
    del engines
    counts = serve(dense, topo, 2, 16, "dense full width, attn auto")
    if counts["decode_attention"] <= 0:
        fail("dense serve never launched decode_attention")
    if counts["flash_attention"] != 0:
        fail("attn_impl auto reached the flash-attention kernel")
    records["decode_attention"]["launches"] = counts["decode_attention"]
    del dense
    torch.cuda.empty_cache()


def phase_impl_parity():
    """Reduced f32 engines: the kernels and their plain versions (attn_impl
    and decode_impl "cuda" against "torch") decode the same tokens, paged
    and dense. Prompts with patches prefill at S = 8 + bucket (24, 40, 72:
    off a multiple of 64), text-only ones at S = 64 and 128 (on one)."""
    import numpy as np
    import torch

    from repro_torch.config import ServingConfig
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced_config("qwen2-vl-2b").replace(dtype="float32")
    models = {impl: build_model(cfg, attn_impl=impl, device="cuda")
              for impl in ("cuda", "torch")}
    params = models["cuda"].init(0)
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(4, cfg.vocab_size, n).astype(np.int32),
                {"patches": rng.standard_normal(
                    (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}
                if n < 48 else {}) for n in (9, 21, 40, 50, 90)]
    for paged in (True, False):
        toks = {}
        for impl in ("cuda", "torch"):
            sv = ServingConfig(max_batch=4, max_seq=128, paged=paged,
                               kv_page_size=16, decode_impl=impl)
            eng = TierEngine(models[impl], params, sv)
            for rid, (p, extras) in enumerate(prompts):
                eng.submit(rid, p, max_new=12, extras=extras)
            toks[impl] = {s.rid: s.generated for s in eng.run_until_drained()}
        if toks["cuda"] != toks["torch"]:
            fail(f"paged={paged}: cuda {toks['cuda']} != torch "
                 f"{toks['torch']}")
        print(f"  reduced f32 paged={paged}: cuda and torch decode the same "
              f"{sum(len(t) for t in toks['cuda'].values())} tokens")


# ---------------------------------------------------------------------------
# phase 8: warm serving and migration
# ---------------------------------------------------------------------------


def _watch_warm(eng, log):
    """Record each warm admission of ``eng``: its kind, the cache positions
    it reused, the prefill it was charged against a cold prefill of the
    same prompt, the pool's shared pages just after it, and (for a resumed
    turn) its prompt and first-token logits. The wrappers, stored on the
    engine, reach it through a weak reference and call its class's methods:
    holding the engine (or its bound methods) would make a cycle that keeps
    the engine and its model on the card after the caller drops it, until
    a full collection (phase 12 checks that nothing of the kind is left)."""
    import weakref

    from repro_torch.kernels import ops

    ref, cls = weakref.ref(eng), type(eng)
    eng._launches = {}

    def stepped():
        e = ref()
        before = ops.launches()
        out = cls.step(e)
        for name, n in ops.launches().items():
            e._launches[name] = e._launches.get(name, 0) + n - before[name]
        return out

    def admit_warm(job, slot, plan):
        e = ref()
        pf0 = e.prefill_tokens
        cls._admit_warm(e, job, slot, plan)
        cold = len(job["tokens"]) + e._prompt_prefix(job["extras"])
        log.append({"kind": plan["kind"], "cached": int(plan["cached"]),
                    "charged": e.prefill_tokens - pf0, "cold": cold,
                    "shared": e.kv_gauges()["pages_shared"]})

    def start_seq(job, slot, prompt_len, first_logits, prefill_count=None,
                  warm=None):
        e = ref()
        if warm is not None and warm[0] == "resume":
            e._last_warm = (job, first_logits.copy())
        cls._start_seq(e, job, slot, prompt_len, first_logits,
                       prefill_count=prefill_count, warm=warm)

    eng._admit_warm, eng._start_seq, eng.step = admit_warm, start_seq, stepped


def _store_refs_hold(eng, label):
    """A drained paged engine's page references are the prefix store's
    holdings, page by page, and its free list agrees."""
    refs = {}
    for e in eng.prefix_store.lru._d.values():
        for p in e.data["pages"]:
            refs[p] = refs.get(p, 0) + 1
    eng.pool.check()
    held = {p: int(eng.pool.refcnt[p]) for p in range(1, eng.pool.num_pages + 1)
            if eng.pool.refcnt[p]}
    if held != refs:
        fail(f"{label}: pool references {held} != the store's {refs}")
    return len(refs)


def warm_full_width(records, built):
    """Phase 8 (a): full width, bf16, paged, prefill attention "cuda":
    3 sessions of 3 turns with an image each, then 4 text requests that
    share a long prefix, through ClusterServer(sessions=True)."""
    import numpy as np
    import torch

    from repro_torch.config import ServingConfig, get_topology
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import TierEngine
    from repro_torch.serving.tiers import ClusterServer

    # a cloud slot's rows at 512 positions: 28 x 2 x 4 x 128 x 2 B x 512 =
    # 29.4 MB; the budgets hold every park and every stored prefix
    sv = ServingConfig(max_batch=4, max_seq=512, paged=True, kv_page_size=64,
                       fused_steps=8, prefix_cache_mb=8192.0,
                       session_cache_mb=2048.0)
    topo = get_topology("edge-cloud")
    engines, logs = {}, {}
    for name, (model, params) in built.items():
        engines[name] = TierEngine(model, params, sv)
        logs[name] = []
        _watch_warm(engines[name], logs[name])
    server = ClusterServer(engines, topology=topo, sessions=True)
    imgs = [img for _, img in launcher_mix(3, seed=5)]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for turn in range(3):
        for s in range(3):
            text = ("you are a Helpful assistant; answer with Care. "
                    if turn == 0 else "") + (
                f"turn {turn}: tell me more about the Scene in view {s}. ")
            server.submit_turn(f"chat-{s}", text, image=imgs[s], max_new=8,
                               slo_s=60.0)
        server.run(timeout_s=300.0)
    system = ("Context: the assistant answers questions about a city's "
              "transit Network, its Lines, Stations and Timetables. " * 3)
    # a pinned (simple) text score keeps the four on one tier: the first
    # deposits the shared prefix, the other three hit it
    easy = {"text": 0.05}
    server.submit(system + "question 0: when does the first Train leave? ",
                  max_new=8, slo_s=60.0, complexity=easy)
    server.run(timeout_s=300.0)
    for i in range(1, 4):
        server.submit(system + f"question {i}: which Line serves Station "
                      f"{i * 7}? ", max_new=8, slo_s=60.0, complexity=easy)
    results = server.run(timeout_s=300.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    server.close()
    if len(results) != 13 or any(r.failed for r in results):
        fail(f"warm serve: {len(results)}/13 resolved, failed "
             f"{[r.rid for r in results if r.failed]}")
    for r in results:
        vocab = engines[r.tier].cfg.vocab_size
        if not r.tokens or not all(0 <= t < vocab for t in r.tokens):
            fail(f"warm serve: rid {r.rid} tokens out of range: {r.tokens}")
    allw = [w for log in logs.values() for w in log]
    resumed = [w for w in allw if w["kind"] == "resume"]
    hits = [w for w in allw if w["kind"] == "prefix"]
    if not resumed:
        fail("warm serve: no turn resumed its parked session")
    if not any(w["shared"] > 0 for w in hits):
        fail(f"warm serve: no copy-free prefix hit (hits {hits})")
    for w in allw:
        if w["charged"] != w["cold"] - w["cached"] or w["charged"] <= 0:
            fail(f"warm serve: a warm admission charged {w['charged']} "
                 f"prefill tokens, not its suffix ({w})")
    for name, eng in engines.items():
        pages = _store_refs_hold(eng, f"warm serve {name}")
        log = logs[name]
        charged = sum(w["charged"] for w in log)
        cold = sum(w["cold"] for w in log)
        print(f"  warm {name} ({eng.cfg.name}): {eng.resumed_sessions} "
              f"resumed turns, {eng.prefix_hits} prefix hits "
              f"(pages_shared after each: "
              f"{[w['shared'] for w in log if w['kind'] == 'prefix']}), "
              f"{eng.parks} parks; warm admissions charged {charged} "
              f"prefill tokens against {cold} for cold prefills of the same "
              f"prompts; decode_attention_paged launches "
              f"{eng._launches.get('decode_attention_paged', 0)}; drained "
              f"pool holds {pages} pages, all the prefix store's")
        sid = next(iter(eng.sessions.ids()), None)
        if sid is not None:  # one parked full-width slot on the wire
            payload = eng.sessions.peek(sid).data
            t0 = time.perf_counter()
            wire = payload.to_bytes()
            print(f"    parked slot {sid} on {name}: wire "
                  f"{len(wire) / 1e6:.3f} MB, to_bytes "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    print(f"  warm serve: 13 requests in {wall:.3f}s | launches {counts}")
    # one resumed turn's first-token logits against a cold prefill of the
    # same full prompt (bf16, other attention path: reported, not held)
    eng = next(e for e in engines.values() if hasattr(e, "_last_warm"))
    job, warm_logits = eng._last_warm
    batch = eng._device_batch(np.asarray(job["tokens"])[None], {
        k: np.asarray(v)[None] for k, v in job["extras"].items()})
    cold_logits, _ = eng.model.prefill(eng.params, batch, 512)
    cold_logits = cold_logits.float().cpu().numpy()[0]
    print(f"  resumed turn ({eng.cfg.name}, {len(job['tokens'])} tokens + "
          f"{eng._prompt_prefix(job['extras'])} patches): first-token "
          f"logits max |warm - cold| "
          f"{float(np.abs(warm_logits - cold_logits).max()):.4g} of max "
          f"|logit| {float(np.abs(cold_logits).max()):.4g}, argmax "
          f"{'agrees' if warm_logits.argmax() == cold_logits.argmax() else 'differs'}")
    for name in ("flash_attention", "decode_attention_paged"):
        if counts[name] <= 0:
            fail(f"warm serve never launched {name}")
    for name, n in counts.items():
        records[name]["launches"] = records[name].get("launches", 0) + n


def _alone(eng, prompt, max_new, steps=None):
    """Serve one request alone; with ``steps`` stop after that many fused
    blocks and return the engine instead of the tokens."""
    eng.submit(0, prompt["tokens"], max_new=max_new, extras=prompt["extras"])
    if steps is not None:
        for _ in range(steps):
            eng.step()
        return eng
    return {s.rid: list(s.generated) for s in eng.run_until_drained()}[0]


def _bits(t):
    """A tensor's bit pattern as integers (NaN-safe bitwise comparison)."""
    import torch

    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


def migrate_full_width(records, built):
    """Phase 8 (b): full width, bf16, two qwen2-vl-2b engines with the same
    max_batch, one paged and one dense: a request decoded two fused blocks
    on one, moved through the wire into the other, finishes with the
    tokens of the same move made in process (``extract_slot`` straight
    into ``inject_slot``), both directions, and its first two blocks' tokens
    are those it decodes alone on the source kind. The paged decode reads
    each slot's extent, so its bf16 sums split where the dense kernel's do
    not and the two kinds alone may part at a near tie: each kind is held
    to itself, and the tokens the two share alone are printed."""
    import numpy as np
    import torch

    from repro_torch.config import ServingConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import SlotPayload, TierEngine

    model, params = built["edge"]
    cfg = model.cfg
    rng = np.random.default_rng(11)
    prompt = {"tokens": rng.integers(4, cfg.vocab_size, 40).astype(np.int32),
              "extras": {"patches": rng.standard_normal(
                  (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}}
    svs = {"paged": ServingConfig(max_batch=4, max_seq=512, paged=True,
                                  kv_page_size=64, fused_steps=8),
           "dense": ServingConfig(max_batch=4, max_seq=512, fused_steps=8)}

    def engine(kind):
        return TierEngine(model, params, svs[kind])

    def drain(eng):
        return {s.rid: list(s.generated) for s in eng.run_until_drained()}[0]

    ops.reset_launches()
    alone = {kind: _alone(engine(kind), prompt, 40) for kind in svs}
    shared = next((i for i, (a, b) in enumerate(zip(alone["paged"],
                                                    alone["dense"]))
                   if a != b), min(len(alone["paged"]), len(alone["dense"])))
    print(f"  {cfg.name} bf16 alone: paged (extents) and dense share their "
          f"first {shared} of {len(alone['dense'])} tokens")
    for src, dst in (("paged", "dense"), ("dense", "paged")):
        donor = _alone(engine(src), prompt, 40, steps=2)
        payload = donor.extract_slot(0, remove=True)
        t0 = time.perf_counter()
        wire = payload.to_bytes()
        t_out = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = SlotPayload.from_bytes(wire)
        t_in = time.perf_counter() - t0
        for name, leaf in payload.leaves.items():
            if not torch.equal(_bits(back.leaves[name]), _bits(leaf.cpu())):
                fail(f"migrate {src}->{dst}: leaf {name} changed on the wire")
        target = engine(dst)
        target.inject_slot(back)
        got = drain(target)
        if target.prefill_tokens != 0:
            fail(f"migrate {src}->{dst}: the target prefilled")
        moved = len(payload.seq.generated)
        if got[:moved] != alone[src][:moved]:
            fail(f"migrate {src}->{dst}: the source's {moved} tokens "
                 f"{got[:moved]} != alone on {src} {alone[src][:moved]}")
        direct = engine(dst)
        direct.inject_slot(_alone(engine(src), prompt, 40, steps=2)
                           .extract_slot(0, remove=True))
        want = drain(direct)
        if got != want:
            fail(f"migrate {src}->{dst}: {got} != the same move in process "
                 f"{want}")
        print(f"  migrate {cfg.name} bf16 {src} -> {dst} after {moved} "
              f"tokens: wire {len(wire) / 1e6:.3f} MB (to_bytes "
              f"{t_out * 1e3:.1f} ms, from_bytes {t_in * 1e3:.1f} ms), "
              f"leaves bitwise, {len(got)} tokens equal to the move in "
              f"process, the first {moved} to the request alone on {src}; "
              f"{sum(a == b for a, b in zip(got, alone[dst]))} of them at "
              f"the positions of the request alone on {dst}")
    counts = ops.launches()
    print(f"  migration runs (two alone, two moved, two moved in process):"
          f" launches {counts}")
    for name in ("decode_attention", "decode_attention_paged"):
        if counts[name] <= 0:
            fail(f"migration never launched {name}")
    for name, n in counts.items():
        records[name]["launches"] = records[name].get("launches", 0) + n


def warm_reduced_parity():
    """Phase 8 (c): reduced f32 on the card, attn_impl and decode_impl
    "cuda": a prefix hit and a resumed session decode the tokens of cold
    serving, paged and dense; a migration at temperature 0.7 continues
    with the tokens of the unmigrated run."""
    import numpy as np

    from repro_torch.config import ServingConfig
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import SlotPayload, TierEngine

    cfg = reduced_config("qwen2-vl-2b").replace(dtype="float32")
    model = build_model(cfg, attn_impl="cuda", device="cuda")
    params = model.init(0)
    rng = np.random.default_rng(0)
    base = rng.integers(4, 200, 40).astype(np.int32)
    ext = rng.integers(4, 200, 10).astype(np.int32)
    extras = {"patches": rng.standard_normal(
        (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}

    def engine(paged, temp=0.0, **kw):
        return TierEngine(model, params, ServingConfig(
            max_batch=2, max_seq=128, paged=paged, kv_page_size=16,
            decode_impl="cuda", **kw), eos_id=-1, sample_temp=temp)

    def run(eng, rid, toks, max_new, session=None):
        eng.submit(rid, toks, max_new=max_new, extras=dict(extras),
                   session=session)
        return {s.rid: list(s.generated) for s in eng.run_until_drained()}[rid]

    for paged in (False, True):
        full = np.concatenate([base, ext])
        cold = run(engine(paged), 0, full, 8)
        warm = engine(paged, prefix_cache_mb=64.0)
        run(warm, 0, base, 8)
        if run(warm, 1, full, 8) != cold or warm.prefix_hits != 1:
            fail(f"reduced paged={paged}: prefix hit != cold")
        eng = engine(paged)
        gen = run(eng, 0, base, 6, session="s")
        hist = np.concatenate([base, np.asarray(gen, np.int32), ext])
        got = run(eng, 1, hist, 6, session="s")
        if got != run(engine(paged), 0, hist, 6) or eng.resumed_sessions != 1:
            fail(f"reduced paged={paged}: resumed session != cold")
        ref = engine(paged, temp=0.7)
        want = run(ref, 0, full, 24)
        donor = engine(paged, temp=0.7)
        donor.submit(0, full, max_new=24, extras=dict(extras))
        donor.step()
        wire = donor.extract_slot(0).to_bytes()
        target = engine(not paged, temp=0.7)
        target.inject_slot(SlotPayload.from_bytes(wire))
        got = {s.rid: list(s.generated)
               for s in target.run_until_drained()}[0]
        if got != want:
            fail(f"reduced paged={paged}: temperature-0.7 migration {got} "
                 f"!= unmigrated {want}")
        print(f"  reduced f32 cuda paged={paged}: prefix hit and resumed "
              f"session equal cold; a temp-0.7 migration to "
              f"{'dense' if paged else 'paged'} equals the unmigrated "
              f"{len(want)} tokens")


def phase_warm(records, built):
    warm_full_width(records, built)
    migrate_full_width(records, built)
    warm_reduced_parity()


# ---------------------------------------------------------------------------
# phase 9: speculative decoding and process replicas
# ---------------------------------------------------------------------------


def codrive(teng, deng, rid, prompt, max_new, k):
    """Cross-tier speculation on one request, as the runtime's co-drive
    runs it: the target ``teng`` admits it, the draft ``deng`` admits a
    quiet shadow, then draft blocks of ``k`` and verify rounds alternate
    until the request finishes or the draft runs out of room; the fused
    path finishes the rest. Each draft block, verify round and draft-side
    sync is timed to a synchronize, and the draft side's dense
    decode-attention launches are counted. Returns the committed tokens and
    the round records; ``blocks`` holds each draft block beside the number
    of tokens the target had generated before it was verified."""
    import torch

    from repro_torch.kernels import ops

    teng.submit(rid, prompt["tokens"], max_new=max_new,
                extras=dict(prompt["extras"]))
    teng._admit()
    if teng.spec_slot(rid) is None:
        fail(f"co-drive rid {rid}: the target did not admit")
    if deng.spec_admit_quiet(rid, prompt["tokens"], max_new=max_new + k + 2,
                             extras=dict(prompt["extras"])) is None:
        fail(f"co-drive rid {rid}: the draft shadow did not admit")
    deng.spec_set_pending(rid, teng.slots[teng.spec_slot(rid)].generated[-1])
    teng.spec_begin(rid)
    rec = {"draft_s": [], "verify_s": [], "sync_s": [], "draft_launches": 0,
           "drafted": 0, "accepted": 0, "committed": 0, "rounds": 0,
           "blocks": []}
    while True:
        torch.cuda.synchronize()
        before = ops.launches()["decode_attention"]
        t0 = time.perf_counter()
        d = deng.spec_draft(rid, k)
        torch.cuda.synchronize()
        rec["draft_s"].append(time.perf_counter() - t0)
        rec["draft_launches"] += ops.launches()["decode_attention"] - before
        if d is None or len(d) == 0:
            rec["draft_s"].pop()
            break
        rec["blocks"].append(
            (len(teng.slots[teng.spec_slot(rid)].generated),
             [int(t) for t in d]))
        t0 = time.perf_counter()
        res = teng.spec_verify(rid, d)
        torch.cuda.synchronize()
        rec["verify_s"].append(time.perf_counter() - t0)
        rec["drafted"] += res["drafted"]
        rec["accepted"] += res["accepted"]
        rec["committed"] += len(res["committed"])
        rec["rounds"] += 1
        if res["finished"]:
            break
        t0 = time.perf_counter()
        synced = deng.spec_sync(rid, res["committed"])
        torch.cuda.synchronize()
        rec["sync_s"].append(time.perf_counter() - t0)
        if not synced:
            break
    deng.cancel(rid)
    if teng.spec_slot(rid) is not None:
        teng.spec_release(rid)
    toks = {s.rid: list(s.generated) for s in teng.run_until_drained()}[rid]
    teng.finished.clear()
    return toks, rec


def _pool_drained(eng, label):
    """A drained paged engine with no prefix store holds no page."""
    eng.pool.check()
    if eng.pool.pages_free != eng.pool.num_pages:
        fail(f"{label}: {eng.pool.num_pages - eng.pool.pages_free} pages "
             f"still held after the drain")


def _agreement(got, want):
    same = sum(a == b for a, b in zip(got, want))
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    return (f"{same}/{len(want)} tokens equal to target-only decode, first "
            f"divergence at {'none' if first is None else first}")


def spec_full_width(records, built):
    """Phase 9 (a): full width, bf16, paged, prefill attention "cuda":
    the launcher's mix through ClusterServer(spec=edge:cloud, k=4), then a
    self-draft pair (two engines over the cloud model and its weights) at
    k = 4 and 8, against target-only decode of the same request."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import ServingConfig, SpecConfig, get_topology
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import TierEngine
    from repro_torch.serving.tiers import ClusterServer

    sv = ServingConfig(max_batch=4, max_seq=512, paged=True, kv_page_size=64,
                       fused_steps=8)
    topo = get_topology("edge-cloud")
    engines = {name: TierEngine(model, params, sv)
               for name, (model, params) in built.items()}
    server = ClusterServer(engines, topology=topo,
                           spec=SpecConfig("edge", "cloud", draft_k=4))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    # two requests pinned to cloud fusion (a hard text score), so the
    # speculate gate opens for at least two
    for i, (text, img) in enumerate(launcher_mix(4, seed=9)):
        server.submit(text, image=img, max_new=16, slo_s=60.0,
                      complexity={"text": 0.95} if i < 2 else None)
    results = server.run(timeout_s=300.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    server.close()
    if len(results) != 4 or any(r.failed for r in results):
        fail(f"speculative serve: {len(results)}/4 resolved, failed "
             f"{[r.rid for r in results if r.failed]}")
    for r in results:
        vocab = engines[r.tier].cfg.vocab_size
        if not r.tokens or not all(0 <= t < vocab for t in r.tokens):
            fail(f"speculative serve: rid {r.rid} tokens out of range")
    outs = server.runtime.outcomes
    spun = [o for o in outs if o.drafted_tokens > 0]
    if len(spun) < 2:
        fail(f"speculative serve: {len(spun)} requests speculated, want 2+")
    cloud = engines["cloud"]
    if cloud.spec_rounds <= 0:
        fail("speculative serve: no verify round ran")
    served = sum(len(r.tokens) for r in results if r.tier == "cloud")
    if cloud.decode_tokens != served:
        fail(f"speculative serve: cloud decode_tokens {cloud.decode_tokens} "
             f"!= {served} committed tokens")
    for name, eng in engines.items():
        _pool_drained(eng, f"speculative serve {name}")
    drafted = sum(o.drafted_tokens for o in outs)
    accepted = sum(o.accepted_tokens for o in outs)
    print(f"  speculative serve (edge drafts, cloud verifies, k=4): 4 "
          f"requests in {wall:.3f}s, {len(spun)} speculated, "
          f"{cloud.spec_rounds} verify rounds, {accepted}/{drafted} draft "
          f"tokens accepted | launches {counts}")
    for name, n in counts.items():
        records[name]["launches"] = records[name].get("launches", 0) + n

    # the self-draft pair: the accept path at real shapes
    model, params = built["cloud"]
    cfg = model.cfg
    rng = np.random.default_rng(13)
    prompt = {"tokens": rng.integers(4, cfg.vocab_size, 40).astype(np.int32),
              "extras": {"patches": rng.standard_normal(
                  (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}}
    max_new = 48

    def engine(serving=sv):
        return TierEngine(model, params, serving, eos_id=-1)

    alone = _alone(engine(), prompt, max_new)
    ops.reset_launches()
    for k in (4, 8):
        teng, deng = engine(), engine()
        toks, rec = codrive(teng, deng, 0, prompt, max_new, k)
        if rec["rounds"] <= 0:
            fail(f"self-draft k={k}: no verify round ran")
        if teng.decode_tokens != len(toks) or len(toks) != max_new:
            fail(f"self-draft k={k}: decode_tokens {teng.decode_tokens}, "
                 f"{len(toks)} committed of {max_new}")
        _pool_drained(teng, f"self-draft k={k} target")
        _pool_drained(deng, f"self-draft k={k} draft")
        # the draft block decodes a batch-1 DENSE copy of a paged slot
        if rec["draft_launches"] != cfg.num_layers * deng.drafted_tokens:
            fail(f"self-draft k={k}: {rec['draft_launches']} dense decode "
                 f"launches for {deng.drafted_tokens} drafted tokens")
        # k fused decode steps on one slot, the same request
        fused = engine(dataclasses.replace(sv, fused_steps=k))
        fused.submit(0, prompt["tokens"], max_new=max_new,
                     extras=dict(prompt["extras"]))
        fused.step()  # admission + the first block
        blocks = []
        while fused.slots[0] is not None and len(blocks) < 5:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fused.step()
            torch.cuda.synchronize()
            blocks.append(time.perf_counter() - t0)
        fused.run_until_drained()
        # a round's whole cost (draft block + verify + draft-side sync) per
        # token it committed, against a fused step's
        spent = sum(rec["draft_s"]) + sum(rec["verify_s"]) + sum(rec["sync_s"])
        per_tok = spent / max(rec["committed"], 1)
        print(f"  self-draft {cfg.name} bf16 k={k}: {rec['rounds']} rounds, "
              f"{rec['accepted']}/{rec['drafted']} accepted "
              f"({rec['accepted'] / max(rec['drafted'], 1):.0%}); "
              f"{_agreement(toks, alone)} | verify round (k+1={k + 1} "
              f"tokens, one chunk) median "
              f"{statistics.median(rec['verify_s']) * 1e3:.2f} ms vs one "
              f"fused block of {k} decode steps on the slot "
              f"{statistics.median(blocks) * 1e3:.2f} ms (median of "
              f"{len(blocks)}); draft block median "
              f"{statistics.median(rec['draft_s']) * 1e3:.2f} ms; sync "
              f"(draft-side chunk) median "
              f"{statistics.median(rec['sync_s'] or [0.0]) * 1e3:.2f} ms; "
              f"draft + verify + sync {spent * 1e3:.2f} ms for "
              f"{rec['committed']} committed tokens, {per_tok * 1e3:.2f} ms a "
              f"token vs fused {statistics.median(blocks) / k * 1e3:.2f} ms a "
              f"token; draft side: {rec['draft_launches']} decode_attention "
              f"(dense) launches")
    counts = ops.launches()
    for name, n in counts.items():
        records[name]["launches"] = records[name].get("launches", 0) + n


def _spec_drive_target(eng, prompt, max_new, draft_for):
    """Target-side verify protocol with drafts from ``draft_for(generated)``
    (an empty block stops speculating; the fused path finishes)."""
    eng.submit(0, prompt["tokens"], max_new=max_new,
               extras=dict(prompt["extras"]))
    eng._admit()
    if eng.spec_slot(0) is not None:
        eng.spec_begin(0)
        while eng.spec_slot(0) is not None:
            draft = draft_for(list(eng.slots[eng.spec_slot(0)].generated))
            if not draft:
                break
            res = eng.spec_verify(0, draft)
            if res is None or res["finished"]:
                break
        if eng.spec_slot(0) is not None:
            eng.spec_release(0)
    return {s.rid: list(s.generated) for s in eng.run_until_drained()}[0]


def spec_reduced_parity():
    """Phase 9 (b): reduced f32 on the card, attn_impl and decode_impl
    "cuda", paged and dense: perfect, garbage and partial drafts commit the
    fused tokens, at temperature 0 and 0.7; and a two-engine co-drive (a
    draft engine over the same model and weights) whose draft blocks are
    the draft engine's own fused tokens and whose committed tokens are the
    target's fused tokens."""
    import numpy as np

    from repro_torch.config import ServingConfig
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    cfg = reduced_config("qwen2-vl-2b").replace(dtype="float32")
    model = build_model(cfg, attn_impl="cuda", device="cuda")
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompt = {"tokens": rng.integers(4, 200, 10).astype(np.int32),
              "extras": {"patches": rng.standard_normal(
                  (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}}
    v = cfg.vocab_size
    for paged in (False, True):
        for temp in (0.0, 0.7):
            def engine():
                return TierEngine(model, params, ServingConfig(
                    max_batch=2, max_seq=96, paged=paged, kv_page_size=16,
                    decode_impl="cuda"), eos_id=-1, sample_temp=temp,
                    seed=11)

            ref = _alone(engine(), prompt, 16)
            drafts = {
                "perfect": lambda g: ref[len(g):len(g) + 4],
                "garbage": lambda g: [(t + 1) % v
                                      for t in ref[len(g):len(g) + 4]],
                "partial": lambda g: [t if i != 2 else (t + 1) % v for i, t
                                      in enumerate(ref[len(g):len(g) + 5])]}
            for name, draft_for in drafts.items():
                eng = engine()
                got = _spec_drive_target(eng, prompt, 16, draft_for)
                if got != ref:
                    fail(f"reduced spec paged={paged} temp={temp} {name}: "
                         f"{got} != fused {ref}")
                if eng.decode_tokens != len(ref) or eng.spec_rounds <= 0:
                    fail(f"reduced spec paged={paged} temp={temp} {name}: "
                         f"decode_tokens {eng.decode_tokens}, rounds "
                         f"{eng.spec_rounds}")
                if paged:
                    _pool_drained(eng, f"reduced spec {name}")
            k, label = 4, f"reduced co-drive paged={paged} temp={temp}"
            own = _alone(engine(), prompt, 16 + k + 2)  # the draft's fused
            teng, deng = engine(), engine()
            toks, rec = codrive(teng, deng, 0, prompt, 16, k)
            if toks != ref:
                fail(f"{label}: committed {toks} != fused {ref}")
            if rec["rounds"] <= 0 or teng.decode_tokens != len(ref):
                fail(f"{label}: {rec['rounds']} rounds, decode_tokens "
                     f"{teng.decode_tokens}")
            for n, block in rec["blocks"]:
                if block != own[n:n + len(block)]:
                    fail(f"{label}: draft block {block} after {n} tokens != "
                         f"the draft engine's fused {own[n:n + len(block)]}")
            if paged:
                _pool_drained(teng, f"{label} target")
                _pool_drained(deng, f"{label} draft")
        print(f"  reduced f32 cuda paged={paged}: perfect, garbage and "
              f"partial drafts commit the fused tokens at temperature 0 "
              f"and 0.7; a two-engine co-drive drafts the draft engine's "
              f"fused tokens and commits the target's "
              f"({rec['accepted']}/{rec['drafted']} accepted at 0.7)")


def process_replicas_cuda():
    """Phase 9 (c): two spawned edge replicas on "cuda" (reduced f32,
    paged) serve 4 requests with the tokens of two local replicas on the
    card; a killed worker's rid is reported lost and its sibling serves it
    with the local tokens."""
    import numpy as np

    from repro_torch.config import ServingConfig
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine
    from repro_torch.serving.pool import EnginePool
    from repro_torch.serving.transport import (LocalTransport,
                                               ProcessTransport, ReplicaSpec)

    sv = ServingConfig(max_batch=2, max_seq=96, paged=True, kv_page_size=16)
    cfg = reduced_config("qwen2-vl-2b").replace(dtype="float32")
    rng = np.random.default_rng(3)
    jobs = [(rid, rng.integers(4, 200, 8 + 5 * rid).astype(np.int32),
             {"patches": rng.standard_normal(
                 (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}
             if rid % 2 else {}) for rid in range(5)]

    def serve(pool, subset):
        for rid, toks, extras in subset:
            pool.submit_to(rid % 2, rid, toks, max_new=12, extras=extras,
                           deadline=None, session=None)
        fins, deadline = [], time.monotonic() + 120.0
        while time.monotonic() < deadline:
            f, active, lost = pool.poll()
            fins.extend(f)
            if lost:
                fail(f"process replicas: rids {lost} lost")
            if not active and not f:
                return {s.rid: list(s.generated) for s in fins}
            time.sleep(0.002)
        fail("process replicas: the pool did not drain")

    model = build_model(cfg, device="cuda")
    params = model.init(0)
    local = EnginePool("edge", [LocalTransport(TierEngine(model, params, sv))
                                for _ in range(2)])
    want = serve(local, jobs)
    t0 = time.perf_counter()
    pool = EnginePool("edge", [ProcessTransport(ReplicaSpec(
        model="qwen2-vl-2b", serving=sv, param_seed=0, name=f"edge/{r}",
        device="cuda")) for r in range(2)])
    t_spawn = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        got = serve(pool, jobs[:4])
        t_serve = time.perf_counter() - t0
        if got != {rid: want[rid] for rid in range(4)}:
            fail(f"process replicas: {got} != local {want}")
        rid, toks, extras = jobs[4]
        pool.submit_to(0, rid, toks, max_new=12, extras=extras,
                       deadline=None, session=None)
        pool.transports[0]._proc.kill()
        lost, deadline = [], time.monotonic() + 60.0
        while not lost and time.monotonic() < deadline:
            _, _, lost = pool.poll()
        if lost != [rid] or pool.n_alive != 1:
            fail(f"process replicas: lost {lost} after the kill, "
                 f"{pool.n_alive} alive")
        pool.submit_to(1, rid, toks, max_new=12, extras=extras,
                       deadline=None, session=None)
        rescued = serve(pool, [])
        if rescued != {rid: want[rid]}:
            fail(f"process replicas: rescued {rescued} != local "
                 f"{want[rid]}")
    finally:
        pool.close()
    print(f"  process replicas on cuda: 2 workers ready in {t_spawn:.1f}s, "
          f"4 requests in {t_serve:.3f}s with the local replicas' tokens; "
          f"a killed worker's rid {rid} rescued by its sibling")


def phase_spec(records, built):
    spec_full_width(records, built)
    spec_reduced_parity()
    process_replicas_cuda()


# ---------------------------------------------------------------------------
# phase 10: the recurrent families; phase 11: the attention zoo at hd 96
# ---------------------------------------------------------------------------


def _serve_direct(eng, prompts, label):
    """Serve ``(tokens, max_new)`` or ``(tokens, max_new, extras)`` prompts
    on one engine, the launch counts reset just before; fail unless every
    request finishes with its tokens in the vocabulary. Returns (tokens by
    rid, counts, counts by shape, wall seconds)."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for rid, (toks, max_new, *extras) in enumerate(prompts):
        eng.submit(rid, toks, max_new=max_new, extras=dict(*extras))
    done = {s.rid: list(s.generated) for s in eng.run_until_drained()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_shape = ops.launches(), ops.launches_by_shape()
    vocab = eng.cfg.vocab_size
    if sorted(done) != list(range(len(prompts))):
        fail(f"{label}: finished {sorted(done)} of {len(prompts)}")
    for rid, (_, max_new, *_) in enumerate(prompts):
        toks = done[rid]
        if not toks or not all(0 <= t < vocab for t in toks):
            fail(f"{label}: rid {rid} tokens out of the vocabulary: {toks}")
        if len(toks) != max_new and toks[-1] != eng.eos_id:
            fail(f"{label}: rid {rid} stopped early without EOS")
    return done, counts, by_shape, wall


#: a full-width prefill under attn_impl "cuda" (the flash kernel) against
#: "auto" (plain PyTorch) on the same bf16 weights: the two attention paths
#: round differently in bf16 and the difference grows through the layers;
#: the logits must agree within a tenth of their largest magnitude, argmax
#: equal
PREFILL_GATE = 0.1


def _hold_prefill(label, logits):
    """Gate two prefills' last-token logits (``{"auto": ..., "cuda": ...}``,
    float32): finite, within ``PREFILL_GATE`` of the largest |logit|,
    argmax equal. Returns (max |diff|, largest |logit|, gate)."""
    import torch

    if not all(bool(torch.isfinite(x).all()) for x in logits.values()):
        fail(f"{label} prefill logits are not finite")
    diff = float((logits["auto"] - logits["cuda"]).abs().max())
    top = float(logits["auto"].abs().max())
    gate = PREFILL_GATE * top
    agree = bool((logits["auto"].argmax(-1) == logits["cuda"].argmax(-1))
                 .all())
    if diff > gate or not agree:
        fail(f"{label} prefill: cuda against auto max |diff| {diff:.4g} "
             f"(gate {gate:.4g}), argmax {'equal' if agree else 'differs'}")
    return diff, top, gate


def recurrentgemma_full_width(records):
    """Phase 10 (a): recurrentgemma-9b at full width and depth (38 layers:
    12 x (rglru, rglru, local attention) + 2 rglru; d 4096, 16 query heads
    on 1 KV head of 256, window 2048, vocab 256000), bf16, random weights
    drawn on the card; the 3000-token prompt's prefill logits under
    attn_impl "cuda" (the flash kernel, window 2048) against "auto"
    ("local", plain PyTorch); then three requests through a TierEngine
    under "cuda" (64-200-token prompts with 32 new tokens and the
    3000-token prompt with 64: its ring of 2048 rows wraps in prefill and
    again in decode). Fails unless the flash kernel and the dense decode
    kernel launched at hd 256, group 16."""
    import numpy as np
    import torch

    from repro_torch.config import ServingConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    cfg = get_config("recurrentgemma-9b").replace(dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, attn_impl="cuda", device="cuda")
    params = model.init(0)
    auto = build_model(cfg, attn_impl="auto", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"  recurrentgemma-9b: {n_params / 1e9:.3f} B parameters drawn on "
          f"the card in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(10)
    long = rng.integers(4, cfg.vocab_size, 3000).astype(np.int32)
    batch = {"tokens": torch.as_tensor(long[None], device="cuda")}
    logits, walls = {}, {"auto": [], "cuda": []}
    for m in (auto, model):
        m.prefill(params, batch, 4096)  # warm-up
    for name in ("auto", "cuda", "cuda", "auto"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, _ = (auto if name == "auto" else model).prefill(params, batch,
                                                             4096)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t1)
        logits[name] = out.float()
    diff, top, gate = _hold_prefill("recurrentgemma", logits)
    print(f"  recurrentgemma prefill S=3000: max |logit auto - cuda| "
          f"{diff:.4g} (of max |logit| {top:.4g}; gate {gate:.4g}), argmax "
          f"agrees | wall, median of 2 "
          f"in turns: auto (local) {statistics.median(walls['auto']) * 1e3:.1f}"
          f" ms, cuda (flash kernel) "
          f"{statistics.median(walls['cuda']) * 1e3:.1f} ms")
    del auto
    sv = ServingConfig(max_batch=4, max_seq=4096, paged=True,
                       kv_page_size=64, fused_steps=8)
    eng = TierEngine(model, params, sv)
    prompts = [(rng.integers(4, cfg.vocab_size, n).astype(np.int32), m)
               for n, m in ((64, 32), (200, 32), (3000, 64))]
    done, counts, by_shape, wall = _serve_direct(eng, prompts,
                                                 "recurrentgemma serve")
    key = (cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads)
    for name in ("flash_attention", "decode_attention"):
        if by_shape[name].get(key, 0) <= 0:
            fail(f"recurrentgemma serve never launched {name} at (hd, "
                 f"group) {key}: {by_shape[name]}")
        records[name]["launches"] = (records[name].get("launches", 0)
                                      + counts[name])
    ring = eng.cache["pos"].shape[1]
    print(f"  recurrentgemma serve (paged pool, recurrent state dense, "
          f"{eng._slot_page_charge} pages a slot): 3 requests in {wall:.3f}s,"
          f" {eng.decode_tokens} decode / {eng.prefill_tokens} prompt tokens,"
          f" ring of {ring} rows (the 3000-token prompt's wrapped), launches "
          f"{counts} by (hd, group) {by_shape} | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for rid in sorted(done):
        print(f"    rid={rid} prompt={len(prompts[rid][0])} "
              f"tokens={done[rid][:6]}...")
    del eng, model, params
    torch.cuda.empty_cache()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def mamba2_full_width(records):
    """Phase 10 (b): mamba2-2.7b at full width and depth (64 Mamba-2 layers,
    d 2560, 80 SSD heads of 64, state 128, vocab 50280), bf16, random
    weights on the card, four requests of 32 new tokens. The family has no
    attention: the run fails if it launched an attention kernel."""
    import numpy as np
    import torch

    from repro_torch.config import ServingConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    cfg = get_config("mamba2-2.7b").replace(dtype="bfloat16")
    model = build_model(cfg, attn_impl="cuda", device="cuda")
    params = model.init(0)
    n_params = sum(p.numel() for p in _leaves(params))
    sv = ServingConfig(max_batch=4, max_seq=1024, paged=True,
                       kv_page_size=64, fused_steps=8)
    eng = TierEngine(model, params, sv)
    rng = np.random.default_rng(11)
    prompts = [(rng.integers(4, cfg.vocab_size, n).astype(np.int32), 32)
               for n in (48, 130, 257, 400)]
    done, counts, _, wall = _serve_direct(eng, prompts, "mamba2 serve")
    attn = {k: v for k, v in counts.items() if k != "image_stats"}
    if any(attn.values()):
        fail(f"mamba2 (no attention) launched an attention kernel: {attn}")
    print(f"  mamba2-2.7b ({n_params / 1e9:.3f} B parameters, bf16): 4 "
          f"requests in {wall:.3f}s, {eng.decode_tokens} decode / "
          f"{eng.prefill_tokens} prompt tokens; it launches no attention "
          f"kernel (launches {counts}) | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del eng, model, params
    torch.cuda.empty_cache()


def recurrent_reduced_parity():
    """Phase 10 (c): reduced f32 hybrid and ssm engines on the card with the
    kernels (attn_impl and decode_impl "cuda") against the same weights on
    the CPU with the plain versions ("torch"): equal tokens, fused and per
    token, paged and dense (hybrid prompts past its window of 32). On the
    card, a resumed session and a self-draft speculative round (a garbage
    block: the recurrent re-feed) commit the fused tokens."""
    import numpy as np

    from repro_torch.config import ServingConfig
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    for arch in ("recurrentgemma-9b", "mamba2-2.7b"):
        cfg = reduced_config(arch).replace(dtype="float32")
        cpu = build_model(cfg, attn_impl="torch", device="cpu")
        gpu = build_model(cfg, attn_impl="cuda", device="cuda")
        p_cpu = cpu.init(0)
        p_gpu = _tree_to(p_cpu, "cuda")
        rng = np.random.default_rng(12)
        prompts = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
                   for n in (9, 21, 40, 50, 90)]

        def engine(device, paged, fused, **kw):
            model, params = (gpu, p_gpu) if device == "cuda" else (cpu, p_cpu)
            return TierEngine(model, params, ServingConfig(
                max_batch=4, max_seq=128, paged=paged, kv_page_size=16,
                fused_steps=fused, decode_impl=device if device == "cuda"
                else "torch", **kw), eos_id=-1)

        n_tok = 0
        for paged in (False, True):
            for fused in (1, 8):
                toks = {}
                for device in ("cuda", "cpu"):
                    eng = engine(device, paged, fused)
                    for rid, p in enumerate(prompts):
                        eng.submit(rid, p, max_new=12)
                    toks[device] = {s.rid: s.generated
                                    for s in eng.run_until_drained()}
                if toks["cuda"] != toks["cpu"]:
                    fail(f"reduced {arch} paged={paged} fused={fused}: card "
                         f"{toks['cuda']} != CPU {toks['cpu']}")
                n_tok += sum(len(t) for t in toks["cuda"].values())
        prompt = {"tokens": prompts[2], "extras": {}}
        for paged in (False, True):
            ref = _alone(engine("cuda", paged, 8), prompt, 16)
            eng = engine("cuda", paged, 8, session_cache_mb=64.0)
            gen = _alone(eng, prompt, 6)
            eng.finished.clear()
            hist = np.concatenate([prompts[2], np.asarray(gen, np.int32),
                                   prompts[0]])
            eng.submit(1, hist, max_new=6)
            got = {s.rid: s.generated for s in eng.run_until_drained()}[1]
            cold = _alone(engine("cuda", paged, 8),
                          {"tokens": hist, "extras": {}}, 6)
            # the first turn parks only with a session id
            if got != cold:
                fail(f"reduced {arch} paged={paged}: second turn {got} != "
                     f"cold {cold}")
            eng = engine("cuda", paged, 8, session_cache_mb=64.0)
            eng.submit(0, prompts[2], max_new=6, session="s")
            gen = {s.rid: s.generated for s in eng.run_until_drained()}[0]
            hist = np.concatenate([prompts[2], np.asarray(gen, np.int32),
                                   prompts[0]])
            eng.submit(1, hist, max_new=6, session="s")
            got = {s.rid: s.generated for s in eng.run_until_drained()}[1]
            if got != cold or eng.resumed_sessions != 1:
                fail(f"reduced {arch} paged={paged}: resumed session {got} "
                     f"!= cold {cold} (resumed {eng.resumed_sessions})")
            v = cfg.vocab_size
            for name, draft_for in {
                    "garbage": lambda g: [(t + 1) % v
                                          for t in ref[len(g):len(g) + 4]],
                    "partial": lambda g: [t if i != 2 else (t + 1) % v
                                          for i, t in
                                          enumerate(ref[len(g):len(g) + 5])],
                    "perfect": lambda g: ref[len(g):len(g) + 4]}.items():
                eng = engine("cuda", paged, 8)
                got = _spec_drive_target(eng, prompt, 16, draft_for)
                if got != ref or eng.spec_rounds <= 0:
                    fail(f"reduced {arch} paged={paged} spec {name}: {got} "
                         f"!= fused {ref} ({eng.spec_rounds} rounds)")
        print(f"  reduced f32 {arch}: card (kernels) == CPU (plain) on "
              f"{n_tok} tokens, fused and per-token, paged and dense; a "
              f"resumed session and perfect, garbage and partial "
              f"speculative drafts commit the fused tokens")


def _tree_to(tree, device):
    return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def phase_recurrent(records):
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    recurrentgemma_full_width(records)
    torch.cuda.reset_peak_memory_stats()
    mamba2_full_width(records)
    recurrent_reduced_parity()
    print(f"  phase 10 wall {time.perf_counter() - t0:.1f}s")


def nemotron_full_width(records):
    """Phase 11 (b): nemotron-4-340b at its published widths (d 18432, 96
    query heads on 8 KV heads of 192, squared-ReLU MLP of 73728, vocab
    256000, untied) in bf16 with its depth cut to 2 of 96 layers, random
    weights drawn on the card: a 2048-token prefill under attn_impl "cuda"
    (the flash kernel, flash_bf16_ws_kernel at hd 192) against "auto"
    (plain PyTorch), held by ``_hold_prefill``; then two requests on a
    paged TierEngine under "cuda", which must launch the flash kernel and
    the paged decode kernel at (hd 192, group 12). Each model keeps an f32
    copy of the 256000 x 18432 unembedding (18.9 GB), so the "auto" model's
    is dropped before the "cuda" prefill."""
    import numpy as np
    import torch

    from repro_torch.config import ServingConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("nemotron-4-340b").replace(dtype="bfloat16",
                                                num_layers=2)
    model = build_model(cfg, attn_impl="cuda", device="cuda")
    params = model.init(0)
    auto = build_model(cfg, attn_impl="auto", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    nbytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    print(f"  nemotron-4-340b, 2 of 96 layers at full width: "
          f"{n_params / 1e9:.3f} B parameters ({nbytes / 1e9:.1f} GB in bf16; "
          f"+ {cfg.vocab_size * cfg.d_model * 4 / 1e9:.1f} GB for the f32 "
          f"unembedding) drawn on the card in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(11)
    toks = rng.integers(4, cfg.vocab_size, 2048).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks[None], device="cuda")}
    logits, walls = {}, {}
    for name in ("auto", "cuda"):
        m = auto if name == "auto" else model
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits[name] = m.prefill(params, batch, 2048)[0].float()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t1
        m._f32_table = None  # one f32 unembedding on the card at a time
    del m  # the loop's last model would outlive `del model` below
    diff, top, gate = _hold_prefill("nemotron", logits)
    print(f"  nemotron prefill S=2048: max |logit auto - cuda| {diff:.4g} (of "
          f"max |logit| {top:.4g}; gate {gate:.4g}), argmax agrees | wall of "
          f"one cold call each (f32 unembedding made in it): auto "
          f"{walls['auto'] * 1e3:.1f} ms, cuda {walls['cuda'] * 1e3:.1f} ms")
    del auto
    sv = ServingConfig(max_batch=2, max_seq=1024, paged=True,
                       kv_page_size=64, fused_steps=8)
    eng = TierEngine(model, params, sv)
    prompts = [(rng.integers(4, cfg.vocab_size, n).astype(np.int32), 8)
               for n in (300, 700)]
    done, counts, by_shape, wall = _serve_direct(eng, prompts,
                                                 "nemotron serve")
    key = (cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads)
    for name in ("flash_attention", "decode_attention_paged"):
        if by_shape[name].get(key, 0) <= 0:
            fail(f"nemotron serve never launched {name} at (hd, group) "
                 f"{key}: {by_shape[name]}")
        records[name]["launches"] = (records[name].get("launches", 0)
                                      + counts[name])
    print(f"  nemotron serve (paged): 2 requests in {wall:.3f}s, launches "
          f"{counts} by (hd, group) {by_shape} | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for rid in sorted(done):
        print(f"    rid={rid} prompt={len(prompts[rid][0])} "
              f"tokens={done[rid]}")
    del eng, model, params
    torch.cuda.empty_cache()


#: a prefill group's measured peak above the resident set may pass one
#: layer's K/V plus its activations by this much (phase 11)
PREFILL_PEAK_SLACK = 2e9


def _watch_prefill_memory(eng, tier, peaks):
    """Wrap ``eng._admit_group``: each group's peak device memory above
    what was allocated before it, beside one layer's K/V and the engine's
    activation count for the group (rows padded x positions)."""
    import torch

    from repro_torch.serving.engine import prefill_bytes_per_position

    admit = eng._admit_group
    cfg = eng.cfg

    def measured(jobs, slots, bucket):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        admit(jobs, slots, bucket)
        torch.cuda.synchronize()
        rows = 1 << (len(jobs) - 1).bit_length()
        positions = rows * (cfg.num_patches + bucket)
        layer_kv = 2 * positions * cfg.num_kv_heads * cfg.resolved_head_dim * 2
        peaks.append((tier, len(jobs), rows, bucket,
                      torch.cuda.max_memory_allocated() - base, layer_kv,
                      positions * prefill_bytes_per_position(cfg)))
    eng._admit_group = measured


def _capacity_copy_prefill(eng, batch, slots_arr, total, pt_rows, npg):
    """The prefill the paged one replaced: ``prefill``'s capacity-wide
    cache of every layer, scattered through the page tables."""
    import torch

    from repro_torch.serving.engine import _at, _get, _named_leaves

    logits, cache1 = eng.model.prefill(eng.params, batch, eng.serving.max_seq)
    slots_d = torch.as_tensor(slots_arr, device="cuda").long()
    total_d = torch.as_tensor(total, device="cuda")
    cap = cache1["pos"].shape[1]
    cache1["pos"] = torch.where(cache1["pos"] < total_d[:, None],
                                cache1["pos"], -1)
    cache1["index"] = (torch.clamp(total_d, max=cap) % cap).to(torch.int32)
    page = eng.serving.kv_page_size
    for name, one in _named_leaves(cache1):
        pool = _get(eng.cache, name)
        bax = eng._axis_by_name[name][0]
        if name not in eng._paged_names:
            pool[_at(bax, slots_d)] = one.to(pool.dtype)
            continue
        one = one.reshape(one.shape[:bax + 1] + (eng._n_pt, page)
                          + one.shape[bax + 2:])
        pt_sl = torch.as_tensor(pt_rows[:, :npg], device="cuda").long()
        pool[_at(bax, pt_sl)] = one[_at(bax + 1, slice(0, npg))].to(
            pool.dtype)
    eng.cache["pages"][slots_d] = torch.as_tensor(pt_rows, device="cuda")
    return logits


def _paged_prefill_bitwise(eng):
    """Two rows (one padded) of 2509 image tokens and a 256-token bucket
    into reserved pages, straight (``_prefill_insert`` on the pages) and
    through the capacity-wide copy, from the same pool state: every page
    but the null page, pos, index, page tables and logits bitwise equal.
    Returns (paged ms, capacity-copy ms)."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import _get, _named_leaves

    cfg = eng.cfg
    gen = torch.Generator(device="cuda").manual_seed(11)
    bucket, lengths = 256, np.array([200, 256], np.int32)
    toks = torch.randint(3, cfg.vocab_size, (2, bucket), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks, "lengths": torch.as_tensor(lengths,
                                                        device="cuda"),
             "patches": torch.rand((2, cfg.num_patches, cfg.frontend_dim),
                                   generator=gen, device="cuda")}
    total = lengths + cfg.num_patches
    slots = np.array([0, 1], np.int32)
    for slot, need in zip(slots, (12, 16)):  # past the prompt, the whole row
        eng._assign_pages(int(slot), eng._reserve_pages(need))
    pt_rows = eng._pt[slots]
    keep = {n: t.clone() for n, t in _named_leaves(eng.cache)}
    out, ms = {}, {}
    for how in ("paged", "copy", "paged", "copy"):
        for n, t in _named_leaves(eng.cache):
            t.copy_(keep[n])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            if how == "paged":
                logits = eng._prefill_insert(batch, slots, total, pt_rows, 16)
            else:
                logits = _capacity_copy_prefill(eng, batch, slots, total,
                                                pt_rows, 16)
        end.record()
        torch.cuda.synchronize()
        ms.setdefault(how, []).append(start.elapsed_time(end))
        out[how] = (logits, {n: t.clone() for n, t in
                             _named_leaves(eng.cache)})
    if not torch.equal(out["paged"][0], out["copy"][0]):
        fail("phi-3-vision paged prefill: logits differ from the "
             "capacity-wide copy's")
    for n, t in out["paged"][1].items():
        other = out["copy"][1][n]
        if n in eng._paged_names:
            t, other = t[:, 1:], other[:, 1:]  # the null page is garbage
        if not torch.equal(t, other):
            fail(f"phi-3-vision paged prefill: {n} differs from the "
                 f"capacity-wide copy's")
    for slot in slots:
        eng._release_pages(int(slot))
    del keep, out
    return min(ms["paged"]), min(ms["copy"])


def phase_zoo_serve(records):
    """Phase 11: (a) phi-3-vision-4.2b (vlm; hd 96, 32 heads, MHA) at full
    width and depth (32 layers, d 3072) and its processor's 2509 image
    tokens (4096-wide projector inputs), bf16, random weights, through
    ClusterServer on two engines over the same model (paged, 256-row pages,
    attn_impl "cuda", max_seq 4096): four requests of the launcher's mix,
    16 new tokens. Fails unless both attention kernels launched at hd 96
    (and the serve's own checks: every token in the vocabulary, image
    scores), or if a prefill group's peak memory above the resident set
    passes one layer's K/V plus the group's activations by more than
    ``PREFILL_PEAK_SLACK``; then ``_paged_prefill_bitwise`` on the cloud
    engine; (b) ``nemotron_full_width``."""
    import torch

    from repro_torch.config import ServingConfig, get_topology
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("phi-3-vision-4.2b").replace(
        dtype="bfloat16", num_patches=2509, frontend_dim=4096)
    model = build_model(cfg, attn_impl="cuda", device="cuda")
    params = model.init(0)
    sv = ServingConfig(max_batch=4, max_seq=4096, paged=True,
                       kv_page_size=256, fused_steps=8)
    engines = {tier: TierEngine(model, params, sv)
               for tier in ("edge", "cloud")}
    peaks = []
    for tier, eng in engines.items():
        _watch_prefill_memory(eng, tier, peaks)
    counts = serve(engines, get_topology("edge-cloud"), 4, 16,
                   "phi-3-vision full width, 2509 image tokens, paged, "
                   "attn cuda")
    for eng in engines.values():
        del eng._admit_group  # the wrapper holds its engine: a cycle
    if not peaks:
        fail("phi-3-vision serve ran no prefill group")
    for tier, r, rp, bucket, peak, layer_kv, act in peaks:
        print(f"  phi-3-vision prefill group ({tier}, {r} rows of {rp}, "
              f"bucket {bucket}): peak above resident {peak / 1e9:.3f} GB, "
              f"one layer's K/V {layer_kv / 1e9:.3f} GB, activations "
              f"counted {act / 1e9:.3f} GB (measured / counted "
              f"{peak / (layer_kv + act):.3f})")
        if peak > layer_kv + act + PREFILL_PEAK_SLACK:
            fail(f"phi-3-vision prefill group holds {peak / 1e9:.3f} GB "
                 f"above the resident set: more than one layer's K/V and "
                 f"the activations ({(layer_kv + act) / 1e9:.3f} GB) + "
                 f"{PREFILL_PEAK_SLACK / 1e9:.0f} GB")
    paged_ms, copy_ms = _paged_prefill_bitwise(engines["cloud"])
    print(f"  phi-3-vision paged prefill (2 rows, S={2509 + 256}) "
          f"bitwise equal to the capacity-wide copy; {paged_ms:.2f} ms "
          f"against {copy_ms:.2f} ms (CUDA events, the faster of two)")
    by_shape = ops.launches_by_shape()
    key = (cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads)
    for name in ("flash_attention", "decode_attention_paged"):
        if by_shape[name].get(key, 0) <= 0:
            fail(f"phi-3-vision serve never launched {name} at (hd, group) "
                 f"{key}: {by_shape[name]}")
        records[name]["launches"] = (records[name].get("launches", 0)
                                      + counts[name])
    records["image_stats"]["launches"] = (
        records["image_stats"].get("launches", 0) + counts["image_stats"])
    print(f"  phi-3-vision: launches by (hd, group) {by_shape}")
    del engines, model, params
    torch.cuda.empty_cache()
    nemotron_full_width(records)
    print(f"  phase 11 wall {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 12: the MoE and encoder-decoder families
# ---------------------------------------------------------------------------


class _KernelShapes:
    """Record the shape of every attention kernel launch made eagerly while
    in use: the flash kernel's (hd, group, causal, S) and the dense decode
    kernel's (hd, group, T, query at 10**9). It wraps the kernel entry
    points the ``ops`` wrappers call, so the wrappers' launch counts stay
    theirs. A CUDA graph capture is not recorded (it reads no device value
    and launches nothing), nor are its replays, which call no wrapper."""

    def __init__(self):
        self.flash, self.decode = {}, {}

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops

        self._saved = (ops.flash_attention_cuda, ops.decode_attention_cuda)
        flash, decode = self._saved

        def flash_seen(q, k, v, *, causal=True, window=None, **kw):
            out = flash(q, k, v, causal=causal, window=window, **kw)
            if torch.cuda.is_current_stream_capturing():
                return out
            key = (q.shape[-1], q.shape[-2] // k.shape[-2], causal,
                   q.shape[1])
            self.flash[key] = self.flash.get(key, 0) + 1
            return out

        def decode_seen(q, k, v, pos_q, pos_cache, **kw):
            out = decode(q, k, v, pos_q, pos_cache, **kw)
            if torch.cuda.is_current_stream_capturing():
                return out
            key = (q.shape[-1], q.shape[-2] // k.shape[-2], k.shape[1],
                   bool((pos_q >= 10 ** 9).all()))
            self.decode[key] = self.decode.get(key, 0) + 1
            return out

        ops.flash_attention_cuda, ops.decode_attention_cuda = (flash_seen,
                                                               decode_seen)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.flash_attention_cuda, ops.decode_attention_cuda = self._saved


def _event_ms(fn, reps: int = 3) -> float:
    """Median device-clock time of ``fn()`` between CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _decode_split(model, params, eng):
    """One decode step of ``eng``'s live slots, split by CUDA events into
    the MoE blocks, the attention kernel calls and the rest (projections,
    norms, the cache write, the unembedding). Returns ms
    (total, moe, attention)."""
    import torch

    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod

    toks = torch.tensor([[s.generated[-1] if s else 0] for s in eng.slots],
                        dtype=torch.int32, device="cuda")
    pos = torch.as_tensor(eng.positions.astype("int32"), device="cuda")
    spans = {"moe": [], "attention": []}
    saved = (moe_mod.moe_forward, attn_mod.decode_attention_paged)

    def timed(name, fn):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    def step():
        # the same token at the same position each time: rewrites one row
        eng.cache["index"] = torch.as_tensor(
            (eng.positions % eng.serving.max_seq).astype("int32"),
            device="cuda")
        model.decode_step(params, eng.cache, {"tokens": toks,
                                              "positions": pos})

    step()  # warm-up
    moe_mod.moe_forward = timed("moe", saved[0])
    attn_mod.decode_attention_paged = timed("attention", saved[1])
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
    finally:
        moe_mod.moe_forward, attn_mod.decode_attention_paged = saved
    total = start.elapsed_time(end)
    part = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
    return total, part["moe"], part["attention"]


def qwen3_moe_full_width(records):
    """Phase 12 (a): qwen3-moe-235b-a22b at full width (d 4096, 64 query
    heads on 4 KV heads of 128, 128 experts top-8 of moe_d_ff 1536, vocab
    151936, qk_norm), depth cut to 8 of its 94 layers, bf16, random
    weights from a seed, moe_impl "auto" (dense: every expert computes
    every token). A 320-token prompt's prefill logits under attn_impl
    "cuda" against "auto"; the same prefill under moe_impl "dropping"
    beside "dense" (CUDA events); four requests (64-300-token prompts, 16
    new tokens) on a paged TierEngine (64-row pages) under "cuda", failing
    unless the flash kernel and the paged decode kernel launched at (hd 128,
    group 16), each request had its own prefill group, every token is in
    the vocabulary and the drained pool holds no page; then one decode
    step's split between attention and the MoE blocks."""
    import numpy as np
    import torch

    from repro_torch.config import ServingConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.counting import count_params
    from repro_torch.serving.engine import TierEngine

    full = get_config("qwen3-moe-235b-a22b")
    depth = 8
    cfg = full.replace(dtype="bfloat16", num_layers=depth)
    t0 = time.perf_counter()
    model = build_model(cfg, attn_impl="cuda", device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"  qwen3-moe-235b-a22b cut to {depth} of its {full.num_layers} "
          f"layers at full width: {n_params / 1e9:.3f} B parameters "
          f"({n_params * 2 / 1e9:.1f} GB bf16; all {full.num_layers} layers: "
          f"{count_params(full) / 1e9:.1f} B), drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    auto = build_model(cfg, attn_impl="auto", device="cuda")
    dropping = build_model(cfg, attn_impl="cuda", moe_impl="dropping",
                           device="cuda")
    rng = np.random.default_rng(12)
    prompt = rng.integers(4, cfg.vocab_size, 320).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompt[None], device="cuda")}
    out = {}
    for name, m in (("auto", auto), ("cuda", model), ("dropping", dropping)):
        m.prefill(params, batch, 512)  # warm-up
        out[name] = m.prefill(params, batch, 512)[0].float()
    if not all(bool(torch.isfinite(x).all()) for x in out.values()):
        fail("qwen3-moe prefill logits are not finite")
    diff = float((out["auto"] - out["cuda"]).abs().max())
    agree = bool(out["auto"].argmax(-1) == out["cuda"].argmax(-1))
    ms = {"dense": [], "dropping": []}
    for name in ("dense", "dropping", "dropping", "dense"):  # in turns
        m = model if name == "dense" else dropping
        ms[name].append(_event_ms(lambda: m.prefill(params, batch, 512)))
    ddiff = float((out["dropping"] - out["cuda"]).abs().max())
    print(f"  qwen3-moe prefill S=320: max |logit auto - cuda| {diff:.4g} "
          f"(of max |logit| {float(out['auto'].abs().max()):.4g}), argmax "
          f"{'agrees' if agree else 'DIFFERS'} | moe_impl, CUDA events, "
          f"in turns (median of 3 each): dense "
          f"{', '.join(f'{x:.2f}' for x in ms['dense'])} ms, dropping "
          f"{', '.join(f'{x:.2f}' for x in ms['dropping'])} ms; max |logit "
          f"dropping - dense| {ddiff:.4g} (capacity "
          f"{max(1, int(320 * cfg.top_k / cfg.num_experts * cfg.capacity_factor))}"
          f" rows an expert: tokens drop)")
    del auto, dropping
    sv = ServingConfig(max_batch=4, max_seq=512, paged=True, kv_page_size=64,
                       fused_steps=8)
    eng = TierEngine(model, params, sv)
    groups = []
    admit = eng._admit_group
    eng._admit_group = lambda jobs, slots, bucket: (
        groups.append(len(jobs)), admit(jobs, slots, bucket))
    prompts = [(rng.integers(4, cfg.vocab_size, n).astype(np.int32), 16)
               for n in (64, 130, 217, 300)]
    torch.cuda.reset_peak_memory_stats()
    done, counts, by_shape, wall = _serve_direct(eng, prompts,
                                                 "qwen3-moe serve")
    key = (cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads)
    for name in ("flash_attention", "decode_attention_paged"):
        if by_shape[name].get(key, 0) <= 0:
            fail(f"qwen3-moe serve never launched {name} at (hd, group) "
                 f"{key}: {by_shape[name]}")
        records[name]["launches"] = (records[name].get("launches", 0)
                                     + counts[name])
    if groups != [1] * len(prompts):
        fail(f"qwen3-moe serve: prefill groups {groups}, not one a request")
    gauges = eng.pool.gauges()
    if gauges["pages_free"] != sv.pool_pages:
        fail(f"qwen3-moe serve: the drained pool holds pages: {gauges}")
    print(f"  qwen3-moe serve (paged, 64-row pages, attn cuda, moe dense): 4 "
          f"requests in {wall:.3f}s, {eng.decode_tokens} decode / "
          f"{eng.prefill_tokens} prompt tokens, prefill groups {groups}, "
          f"launches {counts} by (hd, group) {by_shape} | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for rid in sorted(done):
        print(f"    rid={rid} prompt={len(prompts[rid][0])} "
              f"tokens={done[rid][:6]}...")
    del eng._admit_group  # the counting hook holds the engine: no cycle
    eng = TierEngine(model, params, sv)
    for rid, (toks, _) in enumerate(prompts):
        eng.submit(rid, toks, max_new=64)
    eng._admit()
    total, moe_ms, attn_ms = _decode_split(model, params, eng)
    print(f"  qwen3-moe decode step B=4 ({depth} layers, CUDA events): "
          f"{total:.2f} ms, of it the MoE blocks {moe_ms:.2f} ms "
          f"({moe_ms / total:.0%}; dense: all {cfg.num_experts} experts read "
          f"{3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff * 2 / 1e9:.2f} "
          f"GB a layer) and the paged attention kernel {attn_ms:.2f} ms "
          f"({attn_ms / total:.0%}), the rest {total - moe_ms - attn_ms:.2f} ms")
    del eng, model, params
    torch.cuda.empty_cache()


def whisper_full_width(records):
    """Phase 12 (b): whisper-small at full width and depth (12 encoder and
    12 decoder layers, d 768, 12 heads of 64, 1500 frames of 80 mel bins,
    vocab 51865), bf16, random weights. The encoder output and the prefill
    logits under attn_impl "cuda" against "auto"; then four requests on a
    dense TierEngine and four on a paged one under "cuda" (random (1500,
    80) frames in ``extras``, 4-16-token prompts, 32 new tokens, a 448-row
    self cache). Fails unless the flash kernel launched at (hd 64, group 1)
    non-causal with S=1500 and the dense decode kernel at T=1500 (the
    cross read, query at 10**9) and at the self cache's T."""
    import numpy as np
    import torch

    from repro_torch.config import ServingConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    cfg = get_config("whisper-small").replace(dtype="bfloat16")
    model = build_model(cfg, attn_impl="cuda", device="cuda")
    params = model.init(0)
    auto = build_model(cfg, attn_impl="auto", device="cuda")
    n_params = sum(p.numel() for p in _leaves(params))
    rng = np.random.default_rng(13)

    def frames():
        return rng.standard_normal((cfg.encoder_seq, cfg.frontend_dim)
                                   ).astype(np.float32)

    batch = {"tokens": torch.as_tensor(rng.integers(
                 4, cfg.vocab_size, (2, 12)), dtype=torch.int32,
                 device="cuda"),
             "frames": torch.as_tensor(np.stack([frames(), frames()]),
                                       device="cuda")}
    enc = {n: m.encode(params, batch["frames"]).float()
           for n, m in (("auto", auto), ("cuda", model))}
    logits = {n: m.prefill(params, batch, 448)[0].float()
              for n, m in (("auto", auto), ("cuda", model))}
    for x in list(enc.values()) + list(logits.values()):
        if not bool(torch.isfinite(x).all()):
            fail("whisper encoder output or prefill logits are not finite")
    ediff = float((enc["auto"] - enc["cuda"]).abs().max())
    ldiff = float((logits["auto"] - logits["cuda"]).abs().max())
    agree = int((logits["auto"].argmax(-1) == logits["cuda"].argmax(-1))
                .sum())
    print(f"  whisper-small ({n_params / 1e9:.3f} B parameters, bf16): "
          f"encoder S={cfg.encoder_seq} max |auto - cuda| {ediff:.4g} (of max "
          f"{float(enc['auto'].abs().max()):.4g}); prefill max |logit auto - "
          f"cuda| {ldiff:.4g} (of max "
          f"{float(logits['auto'].abs().max()):.4g}), argmax agrees on "
          f"{agree}/2 rows")
    del auto
    prompts = [(rng.integers(4, cfg.vocab_size, n).astype(np.int32), 32,
                {"frames": frames()}) for n in (4, 7, 12, 16)]
    hd, group = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
    want_flash = (hd, group, False, cfg.encoder_seq)
    for paged in (False, True):
        sv = ServingConfig(max_batch=4, max_seq=448, paged=paged,
                           fused_steps=8,
                           **({"kv_page_size": 64} if paged else {}))
        eng = TierEngine(model, params, sv)
        label = f"whisper serve ({'paged' if paged else 'dense'})"
        with _KernelShapes() as seen:
            done, counts, by_shape, wall = _serve_direct(eng, prompts, label)
        want_decode = [(hd, group, cfg.encoder_seq, True),
                       (hd, group, sv.max_seq, False)]
        if seen.flash.get(want_flash, 0) <= 0:
            fail(f"{label}: no flash launch at (hd, group, causal, S) "
                 f"{want_flash}: {seen.flash}")
        for key in want_decode:
            if seen.decode.get(key, 0) <= 0:
                fail(f"{label}: no dense decode launch at (hd, group, T, "
                     f"query at 10**9) {key}: {seen.decode}")
        for name in ("flash_attention", "decode_attention"):
            records[name]["launches"] = (records[name].get("launches", 0)
                                         + counts[name])
        if paged and eng.pool.gauges()["pages_free"] != sv.pool_pages:
            fail(f"{label}: the drained pool holds pages")
        print(f"  {label}: 4 requests in {wall:.3f}s, {eng.decode_tokens} "
              f"decode / {eng.prefill_tokens} prompt tokens | flash by (hd, "
              f"group, causal, S) {seen.flash} | dense decode by (hd, group,"
              f" T, query at 10**9) {seen.decode} | launches {counts}")
        for rid in sorted(done):
            print(f"    rid={rid} prompt={len(prompts[rid][0])} "
                  f"tokens={done[rid][:6]}...")
    del eng, model, params
    torch.cuda.empty_cache()


def moe_encdec_reduced_parity():
    """Phase 12 (c): reduced f32 qwen3-moe, kimi-k2 (one dense layer, one
    shared expert) and whisper-small engines on the card with the kernels
    ("cuda") decode the tokens of the same weights on the CPU with the
    plain versions ("torch"), fused and per token, paged and dense, at
    temperature 0. For the MoE pair, a resumed session and a slot migrated
    paged <-> dense on the card equal cold serving."""
    import numpy as np

    from repro_torch.config import ServingConfig
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import SlotPayload, TierEngine

    for arch in ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "whisper-small"):
        cfg = reduced_config(arch).replace(dtype="float32")
        cpu = build_model(cfg, attn_impl="torch", device="cpu")
        gpu = build_model(cfg, attn_impl="cuda", device="cuda")
        p_cpu = cpu.init(0)
        p_gpu = _tree_to(p_cpu, "cuda")
        rng = np.random.default_rng(14)
        extras = []
        for n in (9, 21, 40, 50, 90):
            extras.append({"frames": rng.standard_normal(
                (cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)}
                if cfg.family == "encdec" else {})
        prompts = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
                   for n in (9, 21, 40, 50, 90)]

        def engine(device, paged, fused, **kw):
            model, params = (gpu, p_gpu) if device == "cuda" else (cpu, p_cpu)
            return TierEngine(model, params, ServingConfig(
                max_batch=4, max_seq=128, paged=paged, kv_page_size=16,
                fused_steps=fused, decode_impl=device if device == "cuda"
                else "torch", **kw), eos_id=-1)

        def run(eng, jobs, max_new=12):
            for rid, (p, ex) in jobs:
                eng.submit(rid, p, max_new=max_new, extras=dict(ex))
            return {s.rid: s.generated for s in eng.run_until_drained()}

        jobs = list(enumerate(zip(prompts, extras)))
        n_tok = 0
        for paged in (False, True):
            for fused in (1, 8):
                toks = {d: run(engine(d, paged, fused), jobs)
                        for d in ("cuda", "cpu")}
                if toks["cuda"] != toks["cpu"]:
                    fail(f"reduced {arch} paged={paged} fused={fused}: card "
                         f"{toks['cuda']} != CPU {toks['cpu']}")
                n_tok += sum(len(t) for t in toks["cuda"].values())
        msg = ""
        if cfg.family == "moe":
            for paged in (False, True):
                eng = engine("cuda", paged, 8, session_cache_mb=64.0)
                eng.submit(0, prompts[2], max_new=6, session="s")
                gen = {s.rid: s.generated for s in eng.run_until_drained()}[0]
                hist = np.concatenate([prompts[2], np.asarray(gen, np.int32),
                                       prompts[0]])
                cold = run(engine("cuda", paged, 8), [(1, (hist, {}))], 6)[1]
                eng.submit(1, hist, max_new=6, session="s")
                got = {s.rid: s.generated
                       for s in eng.run_until_drained()}[1]
                if got != cold or eng.resumed_sessions != 1:
                    fail(f"reduced {arch} paged={paged}: resumed session "
                         f"{got} != cold {cold} (resumed "
                         f"{eng.resumed_sessions})")
                ref = run(engine("cuda", paged, 8), jobs[:2], 20)
                donor = engine("cuda", paged, 8)
                for rid, (p, _) in jobs[:2]:
                    donor.submit(rid, p, max_new=20)
                donor.step()
                payload = SlotPayload.from_bytes(
                    donor.extract_slot(1).to_bytes())
                target = engine("cuda", not paged, 8)
                target.inject_slot(payload)
                got = {s.rid: s.generated
                       for s in target.run_until_drained()}[1]
                if got != ref[1] or target.prefill_tokens:
                    fail(f"reduced {arch}: slot migrated paged={paged} -> "
                         f"{not paged}: {got} != unmigrated {ref[1]}")
            msg = ("; a resumed session and a slot migrated paged <-> dense "
                   "equal cold serving")
        print(f"  reduced f32 {arch}: card (kernels) == CPU (plain) on "
              f"{n_tok} tokens, fused and per-token, paged and dense{msg}")


#: device memory phase 12 may find still held from the phases before it
HELD_LIMIT_BYTES = 2 ** 30


def phase_moe_encdec(records):
    import torch

    t0 = time.perf_counter()
    # a dropped engine and a dropped ClusterServer free their weights and
    # caches at once (no reference cycle holds them), so what the phases
    # before left is read before any collection
    held = torch.cuda.memory_allocated()
    print(f"  held from earlier phases (no collection): "
          f"{held / 2**30:.2f} GiB")
    if held > HELD_LIMIT_BYTES:
        fail(f"phase 12: {held / 2**30:.2f} GiB still held from earlier "
             f"phases (limit {HELD_LIMIT_BYTES / 2**30:.0f} GiB)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qwen3_moe_full_width(records)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whisper_full_width(records)
    moe_encdec_reduced_parity()
    print(f"  phase 12 wall {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

#: the launcher's defaults (``repro_torch.launch.train``)
TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_TOTAL = 8, 256, 3e-4, 200
REMAT_LOSS_RTOL = 1e-5  # one batch, one set of weights, three policies
CARD_CPU_RTOL = 1e-4  # 12-step loss history, card (cuBLAS f32) vs CPU
#: resumed against uninterrupted on one card: losses, and each parameter
#: leaf's max |diff| over its max |entry| (f32 sums need not repeat
#: bitwise between runs: the CPU's differ by ~1e-8 between two runs in one
#: process)
RESUME_RTOL = 1e-6


def _train_flops(cfg, n_params: int, b: int, s: int) -> float:
    """Model FLOPs of one train step: 6 x N x tokens, plus the attention
    products (forward and backward) over all S x S pairs, as the plain
    dense attention computes them: 12 x L x H x hd x S per token."""
    return b * s * (6.0 * n_params + 12.0 * cfg.num_layers * cfg.num_heads
                    * cfg.resolved_head_dim * s)


def train_full_width():
    """Phase 13 (a): qwen2-vl-2b at its published widths and depth (28
    layers, d 1536, 12/2 heads of 128, vocab 151936; 1.546 B parameters), in
    float32 as the trainer builds it, random weights from seed 0 drawn on
    the card, f32 AdamW state, through ``make_train_step`` on the
    launcher's B=8, S=256 batches from ``make_token_batch``: 3 steps under
    remat "dots" (the default), one under "full", one under "none", 2 at
    accum=2, then one on a vlm batch with 256 vision-stub patches (S = 256 +
    256). Before them, one vlm batch's loss and gradients under each
    policy on the same weights: the losses agree to 1e-5 relative and every
    gradient leaf is finite and nonzero. Fails unless every loss and grad
    norm is finite, every parameter leaf moved in the first step, the peak
    memory falls none > dots > full, no hand kernel launched, and a model
    built with attn_impl "cuda" refuses ``loss``."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.config import OptimizerConfig
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.synthetic import make_token_batch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.training import (adamw_update, init_opt_state,
                                      make_train_step)
    from repro_torch.training.optimizer import global_norm, tree_leaves
    from repro_torch.training.train_loop import loss_and_grads

    before = ops.launches()
    cfg = get_config("qwen2-vl-2b")
    model = build_model(cfg.replace(dtype="float32"), param_dtype="float32",
                        device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    opt_cfg = OptimizerConfig(lr=TRAIN_LR, total_steps=TRAIN_TOTAL)
    opt = init_opt_state(params, opt_cfg)
    print(f"  qwen2-vl-2b f32: {n / 1e9:.3f} B parameters in {len(leaves)} "
          f"leaves drawn in {time.perf_counter() - t0:.2f}s; params + AdamW "
          f"m, v: {torch.cuda.memory_allocated() / 2**30:.2f} GiB; TF32 "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}")

    def batch(step, patches=False):
        rng = np.random.default_rng(step)
        out = {k: torch.as_tensor(v, device="cuda") for k, v in
               make_token_batch(rng, TRAIN_B, TRAIN_S,
                                cfg.vocab_size).items()}
        if patches:
            out["patches"] = torch.as_tensor(rng.standard_normal(
                (TRAIN_B, cfg.num_patches, cfg.frontend_dim)).astype(
                    np.float32), device="cuda")
        return out

    def set_policy(policy):
        model.sharding = dataclasses.replace(model.sharding,
                                             remat_policy=policy)

    # one vlm batch (every leaf, proj_in too, takes a gradient), one set of
    # weights, the three policies
    losses = {}
    b0 = batch(0, patches=True)
    for policy in ("dots", "full", "none"):
        set_policy(policy)
        loss, _, grads = loss_and_grads(model, params, b0)
        gl = tree_leaves(grads)
        norms = torch.stack([g.float().norm() for g in gl])
        if not bool(torch.isfinite(norms).all()) or not bool(
                (norms > 0).all()):
            bad = [i for i, x in enumerate(norms.tolist())
                   if not np.isfinite(x) or x == 0]
            fail(f"phase 13: remat {policy}: gradient leaves {bad} are zero "
                 f"or not finite")
        losses[policy] = (float(loss), float(global_norm(grads)))
        del grads, gl
    print("  one vlm batch, three remat policies: " + ", ".join(
        f"{p} loss {l:.7f} grad_norm {g:.6f}" for p, (l, g) in
        losses.items()))
    ref = losses["dots"][0]
    for policy, (l, _) in losses.items():
        if not np.isfinite(l) or abs(l - ref) > REMAT_LOSS_RTOL * abs(ref):
            fail(f"phase 13: remat {policy} loss {l} against dots {ref}")

    plan = ([("dots", 1, False)] * 3 + [("full", 1, False), ("none", 1, False)]
            + [("dots", 2, False)] * 2 + [("dots", 1, True)])
    steps = {1: make_train_step(model, opt_cfg, 1),
             2: make_train_step(model, opt_cfg, 2)}
    peak = {}
    walls = []
    for i, (policy, accum, vlm) in enumerate(plan):
        set_policy(policy)
        bt = batch(i + 1, patches=vlm)
        s_tot = TRAIN_S + (cfg.num_patches if vlm else 0)
        snap = [p.clone() for p in leaves] if i == 0 else None
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = steps[accum](params, opt, bt)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        mem = torch.cuda.max_memory_allocated() / 2**30
        loss, gnorm, lr = (float(m["loss"]), float(m["grad_norm"]),
                           float(m["lr"]))
        flops = _train_flops(cfg, n, TRAIN_B, s_tot)
        share = flops / (ms / 1e3) / PEAK_FLOPS["float32"]
        tag = f", {cfg.num_patches} patches" if vlm else ""
        print(f"  step {i + 1} [{policy}, accum {accum}, S={s_tot}{tag}]: "
              f"{ms:.1f} ms, "
              f"{TRAIN_B * s_tot / (ms / 1e3):.0f} tokens/s, peak "
              f"{mem:.2f} GiB, loss {loss:.6f}, grad_norm {gnorm:.6f}, lr "
              f"{lr:.4e}, model FLOPs {flops:.4e} = {share:.1%} of the f32 "
              f"peak")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"phase 13: step {i + 1} loss {loss} grad_norm {gnorm}")
        if snap is not None:
            still = [j for j, (a, b) in enumerate(zip(snap, leaves))
                     if torch.equal(a, b)]
            del snap
            if still:
                fail(f"phase 13: parameter leaves {still} did not move in "
                     f"step 1")
        if accum == 1 and not vlm:
            walls.append((policy, ms))
            if i > 0:  # step 1 also holds the snapshot of the weights
                peak[policy] = mem
    print("  peak memory by remat policy (B=8, S=256): " + ", ".join(
        f"{p} {g:.2f} GiB" for p, g in peak.items()) + "; dots steps "
        f"{', '.join(f'{ms:.1f}' for p, ms in walls if p == 'dots')} ms")
    if not peak["none"] > peak["dots"] > peak["full"]:
        fail(f"phase 13: peak memory by policy {peak}: remat saved nothing")

    # where a "dots" step's time goes: the forward alone, forward and
    # backward, the update (CUDA events, median of 3; the updates move the
    # weights, which nothing reads after this)
    set_policy("dots")
    bt = batch(len(plan) + 1)

    def forward():
        with torch.no_grad():
            model.loss(params, bt)

    t_fwd = _event_ms(forward)
    t_grad = _event_ms(lambda: loss_and_grads(model, params, bt))
    grads = loss_and_grads(model, params, bt)[2]
    t_opt = _event_ms(lambda: adamw_update(params, grads, opt, opt_cfg))
    del grads
    print(f"  a dots step split (B=8, S=256): forward {t_fwd:.1f} ms, "
          f"forward + backward {t_grad:.1f} ms, AdamW update {t_opt:.1f} ms "
          f"(CUDA events, median of 3)")
    if ops.launches() != before:
        fail(f"phase 13: training launched hand kernels: {before} -> "
             f"{ops.launches()}")
    del params, opt, leaves, steps, model
    gc.collect()
    torch.cuda.empty_cache()

    small = build_model(reduced_config("qwen2-vl-2b").replace(
        dtype="float32"), attn_impl="cuda", device="cuda")
    toks = torch.full((1, 16), 5, dtype=torch.int32, device="cuda")
    try:
        small.loss(small.init(0), {"tokens": toks, "labels": toks})
    except NotImplementedError as e:
        print(f"  attn_impl 'cuda' refuses loss: {e}")
    else:
        fail("phase 13: a loss under attn_impl 'cuda' did not raise")


def _ckpt_leaves(directory, step):
    """{name: array} of a checkpoint directory, read as numpy."""
    import numpy as np

    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        names = json.load(f)["leaves"]
    return {k: np.load(os.path.join(d, k + ".npy")) for k in names}


def _max_rel(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def train_trainer_resume():
    """Phase 13 (b): ``repro_torch.launch.train --arch qwen2-vl-2b
    --reduced --steps 12 --ckpt-every 6`` on the card into a temporary
    directory; its step-12 checkpoint moved aside, the same command
    resumes from step 6 and must write a step-12 checkpoint equal to the
    uninterrupted one's parameters (and print the same step-10 loss). In
    process, the
    same trainer (log every step) on the card from weights drawn on the CPU
    against the CPU's run from those weights: the 12-step loss histories
    within 1e-4 relative; a trainer resumed from the card run's step-6
    checkpoint repeats its last 6 losses (1e-6); the card's step-12
    checkpoint restores on the CPU with leaves equal to the card's."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpointer import tree_flatten_with_path
    from repro_torch.config import (OptimizerConfig, ShardingConfig,
                                    TrainConfig)
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.training import Trainer, init_opt_state
    from repro_torch.training.optimizer import tree_map

    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="phase13_") as tmp:
        d1 = os.path.join(tmp, "launcher")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "qwen2-vl-2b", "--reduced", "--steps", "12", "--ckpt-every",
               "6", "--ckpt-dir", d1]
        runs = []
        for label in ("uninterrupted", "resumed"):
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=600)
            print(f"  $ repro_torch.launch.train --arch qwen2-vl-2b --reduced"
                  f" --steps 12 --ckpt-every 6 ({label}, "
                  f"{time.perf_counter() - t0:.1f}s)")
            for line in proc.stdout.splitlines():
                print(f"  | {line}")
            if proc.returncode != 0:
                fail(f"phase 13: launcher ({label}) exit {proc.returncode}:\n"
                     f"{proc.stderr[-3000:]}")
            runs.append(proc.stdout)
            if label == "uninterrupted":
                ref12 = _ckpt_leaves(d1, 12)
                shutil.rmtree(os.path.join(d1, "step_00000012"))
        step10 = [[ln for ln in out.splitlines() if "step=10 " in ln]
                  for out in runs]
        if "[trainer] resumed from step 6" not in runs[1]:
            fail("phase 13: the second launcher run did not resume from 6")
        if not step10[0] or [ln.split(" (")[0] for ln in step10[0]] != [
                ln.split(" (")[0] for ln in step10[1]]:
            fail(f"phase 13: step-10 loss lines differ: {step10}")
        res12 = _ckpt_leaves(d1, 12)
        if set(res12) != set(ref12):
            fail("phase 13: the resumed launcher's step 12 has other leaves")
        worst = {}
        for k, v in ref12.items():
            part = "params" if k.startswith("params.") else "opt"
            err = float(np.max(np.abs(res12[k].astype(np.float64)
                                      - v.astype(np.float64)))
                        / max(float(np.max(np.abs(v))), 1e-30))
            worst[part] = max(worst.get(part, 0.0), err)
        print(f"  launcher resumed at 6 -> step-12 checkpoint vs "
              f"uninterrupted: {len(ref12)} leaves, max |diff| / max|leaf| "
              f"params {worst['params']:.3e}, optimizer state "
              f"{worst['opt']:.3e}")
        if worst["params"] > RESUME_RTOL:
            fail(f"phase 13: resumed launcher's step-12 params differ "
                 f"({worst['params']})")

        mcfg = reduced_config("qwen2-vl-2b").replace(dtype="float32")
        p0 = build_model(mcfg, device="cpu").init(0)

        def trainer(device, directory, params=None):
            tc = TrainConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, steps=12,
                             log_every=1, checkpoint_every=6,
                             checkpoint_dir=directory,
                             optimizer=OptimizerConfig(lr=TRAIN_LR,
                                                       total_steps=12),
                             sharding=ShardingConfig())
            t = Trainer(tc, model=build_model(mcfg, param_dtype="float32",
                                              device=device))
            if params is not None:
                t.params = tree_map(
                    lambda x: x.to(t.model.device, copy=True), params)
                t.opt_state = init_opt_state(t.params, tc.optimizer)
            return t

        def train(t, steps=None):  # the history, the per-step log kept quiet
            with contextlib.redirect_stdout(io.StringIO()):
                return [loss for _, loss in t.train(steps)]

        hist = {}
        card = None
        for device in ("cuda", "cpu"):
            t = trainer(device, os.path.join(tmp, device), p0)
            t0 = time.perf_counter()
            hist[device] = train(t)
            print(f"  reduced trainer on {device}: 12 steps in "
                  f"{time.perf_counter() - t0:.2f}s, losses "
                  f"{' '.join(f'{x:.6f}' for x in hist[device])}")
            if device == "cuda":
                card = t
        rel = _max_rel(hist["cuda"], hist["cpu"])
        print(f"  card vs CPU loss history: max rel diff {rel:.3e} "
              f"(tolerance {CARD_CPU_RTOL:g})")
        if not np.all(np.isfinite(hist["cuda"])) or rel > CARD_CPU_RTOL:
            fail(f"phase 13: card {hist['cuda']} vs CPU {hist['cpu']}")

        d3 = os.path.join(tmp, "resume")
        shutil.copytree(os.path.join(tmp, "cuda", "step_00000006"),
                        os.path.join(d3, "step_00000006"))
        t = trainer("cuda", d3)
        with contextlib.redirect_stdout(io.StringIO()):
            t.initialize()
        if t.step != 6:
            fail(f"phase 13: the in-process trainer resumed at {t.step}")
        resumed = train(t, 6)
        rel = _max_rel(resumed, hist["cuda"][6:])
        print(f"  resumed from step 6 on the card: losses 7-12 vs "
              f"uninterrupted max rel diff {rel:.3e} (tolerance "
              f"{RESUME_RTOL:g})")
        if rel > RESUME_RTOL:
            fail(f"phase 13: resumed {resumed} vs {hist['cuda'][6:]}")

        like = {"params": _tree_to(card.params, "cpu"),
                "opt": card.opt_state._replace(
                    step=card.opt_state.step.cpu(),
                    m=_tree_to(card.opt_state.m, "cpu"),
                    v=_tree_to(card.opt_state.v, "cpu"))}
        step, back = card.ckpt.restore(like)
        got, want = ([x for _, x in tree_flatten_with_path(tree)]
                     for tree in (back, like))
        if step != 12 or not all(g.device.type == "cpu" and torch.equal(g, w)
                                 for g, w in zip(got, want)):
            fail("phase 13: the card's step-12 checkpoint does not restore "
                 "on the CPU with equal leaves")
        print(f"  the card's step-12 checkpoint restores on the CPU: "
              f"{len(got)} leaves equal")


def phase_train():
    import gc

    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    train_full_width()
    train_trainer_resume()
    print(f"  phase 13 wall {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 14: the distribution layer
# ---------------------------------------------------------------------------

#: the dry-run cells of phase 14 (d): the launcher's flags, one process each
DRYRUN_CELLS = (
    ("qwen3-0.6b_train_4k", ["--arch", "qwen3-0.6b", "--shape", "train_4k",
                             "--mesh", "both"]),
    ("qwen3-moe_decode_32k_moe2d", ["--arch", "qwen3-moe-235b-a22b",
                                    "--shape", "decode_32k", "--mesh",
                                    "single", "--moe-2d"]))
DRYRUN_OUT = os.path.join(ROOT, "build", "phase14_dryrun")
#: meshed vs mesh-free trainer on one rank: losses and grad norms (the
#: mesh's loss masks the padded vocab tail and sums the gold logit instead
#: of gathering it: the same value, another rounding)
MESH_TRAIN_RTOL = 1e-5


def start_dryruns():
    """Phase 14 (d), started before phase 13: each cell of
    :data:`DRYRUN_CELLS` runs ``python -m repro_torch.launch.dryrun`` on the
    host's CPU (a fake process group of 256 or 512 ranks, one or two cores)
    while phase 13 and 14 (a)-(c) hold the card (their times are CUDA
    events)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for name, flags in DRYRUN_CELLS:
        out = os.path.join(DRYRUN_OUT, name)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *flags,
               "--out", out]
        procs.append((name, flags, out, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def _one_rank_mesh():
    """A (1, 1) ("data", "model") mesh over cuda:0: a one-rank NCCL
    process group."""
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    return make_debug_mesh(1, 1, device_type="cuda")


def _replicated(tree, mesh):
    """Each leaf of ``tree`` as a replicated DTensor on ``mesh`` (on one
    rank: the same storage, no copy)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import distribute

    rep = [Replicate()] * mesh.ndim
    return {k: (_replicated(v, mesh) if isinstance(v, dict)
                else distribute(v, mesh, rep)) for k, v in tree.items()}


def distribution_moe(mesh):
    """Phase 14 (a): qwen3-moe-235b-a22b at full width, 8 of its 94 layers
    (bf16, random weights from seed 0, attn_impl "auto"), on the (1, 1)
    mesh with moe_impl "auto" (the expert-parallel dropping path) against
    the mesh-free model under moe_impl "dropping": a 320-token prefill's
    logits must be bitwise equal, and two runs of each bitwise equal (the
    combine has no atomics); both timed by CUDA events in turns (median of
    3). Then "decode2d" on the mesh against the mesh-free "decode2d" on one
    B=4 decode step's MoE input (layer 0), timed alike."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import batch_shardings, distribute
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod

    cfg = get_config("qwen3-moe-235b-a22b").replace(dtype="bfloat16",
                                                    num_layers=8)
    plain = build_model(cfg, attn_impl="auto", moe_impl="dropping",
                        device="cuda")
    meshed = build_model(cfg, attn_impl="auto", moe_impl="auto", mesh=mesh)
    t0 = time.perf_counter()
    params = plain.init(0)
    pm = _replicated(params, mesh)
    torch.cuda.synchronize()
    shared = all(a.to_local().data_ptr() == b.data_ptr()
                 for a, b in zip(_leaves(pm), _leaves(params)))
    print(f"  qwen3-moe (8 layers, full width, bf16) drawn in "
          f"{time.perf_counter() - t0:.1f}s; on the (1, 1) mesh as "
          f"replicated DTensors {'sharing' if shared else 'COPYING'} the "
          f"storage")
    if not shared:
        fail("phase 14 (a): the one-rank DTensors copied the weights")
    rng = np.random.default_rng(12)
    tokens = torch.as_tensor(rng.integers(4, cfg.vocab_size, (1, 320)),
                             dtype=torch.int32, device="cuda")
    pl = batch_shardings({"tokens": ("batch", "seq")},
                         {"tokens": tokens.shape}, mesh)
    tm = distribute(tokens, mesh, pl["tokens"])
    run = {"mesh-free": lambda: plain.prefill(params, {"tokens": tokens},
                                              512)[0],
           "mesh": lambda: meshed.prefill(pm, {"tokens": tm},
                                          512)[0].full_tensor()}
    out = {k: [fn(), fn()] for k, fn in run.items()}
    for k, (a, b) in out.items():
        if not bool(torch.isfinite(a.float()).all()):
            fail(f"phase 14 (a): {k} prefill logits are not finite")
        if not torch.equal(a, b):
            fail(f"phase 14 (a): two {k} prefills differ")
    diff = float((out["mesh"][0].float() - out["mesh-free"][0].float()
                  ).abs().max())
    if not torch.equal(out["mesh"][0], out["mesh-free"][0]):
        fail(f"phase 14 (a): prefill logits on the mesh differ from the "
             f"mesh-free dropping path's (max {diff})")
    ms = {"mesh-free": [], "mesh": []}
    for k in ("mesh-free", "mesh", "mesh", "mesh-free"):  # in turns
        ms[k].append(_event_ms(run[k]))
    print(f"  qwen3-moe prefill S=320 on the (1, 1) mesh (moe auto -> "
          f"expert-parallel dropping) == mesh-free dropping: bitwise; two "
          f"runs of each bitwise | CUDA events, in turns (median of 3 "
          f"each): mesh-free {', '.join(f'{x:.2f}' for x in ms['mesh-free'])}"
          f" ms, mesh {', '.join(f'{x:.2f}' for x in ms['mesh'])} ms")
    # decode2d on a mesh takes one capacity row more than the one-device
    # body (as in the JAX package); at T=4, top-8 of 128 both take 1
    caps = [max(1, int(4 * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
                + extra) for extra in (0, 1)]
    if caps[0] != caps[1]:
        fail(f"phase 14 (a): decode2d capacities differ at T=4: {caps}")
    lp = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    lpm = _replicated(lp, mesh)
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn((4, 1, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    xm = _replicated({"x": x}, mesh)["x"]
    d2 = {"mesh-free": lambda: moe_mod.moe_forward(lp, x, cfg, "decode2d")[0],
          "mesh": lambda: moe_mod.moe_forward(lpm, xm, cfg, "decode2d",
                                              mesh=mesh)[0].full_tensor()}
    ya, yb = d2["mesh-free"](), d2["mesh"]()
    ddiff = float((ya.float() - yb.float()).abs().max())
    scale = float(ya.float().abs().max())
    if not bool(torch.isfinite(ya.float()).all()):
        fail("phase 14 (a): mesh-free decode2d output is not finite")
    if not torch.equal(ya, yb):
        fail(f"phase 14 (a): decode2d on the mesh differs from mesh-free "
             f"(max {ddiff} of max {scale})")
    dms = {"mesh-free": [], "mesh": []}
    for k in ("mesh-free", "mesh", "mesh", "mesh-free"):
        dms[k].append(_event_ms(d2[k]))
    print(f"  decode2d, one B=4 decode step's MoE input (layer 0): mesh vs "
          f"mesh-free max |diff| {ddiff:.4g} of max {scale:.4g} "
          f"(bitwise) | CUDA "
          f"events in turns: mesh-free "
          f"{', '.join(f'{v:.3f}' for v in dms['mesh-free'])} ms, mesh "
          f"{', '.join(f'{v:.3f}' for v in dms['mesh'])} ms")
    del plain, meshed, params, pm, lp, lpm, run, d2, out
    torch.cuda.empty_cache()


def distribution_trainer(mesh):
    """Phase 14 (b): qwen2-vl-2b at its published widths and depth in f32
    (TF32 off), ``Trainer`` on the (1, 1) mesh against ``Trainer`` without
    one, both initialised from seed 0 on the card (equal weights), B=8,
    S=256 batches from the trainer's stream: two steps each, in turns
    (mesh-free, mesh, mesh, mesh-free), timed by CUDA events; losses and
    grad norms equal to 1e-5 relative."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.config import (OptimizerConfig, ShardingConfig,
                                    TrainConfig)
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import Trainer

    cfg = get_config("qwen2-vl-2b").replace(dtype="float32")
    trainers = {}
    with tempfile.TemporaryDirectory(prefix="phase14_") as tmp:
        for name, m in (("mesh-free", None), ("mesh", mesh)):
            tc = TrainConfig(model="qwen2-vl-2b", batch_size=TRAIN_B,
                             seq_len=TRAIN_S, steps=2,
                             checkpoint_dir=os.path.join(tmp, name),
                             optimizer=OptimizerConfig(
                                 lr=TRAIN_LR, total_steps=TRAIN_TOTAL),
                             sharding=ShardingConfig())
            t = Trainer(tc, model=build_model(cfg, param_dtype="float32",
                                              device="cuda", mesh=m), mesh=m)
            t.initialize(resume=False)
            trainers[name] = t
    same = all(torch.equal(a.to_local(), b) for a, b in zip(
        _leaves(trainers["mesh"].params), _leaves(trainers["mesh-free"].params)))
    if not same:
        fail("phase 14 (b): the two trainers' initial weights differ")
    rec = {k: [] for k in trainers}
    for step, order in ((0, ("mesh-free", "mesh")), (1, ("mesh", "mesh-free"))):
        for name in order:
            t = trainers[name]
            batch = t._batch(step)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t.params, t.opt_state, m = t._step_fn(t.params, t.opt_state,
                                                  batch)
            end.record()
            torch.cuda.synchronize()
            rec[name].append((float(m["loss"]), float(m["grad_norm"]),
                              start.elapsed_time(end)))
    worst = 0.0
    for (la, ga, _), (lb, gb, _) in zip(rec["mesh-free"], rec["mesh"]):
        if not all(np.isfinite(v) for v in (la, ga, lb, gb)):
            fail(f"phase 14 (b): not finite: {rec}")
        worst = max(worst, abs(la - lb) / abs(la), abs(ga - gb) / abs(ga))
    for name, r in rec.items():
        print(f"  qwen2-vl-2b f32 Trainer {name}: " + "; ".join(
            f"step {i + 1} loss {l:.7f} grad_norm {g:.6f} {ms:.1f} ms"
            for i, (l, g, ms) in enumerate(r)))
    print(f"  meshed vs mesh-free trainer: largest relative difference of a "
          f"loss or grad norm {worst:.3e} (tolerance {MESH_TRAIN_RTOL:g}); "
          f"step walls in turns (CUDA events) above")
    if worst > MESH_TRAIN_RTOL:
        fail(f"phase 14 (b): meshed trainer {rec['mesh']} vs mesh-free "
             f"{rec['mesh-free']}")
    del trainers
    torch.cuda.empty_cache()


def distribution_elastic(mesh):
    """Phase 14 (c): phase 13 (b)'s reduced trainer (qwen2-vl-2b reduced,
    f32, B=8, S=256, 6 steps, a checkpoint at 6), run again on the card;
    its step-6 checkpoint restored onto the (1, 1) cuda mesh by
    ``elastic_restore_tree`` equals ``Checkpointer.restore`` of the same
    files, leaf by leaf, bitwise."""
    import tempfile

    import torch

    from repro_torch.checkpoint import elastic_restore_tree
    from repro_torch.config import (OptimizerConfig, ShardingConfig,
                                    TrainConfig)
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.training import Trainer

    mcfg = reduced_config("qwen2-vl-2b").replace(dtype="float32")
    with tempfile.TemporaryDirectory(prefix="phase14_") as tmp:
        t = Trainer(TrainConfig(model="qwen2-vl-2b", batch_size=TRAIN_B,
                                seq_len=TRAIN_S, steps=6,
                                log_every=6, checkpoint_every=6,
                                checkpoint_dir=tmp,
                                optimizer=OptimizerConfig(lr=TRAIN_LR,
                                                          total_steps=12),
                                sharding=ShardingConfig()),
                    model=build_model(mcfg, param_dtype="float32",
                                      device="cuda"))
        with contextlib.redirect_stdout(io.StringIO()):
            t.train()
        like = {"params": t.params}
        step_a, plain = t.ckpt.restore(like, step=6)
        step_b, meshed = elastic_restore_tree(
            t.ckpt, like, {"params": t.model.specs()}, mesh, step=6)
        got = list(_leaves(meshed["params"]))
        want = list(_leaves(plain["params"]))
        if step_a != step_b or not all(
                torch.equal(g.full_tensor(), w) and g.device_mesh is mesh
                for g, w in zip(got, want)):
            fail("phase 14 (c): the elastic restore differs from "
                 "Checkpointer.restore")
    print(f"  reduced trainer's step-6 checkpoint: elastic_restore_tree onto "
          f"the (1, 1) cuda mesh == Checkpointer.restore, {len(got)} leaves "
          f"bitwise")


def _finish_dryruns(procs):
    """Phase 14 (d): wait for the dry-run cells and print each record."""
    for name, flags, out, t0, proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase 14 (d): dryrun {flags} exit {proc.returncode}:\n"
                 f"{stderr[-3000:]}")
        with open(os.path.join(out, "dryrun_summary.json")) as f:
            recs = json.load(f)
        print(f"  $ repro_torch.launch.dryrun {' '.join(flags)} "
              f"({wall:.1f}s)")
        for r in recs:
            if not r.get("ok"):
                fail(f"phase 14 (d): cell {r.get('arch')} {r.get('shape')} "
                     f"{r.get('mesh')} failed: {r.get('error')}")
            ro = r["roofline"]
            print(f"  | {r['arch']} {r['shape']} {r['mesh']} "
                  f"({r['devices']} ranks): per-device FLOPs "
                  f"{r['per_device_flops']:.6g}, argument bytes "
                  f"{r['memory']['argument_size_in_bytes']}, collective "
                  f"bytes {r['collective_bytes_per_device']:.6g}, HBM bytes "
                  f"{r['per_device_bytes']:.6g}; roofline (H100 SXM data "
                  f"sheet) compute {ro['compute_s']:.4g} s, memory "
                  f"{ro['memory_s']:.4g} s, collective "
                  f"{ro['collective_s']:.4g} s -> {ro['dominant']}; model "
                  f"FLOPs {r['model_flops']:.6g}; cell wall {r['wall_s']} s")


def phase_distribution(procs):
    """Phase 14: (a)-(c) on a one-rank NCCL mesh, then (d) collects the
    dry-run cells ``procs`` (:func:`start_dryruns`). No hand kernel may
    launch: the kernels take no DTensor."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    try:
        torch.cuda.empty_cache()
        before = ops.launches()
        mesh = _one_rank_mesh()
        try:
            distribution_moe(mesh)
            distribution_trainer(mesh)
            distribution_elastic(mesh)
        finally:
            dist.destroy_process_group()
        if ops.launches() != before:
            fail(f"phase 14: a hand kernel launched on a mesh: {before} -> "
                 f"{ops.launches()}")
        _finish_dryruns(procs)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"  phase 14 wall {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 15: the card against the JAX package's record
# ---------------------------------------------------------------------------

ATTENTION = ("flash_attention", "decode_attention", "decode_attention_paged")


def _launched(before):
    """Kernel launches since ``before`` (an ``ops.launches()`` reading)."""
    from repro_torch.kernels import ops

    return {k: n - before[k] for k, n in ops.launches().items()}


def _case_launch_faults(label, family, paged, got, prefill=True):
    """What a model case on the card must have launched: an ssm none of the
    attention kernels; every other family the flash kernel (when it
    prefilled) and the decode kernel of its cache, the paged one only for
    the attention families (dense, vlm, moe) on a paged pool (hybrid and
    encdec caches stay dense there); no image kernel."""
    want = {name: 0 for name in ATTENTION + ("image_stats",)}
    if family != "ssm":
        want["flash_attention"] = 1 if prefill else 0
        on_pages = paged and family in ("dense", "vlm", "moe")
        want["decode_attention_paged" if on_pages else "decode_attention"] = 1
    faults = [f"{name}: {got[name]} (want {'>= 1' if n else 0})"
              for name, n in want.items()
              if (n and got[name] < 1) or (not n and got[name])]
    return [f"{label}: {', '.join(faults)}"] if faults else []


def reference_kernels(meta, arrays):
    """15 (a): each kernel on the card against the recorded Pallas output at
    tests/test_kernels.py's tolerances (histogram exact; a fully masked
    decode slot against the recorded XLA output). Comparison launches: not
    added to the kernels line, as phase 3's are not."""
    from repro_torch import replay
    from repro_torch.kernels import ops

    worst, faults, counts = {}, [], {}
    for case in meta["kernels"]:
        before = ops.launches()
        got = replay.run_kernel(case, replay.kernel_inputs(case, arrays),
                                "cuda")
        n = _launched(before)[case["kernel"]]
        counts[case["kernel"]] = counts.get(case["kernel"], 0) + n
        if n != 1:
            faults.append(f"{case['id']}: {n} launches of {case['kernel']}")
        err, bad = replay.hold_kernel(case, got, arrays)
        faults += bad
        # the head dims of the warp-specialised flash kernel on a line of
        # their own
        wide = case["kernel"] == "flash_attention" and case["hd"] >= 192
        key = (case["kernel"], case.get("dtype", "float32"),
               " at hd 192/256" if wide else "")
        worst[key] = max(worst.get(key, 0.0), err)
    for (kernel, dtype, where), err in sorted(worst.items()):
        what = ("relative error of the sums, histogram equal"
                if kernel == "image_stats" else "max |err|")
        print(f"  (a) {kernel} {dtype}{where}: {what} {err:.3g} against the "
              f"recorded Pallas output")
    print(f"  (a) {len(meta['kernels'])} cases, launches {counts}")
    if faults:
        fail("phase 15 (a): " + "; ".join(faults))


def reference_engines(meta):
    """15 (b): every arch's engine case on the card (reduced f32, attn_impl
    and decode_impl "cuda", the record's drawn weights) under each variant
    must decode JAX's tokens exactly; a miss names the request, the step
    and JAX's margin there."""
    import torch

    from repro_torch import replay
    from repro_torch.kernels import ops

    totals, faults = {}, []
    for case in meta["engines"]:
        arch = case["arch"]
        model = replay.build(arch, "cuda")
        params = replay.params_for(meta, arch, "cuda")
        n_tok, launched, steps = 0, {}, {"graph": 0, "eager": 0}
        for variant, (paged, fused) in replay.VARIANTS.items():
            before = ops.launches()
            stats = {}
            got = replay.run_engine(case, variant, model, params, "cuda",
                                    stats)
            torch.cuda.synchronize()
            d = _launched(before)
            steps["graph"] += stats["graph"]
            steps["eager"] += stats["eager"]
            # the fused blocks of the families that write by absolute
            # position replay CUDA graphs; ssm/hybrid blocks stay eager
            graphed = fused > 1 and model.cfg.family not in ("ssm", "hybrid")
            if graphed != (stats["graph"] > 0):
                faults.append(f"{arch} {variant}: {stats['graph']} graphed "
                              f"fused steps")
            miss = replay.first_mismatch(got, case["tokens"][variant],
                                         case["margins"])
            if miss:
                print(f"  (b) MISMATCH {arch} {variant}: {miss}")
                faults.append(f"{arch} {variant}")
            faults += _case_launch_faults(f"{arch} {variant}",
                                          model.cfg.family, paged, d)
            n_tok += sum(len(t) for t in got.values())
            for k, n in d.items():
                launched[k] = launched.get(k, 0) + n
                totals[k] = totals.get(k, 0) + n
        same = not any(f.startswith(arch) for f in faults)
        print(f"  (b) {arch}: {n_tok} tokens over 4 variants "
              f"{'==' if same else '!='} JAX (smallest JAX margin "
              f"{case['min_margin']}); fused steps graphed "
              f"{steps['graph']}, eager {steps['eager']}; launches "
              f"{ {k: n for k, n in launched.items() if n} }")
        del model, params
    if faults:
        fail("phase 15 (b): " + "; ".join(faults))
    return totals


def reference_cluster(meta, arrays):
    """15 (c): the edge-cloud ClusterServer case on the card (the fused
    image-statistics kernel scoring): routes, tiers and tokens equal JAX's;
    one image launch a request, flash and paged decode launched."""
    from repro_torch import replay
    from repro_torch.kernels import ops

    before = ops.launches()
    got = replay.run_cluster(meta, arrays, "cuda")
    d = _launched(before)
    want = meta["cluster"]["results"]
    faults = []
    if sorted(got) != sorted(int(r) for r in want):
        faults.append(f"rids {sorted(got)} != {sorted(want)}")
    for rid, r in sorted(got.items()):
        w = want.get(str(rid), {})
        same = (not r["failed"] and r["routes"] == w.get("routes")
                and r["tier"] == w.get("tier")
                and r["tokens"] == w.get("tokens"))
        print(f"  (c) rid {rid}: routes {r['routes']} tier {r['tier']} "
              f"tokens {r['tokens']} {'==' if same else '!='} JAX")
        if not same:
            faults.append(f"rid {rid}: card {r} != JAX {w}")
    n_img = len(meta["cluster"]["requests"])
    if d["image_stats"] != n_img:
        faults.append(f"image_stats launched {d['image_stats']} times for "
                      f"{n_img} image requests")
    for name in ("flash_attention", "decode_attention_paged"):
        if d[name] < 1:
            faults.append(f"{name} never launched")
    print(f"  (c) launches {d}")
    if faults:
        fail("phase 15 (c): " + "; ".join(faults))
    return d


def reference_wire(meta, arrays):
    """15 (d): each recorded JAX slot injected into a paged and a dense
    engine on the card finishes with JAX's tokens, with no prefill."""
    import torch

    from repro_torch import replay
    from repro_torch.kernels import ops

    totals, faults = {}, []
    for case in meta["wire"]:
        family = replay.reduced_cfg(case["arch"]).family
        for paged in (True, False):
            label = f"{case['arch']} {'paged' if paged else 'dense'}"
            before = ops.launches()
            toks, prefilled = replay.run_wire(meta, arrays, case, paged,
                                              "cuda")
            torch.cuda.synchronize()
            d = _launched(before)
            same = toks == case["tokens"] and prefilled == 0
            print(f"  (d) {label}: {case['nbytes']} wire bytes, tokens "
                  f"{toks} {'==' if same else '!='} JAX {case['tokens']}"
                  f" (prefill tokens {prefilled})")
            if not same:
                faults.append(label)
            faults += _case_launch_faults(label, family, paged, d,
                                          prefill=False)
            for k, n in d.items():
                totals[k] = totals.get(k, 0) + n
    if faults:
        fail("phase 15 (d): " + "; ".join(faults))
    return totals


def phase_reference(records):
    """Phase 15: the card against the JAX package's results recorded on the
    CPU (tests/data/jax_reference.*), read with numpy and repro_torch
    only. Launches of (b)-(d) join the kernels line."""
    import torch

    from repro_torch import replay

    t0 = time.perf_counter()
    meta, arrays = replay.load(ROOT)
    print(f"  record: {len(meta['kernels'])} kernel cases, "
          f"{len(meta['engines'])} archs x {len(replay.VARIANTS)} engine "
          f"variants, {len(meta['cluster']['requests'])} cluster requests, "
          f"{len(meta['wire'])} wire slots (JAX {meta['versions']['jax']})")
    reference_kernels(meta, arrays)
    t1 = time.perf_counter()
    added = {}
    for d in (reference_engines(meta), reference_cluster(meta, arrays),
              reference_wire(meta, arrays)):
        for k, n in d.items():
            added[k] = added.get(k, 0) + n
    for name, n in added.items():
        records[name]["launches"] = records[name].get("launches", 0) + n
    torch.cuda.empty_cache()
    print(f"  phase 15 launches (b)-(d) {added}; (a) {t1 - t0:.1f}s, "
          f"phase 15 wall {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 16: the fused decode block, eager against CUDA graphs
# ---------------------------------------------------------------------------

#: the benchmark cell qwen-vqa-poisson's decode shape: 32 live slots of the
#: paged pool (4096 rows a slot in pages of 256) at context 1400, so the
#: block of 8 steps reads the 1536-row bucket
GRAPH_BLOCK = dict(batch=32, max_seq=4096, page=256, ctx=1400, k=8)


def time_decode_block(arch, seed, rounds=3):
    """One tier's fused block at ``GRAPH_BLOCK``, eager (the engine's graphs
    off) and graphed on one engine, in turns (eager, graph, graph, eager) x
    ``rounds`` after two warm blocks each (the graphed warm-up takes the
    bucket's eager first step and its capture). Each block restarts from
    the same cache state, so both modes must give the same tokens. Then one
    more turn of each inside a ``torch.profiler`` session, as a traced
    benchmark run records. Returns {mode: [(block ms by CUDA events, host
    issue ms by the engine's ``engine.decode.issue`` span)]} and the
    engine's graph counters."""
    import numpy as np
    import torch

    from repro_torch import tracing
    from repro_torch.config import ServingConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine, _get

    g = GRAPH_BLOCK
    model = build_model(get_config(arch).replace(dtype="bfloat16"),
                        attn_impl="cuda", device="cuda")
    eng = TierEngine(model, model.init(seed), ServingConfig(
        max_batch=g["batch"], max_seq=g["max_seq"], paged=True,
        kv_page_size=g["page"], fused_steps=g["k"]), eos_id=-1)
    b, ctx, k = g["batch"], g["ctx"], g["k"]
    npg = -(-(ctx + k + 1) // g["page"])
    cache = eng.cache
    cache["pages"][:, :npg] = torch.arange(
        1, 1 + b * npg, dtype=torch.int32, device="cuda").view(b, npg)
    cache["pos"][:, :ctx] = torch.arange(ctx, dtype=torch.int32,
                                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name in eng._paged_names:
        _get(cache, name).normal_(generator=gen)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, eng.cfg.vocab_size, b).astype(np.int32)
    positions = np.full((b,), ctx, np.int32)
    budgets = np.full((b,), 64, np.int32)
    rids = np.arange(b, dtype=np.int64)
    teff = eng._context_bucket(ctx + k + 1)
    if teff != 1536:
        fail(f"phase 16: context bucket {teff} for {ctx} rows, want 1536")

    def block(graphs):
        eng._graph_ok = graphs
        cache["index"].fill_(ctx)
        tracing.clear()
        tracing.enable()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = eng._fused(tokens, positions, budgets, teff, k, rids)
        e1.record()
        e1.synchronize()
        tracing.disable()
        issue = [s for s in tracing.records()
                 if s.name == "engine.decode.issue"][-1]
        return out, e0.elapsed_time(e1), (issue.t1_ns - issue.t0_ns) / 1e6

    times = {"eager": [], "graph": []}
    want = block(False)[0]
    for graphs in (False, False, True, True):
        if not np.array_equal(block(graphs)[0], want):
            fail(f"phase 16 {arch}: a warm {'graphed' if graphs else 'eager'}"
                 f" block's tokens differ from the first eager block's")
    steps0 = eng.decode_graph_steps
    for _ in range(rounds):
        for graphs in (False, True, True, False):
            out, ms, issue = block(graphs)
            if not np.array_equal(out, want):
                fail(f"phase 16 {arch}: {'graphed' if graphs else 'eager'} "
                     f"block's tokens differ from the eager block's")
            times["graph" if graphs else "eager"].append((ms, issue))
    if eng.decode_graph_steps - steps0 != 2 * rounds * k:
        fail(f"phase 16 {arch}: {eng.decode_graph_steps - steps0} graphed "
             f"steps in {2 * rounds} graphed blocks of {k}")
    # graphed without extents (every slot is live here: nothing to skip),
    # then with them again, each after its own capture and a warm block.
    # Without extents the kernel splits the rows elsewhere, so its bf16
    # sums round apart and a near tie may pick another token: its blocks
    # must equal its own first, and the tokens that differ are counted
    from repro_torch.models import attention as attn_mod

    real = attn_mod.decode_attention_paged

    def every_row(*args, lens=None, **kw):  # the extents dropped
        return real(*args, **kw)

    flips = 0
    try:
        for extents, mode in ((False, "graph, no extents"),
                              (True, "graph, extents again")):
            attn_mod.decode_attention_paged = real if extents else every_row
            eng._graphs.clear()  # new graphs in a new pool, as after restore
            eng._graph_seen.clear()
            eng._graph_pool = None
            times[mode] = []
            ref = want
            for i in range(2 + rounds):
                out, ms, issue = block(True)
                if not extents and i == 0:
                    ref = out
                    flips = int((out != want).sum())
                if not np.array_equal(out, ref):
                    fail(f"phase 16 {arch}: {mode} block's tokens differ")
                if i >= 2:
                    times[mode].append((ms, issue))
    finally:
        attn_mod.decode_attention_paged = real
    # the same turns under the benchmark's traced-run profiler (CUDA
    # activity only): what it adds to each mode's issue time
    from torch.profiler import ProfilerActivity, profile

    times.update({"eager profiled": [], "graph profiled": []})
    with profile(activities=[ProfilerActivity.CUDA]):
        for graphs in (False, True, True, False):
            out, ms, issue = block(graphs)
            times["graph profiled" if graphs else "eager profiled"].append(
                (ms, issue))
    counters = (eng.decode_graph_steps, eng.decode_eager_steps,
                eng.decode_graph_captures, eng.decode_rows_live,
                eng.decode_rows_grid, flips)
    del eng, model
    torch.cuda.empty_cache()
    return times, counters


def phase_decode_graphs():
    """Phase 16: the fused decode block of both Qwen tiers at the benchmark
    cell's shapes, eager against graphed (``time_decode_block``)."""
    import subprocess as sp

    t0 = time.perf_counter()
    limit = sp.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True).stdout.strip()
    g = GRAPH_BLOCK
    for seed, arch in enumerate(("qwen2-vl-2b", "qwen2.5-vl-7b")):
        times, (gs, es, caps, live, grid, flips) = time_decode_block(arch,
                                                                     seed)
        med = {m: (statistics.median(t[0] for t in v),
                   statistics.median(t[1] for t in v))
               for m, v in times.items()}
        print(f"  {arch} B={g['batch']} ctx {g['ctx']} (bucket 1536) k="
              f"{g['k']} paged {g['page']}: block eager "
              f"{med['eager'][0]:.2f} ms ({med['eager'][0] / g['k']:.3f} a "
              f"step, issue {med['eager'][1]:.2f} ms), graphed "
              f"{med['graph'][0]:.2f} ms ({med['graph'][0] / g['k']:.3f} a "
              f"step, issue {med['graph'][1]:.2f} ms), "
              f"{med['eager'][0] / med['graph'][0]:.2f}x; tokens equal; "
              f"graph steps {gs}, eager steps {es}, captures {caps}; "
              f"graphed without extents "
              f"{med['graph, no extents'][0]:.2f} ms ({flips} of "
              f"{g['batch'] * g['k']} tokens another), with them again "
              f"{med['graph, extents again'][0]:.2f} ms; rows live {live} "
              f"of the grid's {grid} ({live / grid:.1%}) [{limit}]")
        for m, v in times.items():
            print(f"    {m}: " + ", ".join(f"{a:.2f}/{i:.2f}" for a, i in v)
                  + " (block ms / issue ms, in turn order)")
    print(f"  phase 16 wall {time.perf_counter() - t0:.1f}s")


def phase_launcher():
    """The launcher's default run, then its warm-serving and migration
    flags (phase 8 (d)), which must print the ``sessions:`` line, then
    speculation (``speculation:``) and process replicas (the ``replicas:``
    lines), phase 9 (d)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    for flags, want in (([], "served "),
                        (["--sessions", "2", "--turns", "2",
                          "--prefix-cache-mb", "64", "--migrate"],
                         "sessions: "),
                        (["--speculate", "edge:cloud", "--draft-k", "4"],
                         "speculation: "),
                        (["--replicas", "edge=2", "--transport", "process"],
                         "  replicas[edge]: ")):
        proc = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.serve", "--requests", "4",
                               "--max-new", "4", *flags],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        lines = proc.stdout.splitlines()
        print(f"  $ repro_torch.launch.serve --requests 4 --max-new 4 "
              f"{' '.join(flags)}")
        for line in lines[:9]:
            print(f"  | {line}")
        if proc.returncode != 0:
            fail(f"launcher {flags} exit {proc.returncode}:\n"
                 f"{proc.stderr[-3000:]}")
        if not any(line.startswith(want) for line in lines):
            fail(f"launcher {flags}: no {want.strip()!r} line")
        if "--transport" in flags and not any(
                line.startswith("replicas: ") for line in lines):
            fail(f"launcher {flags}: no 'replicas:' line")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--parent-csrc", default=None,
                    help="a directory with another tree's attention kernel "
                         "sources (e.g. the parent commit's csrc/, unpacked "
                         "with git archive): phase 3 times them in turns "
                         "with this tree's")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    name, count, _ = phase_device()
    if 2 in phases or 3 in phases:
        print("phase 2: build")
        phase_build()
        if args.parent_csrc:
            build_parent(args.parent_csrc)
    records = {}
    if 3 in phases:
        print("phase 3: kernels vs plain versions")
        check_image(records)
        check_decode_dense(records)
        check_decode_paged(records)
        check_decode_extents(records)
        check_flash(records)
    if phases & {4, 5, 8, 9} and 3 not in phases:
        fail("phases 4, 5, 8 and 9 record launches into phase 3's kernel "
             "records")
    built = None
    if phases & {4, 5, 8, 9}:
        engines, built = full_width_models()
    if 4 in phases or 5 in phases:
        print("phase 4-5: full-width prefill and serving (paged with the "
              "flash-attention kernel, then dense)")
        phase_serve_full(records, engines, built)
    if built is not None:
        del engines
    if 6 in phases:
        print("phase 6: reduced f32, cuda vs torch prefill and decode")
        phase_impl_parity()
    if 8 in phases:
        print("phase 8: warm serving and migration (full-width sessions and "
              "prefix hits, paged <-> dense migration, reduced parity)")
        phase_warm(records, built)
    if 9 in phases:
        print("phase 9: speculative decoding (full-width edge:cloud serve and "
              "self-draft pair, reduced parity) and process replicas on "
              "cuda")
        phase_spec(records, built)
    del built
    if phases & {10, 11, 12} and 3 not in phases:
        fail("phases 10, 11 and 12 record launches into phase 3's kernel "
             "records")
    if 10 in phases:
        print("phase 10: the recurrent families (full-width recurrentgemma-9b"
              " and mamba2-2.7b, reduced parity)")
        phase_recurrent(records)
    if 11 in phases:
        print("phase 11: full-width phi-3-vision-4.2b serve (hd 96); "
              "nemotron-4-340b at full width, 2 of 96 layers (hd 192)")
        phase_zoo_serve(records)
    if 12 in phases:
        print("phase 12: the MoE and encoder-decoder families (qwen3-moe at "
              "full width, 8 layers; whisper-small at full width and depth; "
              "reduced parity)")
        phase_moe_encdec(records)
    # phase 14 (d)'s dry-run cells run on the CPU beside phases 13 and 14
    dryruns = start_dryruns() if 14 in phases else None
    if 13 in phases:
        print("phase 13: training (full-width qwen2-vl-2b f32 train steps "
              "under each remat policy; the trainer's launcher, resume and "
              "card-vs-CPU history at reduced size)")
        phase_train()
    if 14 in phases:
        print("phase 14: the distribution layer (expert-parallel qwen3-moe "
              "and the meshed qwen2-vl-2b trainer on a one-rank NCCL mesh, "
              "elastic restore, the dry-run on the host)")
        phase_distribution(dryruns)
    if 15 in phases:
        if 3 not in phases:
            fail("phase 15 records launches into phase 3's kernel records")
        print("phase 15: the card against the JAX package's recorded "
              "results (kernels, every arch's tokens, the cluster's routes, "
              "JAX slots on the wire)")
        phase_reference(records)
    if 16 in phases:
        print("phase 16: the fused decode block at the benchmark cell's "
              "shapes, eager against CUDA graphs (both Qwen tiers)")
        phase_decode_graphs()
    if 7 in phases:
        print("phase 7: launcher")
        phase_launcher()
    print(f"total {time.perf_counter() - t0:.1f}s")
    if records:
        for rec in records.values():
            rec.setdefault("launches", 0)
        order = ("name", "route", "source", "replaces", "launches",
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "device_ms", "eager_ms", "shapes",
                 "ws_hd128_record", "instantiations")
        print(json.dumps({"kernels": [{k: rec[k] for k in order if k in rec}
                                      for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
