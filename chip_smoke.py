#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero and no phase catches its own:
  1. device name, count, and nvidia-smi's name and power limit;
  2. build every CUDA source with nvcc (one process per source, in
     parallel) and print the -Xptxas -v register / shared-memory lines;
  3. hold the image-statistics kernel against its plain version at the
     serving, degenerate, flat and 1024x1024 shapes (histogram exact, the
     five scores within 1e-6, repeated calls bitwise equal) and time it
     from a replayed CUDA graph beside an empty kernel's launch floor;
     hold each attention kernel against its plain PyTorch version, in f32
     and bf16, at the serving shapes and at head dims 32 and 64, with an
     all-masked slot, a window, a ragged context or sequence, a
     context-bucket view, a non-causal case and non-contiguous q (decode
     also at T = 1, 33, 97, 300 and 4096, pages of 16 and 64, one live
     split among masked ones, and a forced single split); time the
     kernel, the plain version and, where one PyTorch call computes the same
     function, that call (the port never calls it). Decode is timed as the
     decode loop meets it: launches rotate over a stacked cache larger than
     the L2, the device time per call comes from a replayed CUDA graph
     (which proves the kernel can be captured; its outputs must equal eager
     calls), with SDPA timed the same way in turns and the eager wall per
     call beside it, at T=384 and T=4096;
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
     the wire (size printed, leaves bitwise) finishes with the tokens it
     decodes alone on the target kind; (c) at reduced size in f32 with the
     kernels ("cuda"), a prefix hit and a resumed session equal cold
     serving, paged and dense, and a temperature-0.7 migration equals the
     unmigrated run;
  7. ``python -m repro_torch.launch.serve --requests 4 --max-new 4``, then
     with ``--sessions 2 --turns 2 --prefix-cache-mb 64 --migrate``, which
     must print its ``sessions:`` line (phase 8 (d)). Phase 7 runs last.

The line before the last is the kernels' JSON record (launches: phases 4,
5 and 8 together); the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py                 # everything (one GPU)
    python3 chip_smoke.py --phases 1,2,3  # a subset, for debugging
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 non-tensor, bf16 dense


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


def phase_build():
    from repro_torch.kernels import runtime

    t0 = time.perf_counter()
    logs = runtime.build_all()
    for src in runtime.sources():
        runtime.load(src.stem)
    print(f"built {len(runtime.sources())} sources in "
          f"{time.perf_counter() - t0:.1f}s into {runtime.build_dir()}")
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                print(f"  [{stem}] {line.strip()}")
    # the serving prefill kernel's lines, picked out of its entry's block
    entry = False
    for line in logs.get("flash_attention", "").splitlines():
        if "Compiling entry" in line:
            entry = "flash_bf16_wgmma_kernel" in line
        elif entry and any(w in line for w in ("registers", "spill")):
            print(f"  flash_bf16_wgmma_kernel (hd 128): "
                  f"{line.strip().split(': ', 1)[-1]}")


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


KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _decode_case(b, h, kh, hd, t_cache, t_ctx, dtype, gen, *, fill=None,
                 dead_slot=False, window=None, live=None, layers=0):
    """Dense-cache inputs: k/v (B, t_cache, K, hd), attended view t_ctx.
    ``live=(lo, hi)``: only rows lo..hi-1 hold positions (0..), every other
    entry is empty. ``layers``: k/v are layer 0 of a stacked cache
    (2, layers, B, t_cache, K, hd) of k and v, returned as the last item."""
    import torch

    q = _rand((b, 1, h, hd), dtype, gen)
    stack = _rand((2, max(layers, 1), b, t_cache, kh, hd), dtype, gen)
    k, v = stack[0, 0], stack[1, 0]
    fill = t_ctx - 3 if fill is None else fill
    pos = torch.full((b, t_cache), -1, dtype=torch.int32, device="cuda")
    if live is not None:
        lo, hi = live
        pos[:, lo:hi] = torch.arange(hi - lo, dtype=torch.int32, device="cuda")
        fill = hi - lo
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


def _hold(label, got, want, dtype, v_rows=None):
    """got against want at the dtype's tolerance; with ``v_rows`` (the last
    slot's attended (T, K, hd) value rows) also that slot against mean(V)."""
    import torch

    t = KERNEL_TOL[str(dtype)[6:]]
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=t, atol=t):
        fail(f"{label} {dtype}: max |err| {err}")
    if v_rows is not None:
        kh, hd = v_rows.shape[1:]
        mean_v = v_rows.float().mean(dim=0)  # (K, hd)
        row = got[-1, 0].float().reshape(kh, -1, hd)
        if not torch.allclose(row, mean_v[:, None].expand_as(row), rtol=t,
                              atol=t):
            fail(f"{label} {dtype}: the all-masked slot does not return "
                 f"mean(V)")
    print(f"  {label} {str(dtype)[6:]}: max |err| {err:.3g} (tol {t})"
          + (", all-masked slot = mean(V)" if v_rows is not None else ""))
    return err


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
    ]
    worst = 0.0
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
                        vv[b - 1] if kw.get("dead_slot") else None)
            if label == "cloud" and dtype == torch.bfloat16:
                worst = err
    for t in (384, 4096):
        for label, h, kh in (("edge", 12, 2), ("cloud", 28, 4)):
            time_decode(records, False, label, h, kh, t, worst, gen)


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
    ]
    worst = 0.0
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
                        dead)
            if label == "cloud" and dtype == torch.bfloat16:
                worst = err
    for t in (384, 4096):
        for label, h, kh in (("edge", 12, 2), ("cloud", 28, 4)):
            time_decode(records, True, label, h, kh, t, worst, gen)


def time_decode(records, paged, label, h, kh, t, worst, gen):
    """Time one decode shape (B=4, bf16, hd 128) the way the decode loop
    meets it: launches rotate over the layers of a stacked cache that does
    not fit the 50 MB L2 (28 layers at the serving T=384 of 512; at T=4096
    enough caches to pass 100 MB). Device time per call from a replayed
    CUDA graph (the kernel, then SDPA on the same dense rows, in turns:
    kernel, SDPA, SDPA, kernel), the eager wall per call beside it; the
    graph's outputs must equal eager calls bitwise."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_paged_cuda,
        decode_attention_paged_plain, decode_attention_plain)
    b, hd, dt = 4, 128, torch.bfloat16
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
                                                  gen, layers=layers)
        pos = pos[:, :t]
        kv = [(stack[0, i][:, :t], stack[1, i][:, :t]) for i in range(layers)]
        fns = [lambda i=i: decode_attention_cuda(q, *kv[i], pq, pos)
               for i in range(layers)]
        plain = [lambda i=i: decode_attention_plain(q, *kv[i], pq, pos)
                 for i in range(layers)]
    dd = pq[:, None] - pos
    mask = ((pos >= 0) & (dd >= 0))[:, None, None, :]
    qs = q.transpose(1, 2)
    sdpa = [lambda i=i: F.scaled_dot_product_attention(
        qs, kv[i][0].transpose(1, 2), kv[i][1].transpose(1, 2),
        attn_mask=mask, enable_gqa=True) for i in range(layers)]
    replays = max(10, -(-280 // layers))
    k1, outs = graph_time_ms(fns, replays)
    s1, _ = graph_time_ms(sdpa, replays)
    s2, _ = graph_time_ms(sdpa, replays)
    k2, _ = graph_time_ms(fns, replays)
    for i, fn in enumerate(fns):
        if not torch.equal(outs[i], fn()):
            fail(f"decode {label} T={t}: graph replay differs from eager")
    dev, lib = (k1 + k2) / 2, (s1 + s2) / 2
    eager = eager_time_ms(fns, max(2, -(-100 // layers)))
    plain_ms = (graph_time_ms(plain, 2)[0] if t <= 512 else None)
    nbytes = 2 * b * t * kh * hd * 2 + 2 * b * h * hd * 2 + b * t * 4
    if paged:
        nbytes += pages.numel() * 4
    bd, by = bound_ms(nbytes, 4.0 * b * h * t * hd, "bfloat16")
    name = "decode_attention_paged" if paged else "decode_attention"
    print(f"  {name} {label} B=4 T={t} bf16 ({layers} layers rotated): "
          f"device {dev * 1e3:.2f} us ({k1 * 1e3:.2f}, {k2 * 1e3:.2f}), "
          f"eager wall {eager * 1e3:.2f} us, sdpa device {lib * 1e3:.2f} us "
          f"({s1 * 1e3:.2f}, {s2 * 1e3:.2f})"
          + (f", plain device {plain_ms * 1e3:.2f} us" if plain_ms else "")
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
        flash_attention_tiled_plain)
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
    ]
    worst = 0.0
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
            if label == "cloud" and dtype == torch.bfloat16:
                worst = err
            msg = (f"  flash_attention {label} {str(dtype)[6:]}: max |err| "
                   f"{err:.3g} (tol {t})")
            if dtype == torch.bfloat16:
                tiled = flash_attention_tiled_plain(
                    q, k, v, causal=causal, window=window,
                    p_dtype=torch.bfloat16)
                terr = float((got.float() - tiled.float()).abs().max())
                if not torch.allclose(got.float(), tiled.float(),
                                      rtol=TILED_TOL, atol=TILED_TOL):
                    fail(f"flash_attention {label} bf16 against its tile "
                         f"loop: max |err| {terr}")
                msg += f"; against its tile loop {terr:.3g} (tol {TILED_TOL})"
            print(msg)
    print(f"  flash_attention resident blocks an SM, hd 128: bf16 "
          f"{blocks_per_sm(torch.bfloat16, 128)}, f32 "
          f"{blocks_per_sm(torch.float32, 128)}")
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
        "shapes": shapes}


def time_flash(label, b, s, h, kh, gen):
    """Time one prefill shape (bf16, hd 128, causal) the way a prefill
    meets it: launches rotate over 28 layers' distinct (q, k, v), more bytes
    than the 50 MB L2 holds. Device time per call from a replayed CUDA graph
    of one rotation (the kernel, then SDPA on the same tensors, in turns:
    kernel, SDPA, SDPA, kernel), the eager wall per call beside it; the
    graph's outputs must equal eager calls bitwise. The plain version is
    timed (by a graph) at the serving lengths only."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    hd, dt, layers = 128, torch.bfloat16, 28
    qs = _rand((layers, b, s, h, hd), dt, gen)
    kvs = _rand((layers, 2, b, s, kh, hd), dt, gen)
    fns = [lambda i=i: flash_attention_cuda(qs[i], kvs[i, 0], kvs[i, 1])
           for i in range(layers)]
    sdpa = [lambda i=i: F.scaled_dot_product_attention(
        qs[i].transpose(1, 2), kvs[i, 0].transpose(1, 2),
        kvs[i, 1].transpose(1, 2), is_causal=True, enable_gqa=True)
        for i in range(layers)]
    replays = max(10, -(-280 // layers))
    k1, outs = graph_time_ms(fns, replays)
    s1, _ = graph_time_ms(sdpa, replays)
    s2, _ = graph_time_ms(sdpa, replays)
    k2, _ = graph_time_ms(fns, replays)
    for i, fn in enumerate(fns):
        if not torch.equal(outs[i], fn()):
            fail(f"flash {label} R={b} S={s}: graph replay differs from eager")
    del outs
    dev, lib = (k1 + k2) / 2, (s1 + s2) / 2
    eager = eager_time_ms(fns, max(2, -(-100 // layers)))
    plain_ms = None
    if s <= 512:
        plain = [lambda i=i: flash_attention_plain(qs[i], kvs[i, 0],
                                                   kvs[i, 1])
                 for i in range(layers)]
        plain_ms = graph_time_ms(plain, 2)[0]
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kh * hd)
    flops = 4.0 * b * h * hd * s * (s + 1) / 2  # causal pairs only
    bd, by = bound_ms(nbytes, flops, "bfloat16")
    shape = f"{label} R={b} S={s}"
    print(f"  flash_attention {shape} bf16 ({layers} layers rotated): device "
          f"{dev * 1e3:.2f} us ({k1 * 1e3:.2f}, {k2 * 1e3:.2f}), eager wall "
          f"{eager * 1e3:.2f} us, sdpa device {lib * 1e3:.2f} us "
          f"({s1 * 1e3:.2f}, {s2 * 1e3:.2f})"
          + (f", plain device {plain_ms * 1e3:.2f} us" if plain_ms else "")
          + f", bound {bd * 1e3:.3f} us ({by}), {bd / dev:.1%} of it")
    del qs, kvs
    torch.cuda.empty_cache()
    return {"shape": shape, "device_ms": dev, "library_ms": lib,
            "eager_ms": eager, "plain_ms": plain_ms, "bound_ms": bd,
            "bound_by": by, "share_of_bound": bd / dev}


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
    turn) its prompt and first-token logits."""
    from repro_torch.kernels import ops

    admit, start, step = eng._admit_warm, eng._start_seq, eng.step
    eng._launches = {}

    def stepped():
        before = ops.launches()
        out = step()
        for name, n in ops.launches().items():
            eng._launches[name] = eng._launches.get(name, 0) + n - before[name]
        return out

    def admit_warm(job, slot, plan):
        pf0 = eng.prefill_tokens
        admit(job, slot, plan)
        cold = len(job["tokens"]) + eng._prompt_prefix(job["extras"])
        log.append({"kind": plan["kind"], "cached": int(plan["cached"]),
                    "charged": eng.prefill_tokens - pf0, "cold": cold,
                    "shared": eng.kv_gauges()["pages_shared"]})

    def start_seq(job, slot, prompt_len, first_logits, prefill_count=None,
                  warm=None):
        if warm is not None and warm[0] == "resume":
            eng._last_warm = (job, first_logits.copy())
        start(job, slot, prompt_len, first_logits,
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
    tokens it decodes alone on the target kind, both directions."""
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
    ops.reset_launches()
    alone = {kind: _alone(TierEngine(model, params, sv), prompt, 40)
             for kind, sv in svs.items()}
    for src, dst in (("paged", "dense"), ("dense", "paged")):
        donor = _alone(TierEngine(model, params, svs[src]), prompt, 40,
                       steps=2)
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
        target = TierEngine(model, params, svs[dst])
        target.inject_slot(back)
        got = {s.rid: list(s.generated)
               for s in target.run_until_drained()}[0]
        if target.prefill_tokens != 0:
            fail(f"migrate {src}->{dst}: the target prefilled")
        if got != alone[dst]:
            fail(f"migrate {src}->{dst}: {got} != alone on {dst} "
                 f"{alone[dst]}")
        print(f"  migrate {cfg.name} bf16 {src} -> {dst} after "
              f"{len(payload.seq.generated)} tokens: wire "
              f"{len(wire) / 1e6:.3f} MB (to_bytes {t_out * 1e3:.1f} ms, "
              f"from_bytes {t_in * 1e3:.1f} ms), leaves bitwise, "
              f"{len(got)} tokens equal to the request alone on {dst}")
    counts = ops.launches()
    print(f"  migration runs (two alone, two moved): launches {counts}")
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


def phase_launcher():
    """The launcher's default run, then its warm-serving and migration
    flags (phase 8 (d)), which must print the ``sessions:`` line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    for flags, want in (([], "served "),
                        (["--sessions", "2", "--turns", "2",
                          "--prefix-cache-mb", "64", "--migrate"],
                         "sessions: ")):
        proc = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.serve", "--requests", "4",
                               "--max-new", "4", *flags],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        lines = proc.stdout.splitlines()
        print(f"  $ repro_torch.launch.serve --requests 4 --max-new 4 "
              f"{' '.join(flags)}")
        for line in lines[:8]:
            print(f"  | {line}")
        if proc.returncode != 0:
            fail(f"launcher {flags} exit {proc.returncode}:\n"
                 f"{proc.stderr[-3000:]}")
        if not any(line.startswith(want) for line in lines):
            fail(f"launcher {flags}: no {want.strip()!r} line")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8",
                    help="comma-separated phases to run (default: all)")
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
    records = {}
    if 3 in phases:
        print("phase 3: kernels vs plain versions")
        check_image(records)
        check_decode_dense(records)
        check_decode_paged(records)
        check_flash(records)
    if phases & {4, 5, 8} and 3 not in phases:
        fail("phases 4, 5 and 8 record launches into phase 3's kernel "
             "records")
    built = None
    if phases & {4, 5, 8}:
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
    del built
    if 7 in phases:
        print("phase 7: launcher")
        phase_launcher()
    print(f"total {time.perf_counter() - t0:.1f}s")
    if records:
        for rec in records.values():
            rec.setdefault("launches", 0)
        order = ("name", "route", "source", "replaces", "launches",
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "device_ms", "eager_ms", "shapes")
        print(json.dumps({"kernels": [{k: rec[k] for k in order if k in rec}
                                      for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
