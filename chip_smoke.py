#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero and no phase catches its own:
  1. device name, count, and nvidia-smi's name and power limit;
  2. build every CUDA source with nvcc (one process per source, in
     parallel) and print the -Xptxas -v register / shared-memory lines;
  3. hold each kernel against its plain PyTorch version on the card, in f32
     and bf16, at the serving shapes and at head dim 32, with an all-masked
     slot, a window, a ragged context and a context-bucket view; time the
     kernel, the plain version and, where one PyTorch call computes the same
     function, that call (the port never calls it);
  4. serve the paper's tier pair at full width and depth (qwen2-vl-2b edge,
     qwen2.5-vl-7b cloud, bf16, random weights from a seed) through
     ClusterServer on the paged KV pool, 8 requests of the launcher's mix;
  5. the same on the dense KV pool, 2 requests;
  6. at reduced size in f32, decode_impl "cuda" and "torch" give the same
     tokens;
  7. ``python -m repro_torch.launch.serve --requests 4 --max-new 4``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py                 # everything (one GPU)
    python3 chip_smoke.py --phases 1,2,3  # a subset, for debugging
"""
from __future__ import annotations

import argparse
import json
import os
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _rand(shape, dtype, gen, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def check_image(records):
    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_image
    from repro_torch.kernels.image_complexity import (image_stats_cuda,
                                                      image_stats_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    # The kernel sums in double, the plain version in f32. On integer-valued
    # pixels every stencil value is an integer, so the f32 sums are exact up
    # to 2^24 and rtol 2e-5 / atol 1e-3 hold; on the launcher's real-valued
    # images the near-zero Laplacian sum cancels, and its f32 rounding is
    # bounded by 2e-7 * sum|lap| <= 2e-7 * 8 * 255 * H * W.
    rng = np.random.default_rng(0)
    cases = [(s, torch.randint(0, 256, s, generator=gen, device="cuda")
              .float()) for s in ((1, 64, 64), (2, 33, 65), (3, 128, 96),
                                  (1, 256, 256))]
    cases.append(("launcher 64x64", torch.as_tensor(
        make_image(rng, 0.7, 64, 64), dtype=torch.float32,
        device="cuda")[None]))
    for label, imgs in cases:
        got, want = image_stats_cuda(imgs), image_stats_plain(imgs)
        torch.cuda.synchronize()
        if not torch.equal(got["hist"], want["hist"]):
            fail(f"image_stats histogram differs at {label}")
        _, h, w = imgs.shape
        real = isinstance(label, str)
        for k in ("sobel_sum", "lap_sum", "lap_sq_sum"):
            atol = 2e-7 * 8 * 255 * h * w if (real and k == "lap_sum") else 1e-3
            if not torch.allclose(got[k], want[k], rtol=2e-5, atol=atol):
                fail(f"image_stats {k} at {label}: {got[k]} vs {want[k]}")
        errs = {k: float((got[k] - want[k]).abs().max())
                for k in ("sobel_sum", "lap_sum", "lap_sq_sum")}
        err = max(errs.values())
        if real:
            worst = err
        print(f"  image_stats {label}: hist exact, |err| "
              + ", ".join(f"{k} {e:.3g} of {float(want[k].abs().max()):.6g}"
                          for k, e in errs.items()))
    imgs = cases[-1][1]
    ms = cuda_time_ms(lambda: image_stats_cuda(imgs), iters=200)
    plain = cuda_time_ms(lambda: image_stats_plain(imgs), iters=200)
    b, h, w = imgs.shape
    bd, by = bound_ms(b * h * w * 4 + b * (4 + 256) * 4, 30.0 * b * h * w,
                      "float32")
    print(f"  image_stats (1,64,64) f32: kernel {ms * 1e3:.2f} us, plain "
          f"{plain * 1e3:.2f} us, bound {bd * 1e3:.4f} us ({by})")
    records["image_stats"] = {
        "name": "image_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/image_stats.cu",
        "replaces": "src/repro/kernels/image_complexity.py:66",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bd,
        "bound_by": by, "library_ms": None}


def _decode_case(b, h, kh, hd, t_cache, t_ctx, dtype, gen, *, fill=None,
                 dead_slot=False, window=None):
    """Dense-cache inputs: k/v (B, t_cache, K, hd), attended view t_ctx."""
    import torch

    q = _rand((b, 1, h, hd), dtype, gen)
    k = _rand((b, t_cache, kh, hd), dtype, gen)
    v = _rand((b, t_cache, kh, hd), dtype, gen)
    fill = t_ctx - 3 if fill is None else fill
    pos = torch.full((b, t_cache), -1, dtype=torch.int32, device="cuda")
    pos[:, :fill] = torch.arange(fill, dtype=torch.int32, device="cuda")
    pq = torch.full((b,), fill - 1, dtype=torch.int32, device="cuda")
    if dead_slot:
        pos[b - 1] = -1  # an empty slot: every entry masked
    return q, k, v, pq, pos, window


def check_decode_dense(records):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    cases = [
        # (label, b, h, kh, hd, t_cache, t_ctx, kwargs)
        ("edge", 4, 12, 2, 128, 512, 384, {}),
        ("cloud", 4, 28, 4, 128, 512, 384, {}),
        ("cloud all-masked slot", 4, 28, 4, 128, 512, 384,
         {"dead_slot": True}),
        ("hd32 reduced", 2, 4, 2, 32, 64, 48, {}),
        ("window 64", 2, 8, 2, 64, 256, 256, {"window": 64}),
        ("ragged T=97", 2, 4, 1, 128, 97, 97, {}),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, h, kh, hd, tc, tx, kw in cases:
            q, k, v, pq, pos, window = _decode_case(b, h, kh, hd, tc, tx,
                                                    dtype, gen, **kw)
            kv, vv, pv = k[:, :tx], v[:, :tx], pos[:, :tx]  # bucket view
            got = decode_attention_cuda(q, kv, vv, pq, pv, window=window)
            want = decode_attention_plain(q, kv, vv, pq, pv, window=window)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            t = tol[dtype]
            if not torch.allclose(got.float(), want.float(), rtol=t, atol=t):
                fail(f"decode_attention {label} {dtype}: max |err| {err}")
            if kw.get("dead_slot"):
                mean_v = vv[b - 1].float().mean(dim=0)  # (K, hd)
                row = got[b - 1, 0].float().reshape(kh, h // kh, hd)
                if not torch.allclose(row, mean_v[:, None].expand_as(row),
                                      rtol=t, atol=t):
                    fail("all-masked slot does not return mean(V)")
            if label == "cloud" and dtype == torch.bfloat16:
                worst = err
            print(f"  decode_attention {label} {str(dtype)[6:]}: max |err| "
                  f"{err:.3g} (tol {t})")
    # timing at the main path's shapes: both tiers, bf16, B=4, 384 of 512
    for label, h, kh in (("edge", 12, 2), ("cloud", 28, 4)):
        q, k, v, pq, pos, _ = _decode_case(4, h, kh, 128, 512, 384,
                                           torch.bfloat16, gen)
        kv, vv, pv = k[:, :384], v[:, :384], pos[:, :384]
        ms = cuda_time_ms(lambda: decode_attention_cuda(q, kv, vv, pq, pv))
        plain = cuda_time_ms(lambda: decode_attention_plain(q, kv, vv, pq, pv))
        dd = pq[:, None] - pv
        mask = ((pv >= 0) & (dd >= 0))[:, None, None, :]
        qs, ks, vs = q.transpose(1, 2), kv.transpose(1, 2), vv.transpose(1, 2)
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))
        b, t = 4, 384
        nbytes = 2 * b * t * kh * 128 * 2 + 2 * b * h * 128 * 2 + b * t * 4
        bd, by = bound_ms(nbytes, 4.0 * b * h * t * 128, "bfloat16")
        print(f"  decode_attention {label} B=4 T=384 bf16: kernel "
              f"{ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, sdpa "
              f"{lib * 1e3:.2f} us, bound {bd * 1e3:.3f} us ({by})")
        if label == "cloud":
            records["decode_attention"] = {
                "name": "decode_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:146",
                "max_abs_err": worst, "ms": ms, "plain_ms": plain,
                "bound_ms": bd, "bound_by": by, "library_ms": lib}


def _paged_case(b, h, kh, hd, page, n_pt, t_ctx, dtype, gen, *, window=None,
                dead_slot=False):
    """Paged inputs: a shuffled page table over a pool with a null page 0;
    each slot reserves only the pages its fill needs (tail entries map to
    the null page), and the attended width may end mid-page."""
    import torch

    n_pages = b * n_pt + 1
    kp = _rand((n_pages, page, kh, hd), dtype, gen)
    vp = _rand((n_pages, page, kh, hd), dtype, gen)
    q = _rand((b, 1, h, hd), dtype, gen)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(
        b * 1000 + t_ctx)) + 1
    pages = perm[:b * n_pt].reshape(b, n_pt).to(torch.int32)
    fill = t_ctx - 5
    used = -(-fill // page)
    pages[:, used:] = 0  # unreserved tail -> null page
    pages = pages.cuda()
    pos = torch.full((b, t_ctx), -1, dtype=torch.int32, device="cuda")
    pos[:, :fill] = torch.arange(fill, dtype=torch.int32, device="cuda")
    pq = torch.full((b,), fill - 1, dtype=torch.int32, device="cuda")
    if dead_slot:
        pos[b - 1] = -1
        pages[b - 1] = 0
    npg = -(-t_ctx // page)
    return q, kp, vp, pages[:, :npg], pq, pos, window


def check_decode_paged(records):
    import torch

    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_cuda, decode_attention_paged_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    cases = [
        # (label, b, h, kh, hd, page, n_pt, t_ctx, kwargs)
        ("edge", 4, 12, 2, 128, 64, 8, 384, {}),
        ("cloud", 4, 28, 4, 128, 64, 8, 384, {}),
        ("cloud partial page + dead slot", 4, 28, 4, 128, 64, 8, 300,
         {"dead_slot": True}),
        ("hd32 reduced", 2, 4, 2, 32, 16, 4, 48, {}),
        ("window 64", 2, 8, 2, 64, 64, 4, 256, {"window": 64}),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, h, kh, hd, page, n_pt, tx, kw in cases:
            q, kp, vp, pages, pq, pos, window = _paged_case(
                b, h, kh, hd, page, n_pt, tx, dtype, gen, **kw)
            got = decode_attention_paged_cuda(q, kp, vp, pages, pq, pos,
                                              window=window)
            want = decode_attention_paged_plain(q, kp, vp, pages, pq, pos,
                                                window=window)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            t = tol[dtype]
            if not torch.allclose(got.float(), want.float(), rtol=t, atol=t):
                fail(f"decode_attention_paged {label} {dtype}: max |err| "
                     f"{err}")
            if label == "cloud" and dtype == torch.bfloat16:
                worst = err
            print(f"  decode_attention_paged {label} {str(dtype)[6:]}: max "
                  f"|err| {err:.3g} (tol {t})")
    for label, h, kh in (("edge", 12, 2), ("cloud", 28, 4)):
        q, kp, vp, pages, pq, pos, _ = _paged_case(
            4, h, kh, 128, 64, 8, 384, torch.bfloat16, gen)
        ms = cuda_time_ms(lambda: decode_attention_paged_cuda(
            q, kp, vp, pages, pq, pos))
        plain = cuda_time_ms(lambda: decode_attention_paged_plain(
            q, kp, vp, pages, pq, pos))
        b, t = 4, 384
        nbytes = (2 * b * t * kh * 128 * 2 + 2 * b * h * 128 * 2 + b * t * 4
                  + pages.numel() * 4)
        bd, by = bound_ms(nbytes, 4.0 * b * h * t * 128, "bfloat16")
        print(f"  decode_attention_paged {label} B=4 T=384 bf16: kernel "
              f"{ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, bound "
              f"{bd * 1e3:.3f} us ({by})")
        if label == "cloud":
            records["decode_attention_paged"] = {
                "name": "decode_attention_paged", "route": "cuda",
                "source": "src/repro_torch/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:78",
                "max_abs_err": worst, "ms": ms, "plain_ms": plain,
                "bound_ms": bd, "bound_by": by, "library_ms": None}


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


def serve(engines, topo, n_requests: int, max_new: int, label: str):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.tiers import ClusterServer

    server = ClusterServer(engines, topology=topo)
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


def phase_serve_full(records):
    import torch

    from repro_torch.config import ServingConfig, get_topology
    from repro_torch.serving.tiers import build_cluster_engines

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sv = ServingConfig(max_batch=4, max_seq=512, paged=True, kv_page_size=64,
                       fused_steps=8)
    topo = get_topology("edge-cloud")
    engines = build_cluster_engines(topo, sv, dtype="bfloat16",
                                    device="cuda", full_width=True)
    torch.cuda.synchronize()
    print(f"  built full-width engines in {time.perf_counter() - t0:.1f}s")
    counts = serve(engines, topo, 8, 16, "paged full width")
    for name in ("image_stats", "decode_attention_paged"):
        if counts[name] <= 0:
            fail(f"paged serve never launched {name}")
        records[name]["launches"] = counts[name]
    # phase 5: the library-default dense pool on the same weights
    sv_dense = ServingConfig(max_batch=4, max_seq=512, paged=False,
                             fused_steps=8)
    from repro_torch.serving.engine import TierEngine

    dense = {name: TierEngine(e.model, e.params, sv_dense)
             for name, e in engines.items()}
    del engines
    counts = serve(dense, topo, 2, 16, "dense full width")
    if counts["decode_attention"] <= 0:
        fail("dense serve never launched decode_attention")
    records["decode_attention"]["launches"] = counts["decode_attention"]
    del dense
    torch.cuda.empty_cache()


def phase_impl_parity():
    """Reduced f32 engines: the kernel and the plain version decode the
    same tokens, paged and dense."""
    import numpy as np
    import torch

    from repro_torch.config import ServingConfig
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced_config("qwen2-vl-2b").replace(dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(4, cfg.vocab_size, n).astype(np.int32),
                rng.standard_normal((cfg.num_patches, cfg.frontend_dim))
                .astype(np.float32)) for n in (9, 21, 40)]
    for paged in (True, False):
        toks = {}
        for impl in ("cuda", "torch"):
            sv = ServingConfig(max_batch=4, max_seq=128, paged=paged,
                               kv_page_size=16, decode_impl=impl)
            eng = TierEngine(model, params, sv)
            for rid, (p, patches) in enumerate(prompts):
                eng.submit(rid, p, max_new=12, extras={"patches": patches})
            toks[impl] = {s.rid: s.generated for s in eng.run_until_drained()}
        if toks["cuda"] != toks["torch"]:
            fail(f"paged={paged}: cuda {toks['cuda']} != torch "
                 f"{toks['torch']}")
        print(f"  reduced f32 paged={paged}: cuda and torch decode the same "
              f"{sum(len(t) for t in toks['cuda'].values())} tokens")


def phase_launcher():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--requests", "4", "--max-new", "4"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines()[:6]:
        print(f"  | {line}")
    if proc.returncode != 0:
        fail(f"launcher exit {proc.returncode}:\n{proc.stderr[-3000:]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
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
    if 4 in phases or 5 in phases:
        if 3 not in phases:
            fail("phases 4-5 record launches into phase 3's kernel records")
        print("phase 4-5: full-width serving (paged, then dense)")
        phase_serve_full(records)
    if 6 in phases:
        print("phase 6: reduced f32, cuda vs torch decode")
        phase_impl_parity()
    if 7 in phases:
        print("phase 7: launcher")
        phase_launcher()
    print(f"total {time.perf_counter() - t0:.1f}s")
    if records:
        for rec in records.values():
            rec.setdefault("launches", 0)
        order = ("name", "route", "source", "replaces", "launches",
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")
        print(json.dumps({"kernels": [{k: rec[k] for k in order}
                                      for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
