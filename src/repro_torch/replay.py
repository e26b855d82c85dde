"""Replay the JAX package's recorded results through the port.

``tests/data/jax_reference.json`` and ``tests/data/jax_reference.npz`` hold
what the JAX package computed on the CPU, written by
``tests/test_torch_reference_record.py --write``:

* ``kernels``: each Pallas kernel's output through the reference's own
  wrappers (interpret mode) on seeded inputs, f32 and bf16; for a fully
  masked decode slot also the XLA oracle's output;
* ``engines``: the greedy tokens of a ``TierEngine`` for every arch of the
  zoo (reduced, f32; paged and dense, fused 1 and 8 steps) over weights
  drawn by numpy (``convert.draw_params``), with JAX's top-2 logit margin
  at each token;
* ``cluster``: the routes, tier and tokens of an edge-cloud
  ``ClusterServer`` over four image requests with explicit token ids;
* ``wire``: slots extracted from a JAX paged engine mid-decode
  (``SlotPayload.to_bytes()``) and the tokens that engine finished with.

This module rebuilds every input from the record's seeds with numpy alone
and runs each case through the port on a device: on a CUDA device through
the hand kernels (``attn_impl`` and ``decode_impl`` "cuda"), on the CPU
through their plain versions ("torch"). It imports neither JAX nor the JAX
package; ``chip_smoke.py`` (phase 15) and the CPU tests both call it.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: the record's files, relative to a checkout's root
RECORD_JSON = os.path.join("tests", "data", "jax_reference.json")
RECORD_NPZ = os.path.join("tests", "data", "jax_reference.npz")

#: tests/test_kernels.py's tolerances (rtol = atol): f32 attention as in
#: ``test_flash_attention_shapes``, bf16 as in ``test_flash_attention_dtypes``
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: ``test_image_stats_matches_ref``'s sums; the histogram is held exactly
IMAGE_RTOL, IMAGE_ATOL = 2e-5, 1e-3
IMAGE_SUMS = ("sobel_sum", "lap_sum", "lap_sq_sum")

#: the engine variants each arch is recorded under: (paged, fused_steps)
VARIANTS = {"dense-f1": (False, 1), "dense-f8": (False, 8),
            "paged-f1": (True, 1), "paged-f8": (True, 8)}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load(root: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """The record under checkout ``root``: (its JSON, its npz arrays)."""
    with open(os.path.join(root, RECORD_JSON)) as f:
        meta = json.load(f)
    with np.load(os.path.join(root, RECORD_NPZ)) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return meta, arrays


def digest(*arrays: np.ndarray) -> str:
    """sha256 of the arrays' bytes, in order: the record stores it for the
    inputs it drew, so a replay can show it drew the same ones."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _check_digest(what: str, want: str, *arrays: np.ndarray) -> None:
    got = digest(*arrays)
    if got != want:
        raise ValueError(f"{what}: this numpy draws other inputs than the "
                         f"recorder's (sha256 {got[:16]} != {want[:16]})")


def impl_for(device) -> str:
    """The prefill and decode impl a device replays under: the kernels on
    the card, their plain versions on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


# ---------------------------------------------------------------------------
# (a) kernels
# ---------------------------------------------------------------------------


def kernel_inputs(case: Dict[str, Any],
                  arrays: Optional[Dict[str, np.ndarray]] = None
                  ) -> Dict[str, np.ndarray]:
    """A kernel case's numpy inputs, from its seed (attention: float32, to be
    cast to the case's dtype in each package) or, for images, from the
    record (8-bit images, so no float drawn on another machine's numpy
    enters the histogram); checked against the recorded digest."""
    inputs = _kernel_inputs(case, arrays)
    if "inputs_sha256" in case:
        _check_digest(case["id"], case["inputs_sha256"],
                      *(inputs[k] for k in sorted(inputs)))
    return inputs


def _kernel_inputs(case, arrays):
    kind = case["kernel"]
    if kind == "image_stats":
        if case["image"] == "flat":
            b, h, w = case["shape"]
            return {"imgs": np.full((b, h, w), case["level"], np.float32)}
        return {"imgs": arrays[case["id"] + "/imgs"].astype(np.float32)}
    rng = np.random.default_rng(case["seed"])
    hd, h, kh, b = case["hd"], case["h"], case["kh"], case["b"]

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if kind == "flash_attention":
        s = case["s"]
        return {"q": normal(b, s, h, hd), "k": normal(b, s, kh, hd),
                "v": normal(b, s, kh, hd)}
    t, fill = case["t"], case["fill"]
    pos_cache = np.full((b, t), -1, np.int32)
    for i, n in enumerate(fill):
        pos_cache[i, :n] = np.arange(n)
    pos_q = np.asarray([max(n - 1, 0) for n in fill], np.int32)
    out = {"q": normal(b, 1, h, hd), "pos_q": pos_q, "pos_cache": pos_cache}
    if kind == "decode_attention":
        out.update(k=normal(b, t, kh, hd), v=normal(b, t, kh, hd))
        return out
    page = case["page"]
    n_p = -(-t // page)
    out.update(k=normal(1 + b * n_p, page, kh, hd),
               v=normal(1 + b * n_p, page, kh, hd),
               pages=(1 + rng.permutation(b * n_p)).reshape(b, n_p)
               .astype(np.int32))
    return out


def _tensor(x: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    t = torch.as_tensor(x, device=device)
    return t.to(dtype) if t.is_floating_point() else t


def run_kernel(case: Dict[str, Any], inputs: Dict[str, np.ndarray],
               device) -> Dict[str, np.ndarray]:
    """The port's wrapper on the case's inputs on ``device`` (the kernel on a
    CUDA device, its plain version on the CPU), as float32 numpy."""
    from repro_torch.kernels import ops

    kind = case["kernel"]
    if kind == "image_stats":
        out = ops.image_stats(_tensor(inputs["imgs"], device, torch.float32))
        return {k: out[k].float().cpu().numpy()
                for k in IMAGE_SUMS + ("hist",)}
    dt = _DTYPES[case["dtype"]]
    x = {k: _tensor(v, device, dt) for k, v in inputs.items()}
    if kind == "flash_attention":
        out = ops.flash_attention(x["q"], x["k"], x["v"],
                                  causal=case["causal"],
                                  window=case["window"])
    elif kind == "decode_attention":
        out = ops.decode_attention(x["q"], x["k"], x["v"], x["pos_q"],
                                   x["pos_cache"], window=case["window"])
    else:
        out = ops.decode_attention_paged(x["q"], x["k"], x["v"], x["pages"],
                                         x["pos_q"], x["pos_cache"],
                                         window=case["window"])
    return {"out": out.float().cpu().numpy()}


def recorded(arrays: Dict[str, np.ndarray], key: str) -> np.ndarray:
    """A recorded output as float32 (bf16 is stored as its bit pattern)."""
    a = arrays[key]
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def hold_kernel(case: Dict[str, Any], got: Dict[str, np.ndarray],
                arrays: Dict[str, np.ndarray]) -> Tuple[float, List[str]]:
    """(largest error, failures) at tests/test_kernels.py's tolerances: for
    attention the largest |got - recorded|, for image statistics the largest
    relative error of the three sums (the histogram must be equal). A fully
    masked decode slot (``fill`` 0) is held to the XLA oracle's recorded
    output, which the port follows by design (the Pallas kernels average
    such a row over their padded tails)."""
    cid, bad, worst = case["id"], [], 0.0
    if case["kernel"] == "image_stats":
        for k in IMAGE_SUMS:
            want = recorded(arrays, f"{cid}/{k}")
            worst = max(worst, float((np.abs(got[k] - want)
                                      / np.maximum(np.abs(want), 1.0)).max()))
            if not np.allclose(got[k], want, rtol=IMAGE_RTOL,
                               atol=IMAGE_ATOL):
                bad.append(f"{cid} {k}: {got[k]} != {want}")
        want = recorded(arrays, f"{cid}/hist")
        if not np.array_equal(got["hist"], want):
            bad.append(f"{cid} hist: differs in "
                       f"{int((got['hist'] != want).sum())} bins")
        return worst, bad
    want = recorded(arrays, f"{cid}/out")
    masked = [i for i, n in enumerate(case.get("fill", ())) if n == 0]
    if masked:
        want = want.copy()
        want[masked] = recorded(arrays, f"{cid}/xla")[masked]
    tol = ATTN_TOL[case["dtype"]]
    err = np.abs(got["out"] - want)
    worst = float(err.max())
    if not np.all(err <= tol + tol * np.abs(want)):
        bad.append(f"{cid}: max |err| {worst:.3g} above rtol = atol = {tol}"
                   + (f" (slots {masked} held to XLA)" if masked else ""))
    return worst, bad


# ---------------------------------------------------------------------------
# (b)-(d) models
# ---------------------------------------------------------------------------


def reduced_cfg(arch: str):
    from repro_torch.configs import reduced_config

    return reduced_config(arch).replace(dtype="float32")


def params_for(meta: Dict[str, Any], arch: str, device) -> Dict[str, Any]:
    """The arch's recorded weights (drawn from the record's seed and leaf
    specs) as port parameters on ``device``."""
    from repro_torch.convert import draw_params, params_from_numpy

    rec = meta["params"][arch]
    tree = draw_params(rec["leaves"], rec["seed"])
    leaves = []
    for spec in rec["leaves"]:
        node = tree
        for key in spec["name"].split("."):
            node = node[key]
        leaves.append(node)
    _check_digest(f"{arch} weights", rec["sha256"], *leaves)
    return params_from_numpy(tree, device)


def build(arch: str, device):
    """The reduced f32 model of ``arch`` under ``device``'s impl."""
    from repro_torch.models import build_model

    return build_model(reduced_cfg(arch), attn_impl=impl_for(device),
                       device=device)


def engine_jobs(case: Dict[str, Any], cfg) -> List[tuple]:
    """``[(rid, tokens, max_new, extras)]`` of an engine case, drawn from its
    prompt seed: ids inside the vocabulary, patches on the jobs that ask for
    them (vision frontends), frames on every job of an encoder-decoder."""
    rng = np.random.default_rng(case["prompt_seed"])
    out = []
    for job in case["jobs"]:
        toks = rng.integers(4, cfg.vocab_size, job["len"]).astype(np.int32)
        extras = {}
        if cfg.frontend == "vision_stub" and job.get("patches"):
            extras["patches"] = rng.standard_normal(
                (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        if cfg.family == "encdec":
            extras["frames"] = rng.standard_normal(
                (cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
        out.append((job["rid"], toks, job["max_new"], extras))
    return out


def jobs_arrays(jobs) -> List[np.ndarray]:
    return [a for _, toks, _, extras in jobs
            for a in (toks, *(extras[k] for k in sorted(extras)))]


def serving_for(serving: Dict[str, Any], device, **kw):
    from repro_torch.config import ServingConfig

    return ServingConfig(**{**serving, **kw}, decode_impl=impl_for(device))


def run_engine(case: Dict[str, Any], variant: str, model, params,
               device) -> Dict[int, List[int]]:
    """One engine case under one variant: ``{rid: greedy tokens}``."""
    from repro_torch.serving.engine import TierEngine

    paged, fused = VARIANTS[variant]
    jobs = engine_jobs(case, model.cfg)
    _check_digest(f"{case['arch']} prompts", case["inputs_sha256"],
                  *jobs_arrays(jobs))
    eng = TierEngine(model, params, serving_for(
        case["serving"], device, paged=paged, fused_steps=fused),
        eos_id=case["eos_id"])
    for rid, toks, max_new, extras in jobs:
        eng.submit(rid, toks, max_new=max_new, extras=extras)
    return {s.rid: list(s.generated) for s in eng.run_until_drained()}


def first_mismatch(got: Dict[int, List[int]], want: Dict[str, List[int]],
                   margins: Dict[str, List[float]]) -> Optional[str]:
    """None if ``got`` equals the recorded tokens, else where they part:
    the request, the step and JAX's top-2 margin there (a near-tie tells a
    rounding difference from a fault)."""
    for rid in sorted(want, key=int):
        g, w = got.get(int(rid)), want[rid]
        if g == w:
            continue
        if g is None:
            return f"rid {rid} never finished"
        step = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                    min(len(g), len(w)))
        m = margins.get(rid, [])
        margin = f"{m[step]:.3g}" if step < len(m) else "not recorded"
        return (f"rid {rid} step {step}: port {g[step:step + 4]} != JAX "
                f"{w[step:step + 4]} (JAX margin there {margin})")
    extra = sorted(set(got) - {int(r) for r in want})
    return f"unrecorded rids {extra}" if extra else None


def run_cluster(meta: Dict[str, Any], arrays: Dict[str, np.ndarray],
                device) -> Dict[int, Dict[str, Any]]:
    """The recorded edge-cloud cluster case on ``device`` (the image score
    through the fused kernel on the card): ``{rid: {routes, tier,
    tokens}}``."""
    from repro_torch.config import PolicyConfig, get_topology
    from repro_torch.core.baselines import make_policy
    from repro_torch.core.scheduler import MoAOffScheduler
    from repro_torch.serving.engine import TierEngine
    from repro_torch.serving.tiers import ClusterServer

    case = meta["cluster"]
    topo = get_topology(case["topology"])
    engines = {}
    for tier in topo.tiers:
        engines[tier.name] = TierEngine(
            build(tier.model, device), params_for(meta, tier.model, device),
            serving_for(case["serving"], device), eos_id=case["eos_id"])
    server = ClusterServer(engines, topology=topo, scheduler=MoAOffScheduler(
        policy=make_policy("moa-off", PolicyConfig(adaptive_tau=False),
                           topology=topo),
        use_kernel=torch.device(device).type == "cuda"))
    for i, req in enumerate(case["requests"]):
        img = arrays[f"cluster/image{i}"].astype(np.float32)
        ids = np.asarray(req["ids"], np.int32)
        server.submit_request(server.build_request(
            "", image=img, max_new=req["max_new"], prompt_ids=ids))
    results = server.run(timeout_s=600.0)
    server.close()
    return {r.rid: {"routes": dict(r.routes), "tier": r.tier,
                    "tokens": list(r.tokens), "failed": r.failed}
            for r in results}


def run_wire(meta: Dict[str, Any], arrays: Dict[str, np.ndarray],
             case: Dict[str, Any], paged: bool, device
             ) -> Tuple[List[int], int]:
    """A recorded JAX slot injected into a fresh port engine (paged or
    dense) on ``device`` and decoded to its end: (its tokens, the engine's
    prefill tokens, which must stay 0)."""
    from repro_torch.serving.engine import SlotPayload, TierEngine

    arch = case["arch"]
    eng = TierEngine(build(arch, device), params_for(meta, arch, device),
                     serving_for(case["serving"], device, paged=paged),
                     eos_id=case["eos_id"])
    wire = arrays[f"wire/{arch}"].tobytes()
    eng.inject_slot(SlotPayload.from_bytes(wire))
    done = {s.rid: list(s.generated) for s in eng.run_until_drained()}
    return done[case["rid"]], eng.prefill_tokens
