"""The JAX package's results, recorded on the CPU, and the port held to them.

Run as a script, this file records the reference into
``tests/data/jax_reference.json`` and ``tests/data/jax_reference.npz``:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_reference_record.py --write

(without ``--write`` it records afresh and reports whether the bytes equal
the committed files). JAX is needed for that only: ``repro_torch.replay``
reads the record with numpy and replays it through the port, on the card in
``chip_smoke.py`` phase 15 and on the CPU in the tests below.

What is recorded:

* (a) each Pallas kernel through the reference's own wrappers in interpret
  mode (``repro/kernels/ops.py``) on numpy-seeded inputs, f32 and bf16
  (inputs drawn in f32 and cast in each package; both round to nearest
  even): image statistics on 8-bit ``make_image`` images and a flat one;
  dense and paged decode at hd 32/64/128, groups 1/2/4, a window, a ragged
  context and a fully masked slot (whose XLA output is recorded beside the
  kernel's); flash at S 64 and 128 (block-aligned, as the Pallas kernel
  needs), hd 32/64/128, causal, bidirectional and windowed, and hd 192/256
  (the reference pads both to 256) on one head, causal and windowed;
* (b) every arch of ``ALL_ARCHS``, reduced, in f32, on a JAX ``TierEngine``
  (``attn_impl="auto"``, the default decode) paged and dense, fused 1 and
  8 steps, over weights drawn by numpy (``convert.draw_params``) to the
  statistics of JAX's own init: the greedy tokens and JAX's top-2 logit
  margin at each token. Prompts are chosen by a rule on JAX's margins alone
  (``MARGIN_RULE``);
* (c) an edge-cloud ``ClusterServer`` (reduced qwen2-vl-2b / qwen2.5-vl-7b,
  paged, 64-row pages, ``adaptive_tau=False``) over four requests of the
  launcher's image mix with explicit token ids (the toy tokenizer's salted
  ``hash`` would make ids differ between processes): routes, tier, tokens;
* (d) one slot each of reduced qwen2-vl-2b and mamba2-2.7b extracted from a
  JAX paged engine after 5 of 12 tokens (``SlotPayload.to_bytes()``) and
  the tokens that engine then finishes with.
"""
import argparse
import io
import json
import os
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _path_str  # noqa: E402
from repro.config import PolicyConfig as JPolicyConfig  # noqa: E402
from repro.config import ServingConfig as JServingConfig  # noqa: E402
from repro.config import get_topology as j_topology  # noqa: E402
from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core.baselines import make_policy as j_make_policy  # noqa: E402
from repro.core.scheduler import MoAOffScheduler as JScheduler  # noqa: E402
from repro.data.synthetic import make_image  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.attention import (decode_attention_paged_xla,  # noqa: E402
                                    decode_attention_xla)
from repro.serving.engine import TierEngine as JTierEngine  # noqa: E402
from repro.serving.tiers import ClusterServer as JClusterServer  # noqa: E402
from repro_torch import replay  # noqa: E402
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    tree_flatten_with_path)
from repro_torch.convert import draw_params  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the rule prompts are chosen by, on JAX's margins alone: the first prompt
#: seed from 0 whose every generated token (both per-token variants) has a
#: top-2 logit margin of at least ``min_margin`` and whose four variants
#: agree
MARGIN_RULE = {"min_margin": 1e-4, "first_seed": 0, "max_seeds": 64}

# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _attention_cases():
    """Flash: B=1, S 64/128 (one Pallas block), hd 32/64/128, groups 1-2,
    and hd 192/256 on one head;
    dense and paged decode: hd 32/64/128, groups 1/2/4, a window, a ragged
    paged context (40 rows in three 16-row pages) and fully masked slots."""
    flash = [  # (s, hd, h, kh, causal, window)
        (64, 32, 2, 1, True, None), (128, 32, 1, 1, False, None),
        (64, 64, 2, 1, False, None), (128, 64, 1, 1, True, None),
        (64, 128, 2, 1, True, None), (128, 128, 1, 1, False, None),
        (128, 32, 2, 1, True, 48)]
    dense = [  # (b, t, hd, h, kh, fill, window)
        (2, 48, 32, 2, 2, [48, 30], None),
        (3, 100, 64, 4, 2, [100, 57, 0], None),
        (2, 64, 128, 4, 1, [64, 21], None),
        (2, 80, 32, 8, 2, [80, 70], 24)]
    paged = [  # (b, t, hd, h, kh, fill, window), 16-row pages
        (3, 40, 32, 2, 2, [40, 17, 0], None),
        (2, 64, 64, 4, 2, [64, 33], None),
        (2, 48, 128, 4, 1, [48, 48], 20)]
    cases = []
    for dtype in ("float32", "bfloat16"):
        for s, hd, h, kh, causal, window in flash:
            mode = "window" if window else ("causal" if causal else "bidir")
            cases.append({"id": f"flash/{dtype}/s{s}_hd{hd}_g{h // kh}_{mode}",
                          "kernel": "flash_attention", "dtype": dtype, "b": 1,
                          "s": s, "hd": hd, "h": h, "kh": kh,
                          "causal": causal, "window": window})
        for kind, rows in (("decode_attention", dense),
                           ("decode_attention_paged", paged)):
            for b, t, hd, h, kh, fill, window in rows:
                case = {"id": f"{kind}/{dtype}/t{t}_hd{hd}_g{h // kh}"
                              + (f"_w{window}" if window else ""),
                        "kernel": kind, "dtype": dtype, "b": b, "t": t,
                        "hd": hd, "h": h, "kh": kh, "fill": fill,
                        "window": window}
                if kind == "decode_attention_paged":
                    case["page"] = 16
                cases.append(case)
    # the head dims of the warp-specialised bf16 flash kernel (one head: the
    # record stays under its 1 MiB cap), appended so that the seeds above
    # keep their cases
    wide = [  # (dtype, s, hd, causal, window)
        ("bfloat16", 128, 192, True, None), ("bfloat16", 128, 192, True, 48),
        ("bfloat16", 128, 256, True, None), ("bfloat16", 128, 256, True, 48),
        ("float32", 64, 192, True, None), ("float32", 64, 256, True, 40)]
    for dtype, s, hd, causal, window in wide:
        mode = "window" if window else "causal"
        cases.append({"id": f"flash/{dtype}/s{s}_hd{hd}_g1_{mode}",
                      "kernel": "flash_attention", "dtype": dtype, "b": 1,
                      "s": s, "hd": hd, "h": 1, "kh": 1, "causal": causal,
                      "window": window})
    for i, case in enumerate(cases):
        case["seed"] = 100 + i
    return cases


IMAGE_CASES = [
    {"id": "image/make64", "kernel": "image_stats", "image": "make_image",
     "shape": [2, 64, 64], "seed": 1, "content": [0.2, 0.8]},
    {"id": "image/make256", "kernel": "image_stats", "image": "make_image",
     "shape": [1, 256, 256], "seed": 2, "content": [0.35]},
    {"id": "image/flat64", "kernel": "image_stats", "image": "flat",
     "shape": [1, 64, 64], "level": 128.0},
]

#: four requests, three slots (a refill), lengths across buckets; 40 passes
#: the hybrid's reduced local window of 32, so its ring wraps
ENGINE_JOBS = [{"rid": 0, "len": 7, "max_new": 10, "patches": True},
               {"rid": 1, "len": 19, "max_new": 10, "patches": True},
               {"rid": 2, "len": 40, "max_new": 10, "patches": False},
               {"rid": 3, "len": 12, "max_new": 10, "patches": False}]
ENGINE_SERVING = {"max_batch": 3, "max_seq": 64, "kv_page_size": 16}

CLUSTER = {"topology": "edge-cloud", "seed": 8, "lengths": [12, 40, 25, 60],
           "sentence_rate": [0.4, 0.35, 0.3, 0.0], "max_new": 6, "eos_id": -1,
           "serving": {"max_batch": 4, "max_seq": 128, "paged": True,
                       "kv_page_size": 64}}

WIRE_ARCHS = ("qwen2-vl-2b", "mamba2-2.7b")
WIRE_JOBS = [{"rid": 0, "len": 11, "max_new": 12, "patches": True},
             {"rid": 1, "len": 23, "max_new": 12, "patches": True}]
WIRE_AFTER = 5  # tokens the slot has when it is extracted

# ---------------------------------------------------------------------------
# JAX side
# ---------------------------------------------------------------------------


def _stored(x) -> np.ndarray:
    """A JAX output as the record stores it: f32, or bf16 as its bits."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a.astype(np.float32)


def _jax_in(x: np.ndarray, dtype):
    a = jnp.asarray(x)
    return a.astype(dtype) if a.dtype == jnp.float32 else a


def _pallas_paged(q, k_pool, v_pool, pages, pos_q, pos_cache, *, window):
    """What ``decode_attention_pallas_paged`` computes, through the Pallas
    kernel body it runs: its ``_paged_kernel`` is the dense ``_kernel`` over
    the pool's pages in page-table order, one page a block, with pos_cache
    padded by -1 to whole pages. Its own ``pallas_call`` does not trace
    under jax 0.9 (its index maps take the scalar-prefetch page table
    first; Pallas passes it after the grid indices), so the dense wrapper
    runs here over the page-ordered gather with ``block_t`` = the page."""
    b, n_p = pages.shape
    page = k_pool.shape[1]
    k_ctx = k_pool[pages].reshape(b, n_p * page, *k_pool.shape[2:])
    v_ctx = v_pool[pages].reshape(b, n_p * page, *v_pool.shape[2:])
    pos = jnp.pad(pos_cache, ((0, 0), (0, n_p * page - pos_cache.shape[1])),
                  constant_values=-1)
    return jops.decode_attention(q, k_ctx, v_ctx, pos_q, pos, window=window,
                                 block_t=page, interpret=True)


def jax_kernel(case, inputs):
    """The reference's wrapper (interpret mode) on a case's inputs:
    ``{array suffix: stored output}``."""
    kind = case["kernel"]
    if kind == "image_stats":
        out = jops.image_stats(jnp.asarray(inputs["imgs"]), interpret=True)
        return {k: np.asarray(out[k], np.float32)
                for k in replay.IMAGE_SUMS + ("hist",)}
    dt = jnp.dtype(case["dtype"])
    x = {k: _jax_in(v, dt) for k, v in inputs.items()}
    if kind == "flash_attention":
        return {"out": _stored(jops.flash_attention(
            x["q"], x["k"], x["v"], causal=case["causal"],
            window=case["window"], interpret=True))}
    if kind == "decode_attention":
        args = (x["q"], x["k"], x["v"], x["pos_q"], x["pos_cache"])
        out = {"out": _stored(jops.decode_attention(
            *args, window=case["window"], interpret=True))}
        xla = decode_attention_xla
    else:
        args = (x["q"], x["k"], x["v"], x["pages"], x["pos_q"],
                x["pos_cache"])
        out = {"out": _stored(_pallas_paged(*args, window=case["window"]))}
        xla = decode_attention_paged_xla
    if 0 in case["fill"]:  # a fully masked slot: the XLA oracle beside
        out["xla"] = _stored(xla(*args, window=case["window"]))
    return out


def _8bit(img: np.ndarray) -> np.ndarray:
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _image_input(case):
    rng = np.random.default_rng(case["seed"])
    _, h, w = case["shape"]
    return _8bit(np.stack([make_image(rng, u, h, w)
                           for u in case["content"]]))


def leaf_specs(tree):
    """The JAX init's leaves, in flatten order, by checkpointer name, with
    the statistics ``draw_params`` scales to."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf, np.float64)
        out.append({"name": _path_str(path), "shape": list(a.shape),
                    "mean": float(a.mean()), "std": float(a.std()),
                    "min": float(a.min()), "max": float(a.max())})
    return out


def jax_model(arch, rec):
    """The reduced f32 JAX model of ``arch`` with the record's drawn weights
    (``draw_params`` fed through ``tree_unflatten`` on the init's treedef)."""
    jm = j_build(j_reduced(arch).replace(dtype="float32"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    drawn = draw_params(rec["leaves"], rec["seed"])
    leaves = []
    for path, _ in paths:
        node = drawn
        for key in _path_str(path).split("."):
            node = node[key]
        leaves.append(jnp.asarray(node))
    return jm, jax.tree_util.tree_unflatten(treedef, leaves)


def _capture_margins(eng):
    """Record JAX's top-2 logit margin at each host-sampled token of ``eng``
    (every token on the per-token path), by rid."""
    margins, pending = {}, []
    sample = eng._sample

    def _sample(logits):
        top = np.sort(np.asarray(logits, np.float64))[-2:]
        pending.append(float(top[1] - top[0]))
        return sample(logits)

    def on_token(rid, tok, now):
        if pending:
            margins.setdefault(str(rid), []).append(pending.pop())

    eng._sample = _sample
    eng.on_token = on_token
    return margins


def jax_engine(jm, jp, case, variant):
    """``({rid: tokens}, {rid: margins} or None)`` of one JAX engine run."""
    paged, fused = replay.VARIANTS[variant]
    eng = JTierEngine(jm, jp, JServingConfig(
        **case["serving"], paged=paged, fused_steps=fused),
        eos_id=case["eos_id"])
    margins = _capture_margins(eng) if fused == 1 else None
    for rid, toks, max_new, extras in replay.engine_jobs(case, jm.cfg):
        eng.submit(rid, toks, max_new=max_new, extras=extras)
    toks = {str(s.rid): list(s.generated) for s in eng.run_until_drained()}
    return toks, margins


def record_engine(arch, rec):
    """The arch's engine case: the first prompt seed that meets
    ``MARGIN_RULE``, its tokens under every variant and its margins."""
    jm, jp = jax_model(arch, rec)
    for seed in range(MARGIN_RULE["first_seed"], MARGIN_RULE["max_seeds"]):
        case = {"arch": arch, "prompt_seed": seed, "jobs": ENGINE_JOBS,
                "serving": ENGINE_SERVING, "eos_id": -1}
        case["inputs_sha256"] = replay.digest(*replay.jobs_arrays(
            replay.engine_jobs(case, jm.cfg)))
        runs = {v: jax_engine(jm, jp, case, v) for v in replay.VARIANTS}
        toks = [runs[v][0] for v in replay.VARIANTS]
        margins = runs["dense-f1"][1]
        low = min(min(m) for v in ("dense-f1", "paged-f1")
                  for m in runs[v][1].values())
        if all(t == toks[0] for t in toks) and low >= MARGIN_RULE[
                "min_margin"]:
            case["tokens"] = {v: runs[v][0] for v in replay.VARIANTS}
            case["margins"] = {rid: [float(f"{x:.4g}") for x in m]
                               for rid, m in sorted(margins.items())}
            case["min_margin"] = float(f"{low:.4g}")
            return case
    raise RuntimeError(f"{arch}: no prompt seed meets {MARGIN_RULE}")


def cluster_requests():
    """The cluster case's requests: the launcher's image mix (a Beta(1.6,
    1.6) content level a 64x64 ``make_image``, 8-bit) and explicit token
    ids inside the reduced vocabulary: 4-511 count as entities, and a share
    of them is replaced by 3 (a sentence end), which sets the request's
    entities a sentence and so its text score."""
    rng = np.random.default_rng(CLUSTER["seed"])
    images, reqs = [], []
    for n, rate in zip(CLUSTER["lengths"], CLUSTER["sentence_rate"]):
        u = rng.beta(1.6, 1.6)
        images.append(_8bit(make_image(rng, u, 64, 64)))
        ids = rng.integers(4, 512, n)
        ids[rng.random(n) < rate] = 3
        reqs.append({"ids": ids.astype(int).tolist(),
                     "max_new": CLUSTER["max_new"]})
    return images, reqs


def record_cluster(params):
    images, reqs = cluster_requests()
    topo = j_topology(CLUSTER["topology"])
    engines = {}
    for tier in topo.tiers:
        jm, jp = jax_model(tier.model, params[tier.model])
        engines[tier.name] = JTierEngine(jm, jp, JServingConfig(
            **CLUSTER["serving"]), eos_id=CLUSTER["eos_id"])
    server = JClusterServer(engines, topology=topo, scheduler=JScheduler(
        policy=j_make_policy("moa-off", JPolicyConfig(adaptive_tau=False),
                             topology=topo)))
    for img, req in zip(images, reqs):
        server.submit_request(server.build_request(
            "", image=img.astype(np.float32), max_new=req["max_new"],
            prompt_ids=np.asarray(req["ids"], np.int32)))
    results = {str(r.rid): {"routes": dict(r.routes), "tier": r.tier,
                            "tokens": list(r.tokens)}
               for r in server.run(timeout_s=600.0)}
    failed = [r.rid for r in server.results if r.failed]
    if failed:
        raise RuntimeError(f"cluster requests {failed} failed")
    case = {k: CLUSTER[k] for k in ("topology", "eos_id", "serving")}
    case.update(requests=reqs, results=results)
    return case, {f"cluster/image{i}": img for i, img in enumerate(images)}


def record_wire(arch, rec):
    """One slot of ``arch`` extracted from a JAX paged engine (per-token
    steps) after ``WIRE_AFTER`` tokens, and the tokens it finishes with."""
    jm, jp = jax_model(arch, rec)
    case = {"arch": arch, "prompt_seed": 0, "jobs": WIRE_JOBS,
            "serving": ENGINE_SERVING, "eos_id": -1, "rid": 1,
            "after": WIRE_AFTER}
    eng = JTierEngine(jm, jp, JServingConfig(**ENGINE_SERVING, paged=True,
                                             fused_steps=1),
                      eos_id=case["eos_id"])
    for rid, toks, max_new, extras in replay.engine_jobs(case, jm.cfg):
        eng.submit(rid, toks, max_new=max_new, extras=extras)

    def generated():
        return next((len(s.generated) for s in eng.slots
                     if s is not None and s.rid == case["rid"]), 0)

    while generated() < WIRE_AFTER:
        eng.step()
    for st in eng.slots:  # host clock readings: the bytes hold no time
        if st is not None:
            st.t_submit = st.t_first_token = 0.0
    wire = eng.extract_slot(case["rid"]).to_bytes()
    done = {s.rid: list(s.generated) for s in eng.run_until_drained()}
    case["tokens"] = done[case["rid"]]
    case["nbytes"] = len(wire)
    return case, np.frombuffer(wire, np.uint8).copy()


def record():
    """``(meta, arrays)``: the whole record, computed afresh."""
    meta = {"written_by": "PYTHONPATH=src JAX_PLATFORMS=cpu python "
                          "tests/test_torch_reference_record.py --write",
            "versions": {"jax": jax.__version__, "numpy": np.__version__},
            "margin_rule": MARGIN_RULE, "kernels": [], "params": {},
            "engines": [], "wire": []}
    arrays = {}
    for case in IMAGE_CASES + _attention_cases():
        case = dict(case)
        if case.get("image") == "make_image":
            arrays[case["id"] + "/imgs"] = _image_input(case)
        inputs = replay.kernel_inputs(case, arrays)
        case["inputs_sha256"] = replay.digest(
            *(inputs[k] for k in sorted(inputs)))
        for suffix, out in jax_kernel(case, inputs).items():
            arrays[f"{case['id']}/{suffix}"] = out
        meta["kernels"].append(case)
    for i, arch in enumerate(ALL_ARCHS):
        jm = j_build(j_reduced(arch).replace(dtype="float32"))
        rec = {"seed": 1000 + i,
               "leaves": leaf_specs(jm.init(jax.random.PRNGKey(0)))}
        drawn = draw_params(rec["leaves"], rec["seed"])
        rec["sha256"] = replay.digest(*(leaf for _, leaf in
                                        tree_flatten_with_path(drawn)))
        meta["params"][arch] = rec
    for arch in ALL_ARCHS:
        meta["engines"].append(record_engine(arch, meta["params"][arch]))
    meta["cluster"], images = record_cluster(meta["params"])
    arrays.update(images)
    for arch in WIRE_ARCHS:
        case, wire = record_wire(arch, meta["params"][arch])
        meta["wire"].append(case)
        arrays[f"wire/{arch}"] = wire
    return meta, arrays


def _npz_bytes(arrays) -> bytes:
    """The arrays as an ``.npz`` whose bytes depend on nothing but them
    (sorted names, a fixed timestamp; ``np.savez`` stamps the clock)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name in sorted(arrays):
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0,
                                                             0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            npy = io.BytesIO()
            np.lib.format.write_array(npy, np.ascontiguousarray(
                arrays[name]), allow_pickle=False)
            zf.writestr(info, npy.getvalue())
    return buf.getvalue()


def _json_bytes(meta) -> bytes:
    return (json.dumps(meta, indent=1, sort_keys=True) + "\n").encode()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="write the record into tests/data (default: "
                         "compare a fresh record with the committed one)")
    args = ap.parse_args(argv)
    meta, arrays = record()
    files = {replay.RECORD_JSON: _json_bytes(meta),
             replay.RECORD_NPZ: _npz_bytes(arrays)}
    same = True
    for rel, data in files.items():
        path = os.path.join(ROOT, rel)
        if args.write:
            with open(path, "wb") as f:
                f.write(data)
            print(f"wrote {rel}: {len(data)} bytes")
        else:
            old = open(path, "rb").read() if os.path.exists(path) else b""
            same &= old == data
            print(f"{rel}: {len(data)} bytes, "
                  f"{'equal to' if old == data else 'DIFFERS from'} the "
                  f"committed file")
    return 0 if same else 1


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

_HAVE = os.path.exists(os.path.join(ROOT, replay.RECORD_JSON))
_META = replay.load(ROOT)[0] if _HAVE else {
    "kernels": [], "engines": [], "wire": [], "params": {}}
_KERNELS = {c["id"]: c for c in _META["kernels"]}
_ENGINES = {c["arch"]: c for c in _META["engines"]}
_WIRES = {c["arch"]: c for c in _META["wire"]}


@pytest.fixture(scope="module")
def record_arrays():
    return replay.load(ROOT)[1]


@pytest.fixture(scope="module")
def port_models():
    """``arch -> (model, params)`` on the CPU, built once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = (replay.build(arch, "cpu"),
                           replay.params_for(_META, arch, "cpu"))
        return cache[arch]

    return get


def test_record_is_small_complete_and_meets_its_margin_rule():
    sizes = [os.path.getsize(os.path.join(ROOT, p))
             for p in (replay.RECORD_JSON, replay.RECORD_NPZ)]
    assert sum(sizes) < 1 << 20, sizes
    assert sorted(_ENGINES) == sorted(ALL_ARCHS)
    assert sorted(_META["params"]) == sorted(ALL_ARCHS)
    for case in _META["engines"]:
        assert sorted(case["tokens"]) == sorted(replay.VARIANTS)
        assert case["min_margin"] >= _META["margin_rule"]["min_margin"]
        assert all(case["tokens"][v] == case["tokens"]["dense-f1"]
                   for v in replay.VARIANTS)
    kinds = {c["kernel"] for c in _META["kernels"]}
    assert kinds == {"image_stats", "flash_attention", "decode_attention",
                     "decode_attention_paged"}
    assert sorted(_WIRES) == sorted(WIRE_ARCHS)
    assert len(_META["cluster"]["results"]) == 4


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_draw_params_repeats_bitwise_in_jax_layout(arch):
    """``draw_params`` gives the same bits twice, the names and shapes of
    JAX's ``model.init``, and constant leaves exactly constant."""
    rec = _META["params"][arch]
    one, two = (draw_params(rec["leaves"], rec["seed"]) for _ in range(2))
    flat1, flat2 = (tree_flatten_with_path(t) for t in (one, two))
    assert [p for p, _ in flat1] == [p for p, _ in flat2]
    assert all(np.array_equal(a, b) and a.dtype == np.float32
               for (_, a), (_, b) in zip(flat1, flat2))
    jm = j_build(j_reduced(arch).replace(dtype="float32"))
    shapes = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))[0]
    assert [(_path_str(p), tuple(s.shape)) for p, s in shapes] == [
        (".".join(p), a.shape) for p, a in flat1]
    for spec, (_, leaf) in zip(rec["leaves"], flat1):
        if spec["std"] == 0.0:
            assert np.all(leaf == np.float32(spec["mean"])), spec["name"]
        else:
            assert spec["min"] <= leaf.min() and leaf.max() <= spec["max"]
    assert replay.digest(*(a for _, a in flat1)) == rec["sha256"]


@pytest.mark.parametrize("cid", sorted(_KERNELS))
def test_port_cpu_holds_kernel_case(cid, record_arrays):
    """The port's plain versions against the recorded Pallas outputs, at
    tests/test_kernels.py's tolerances (histogram exact; fully masked decode
    slots held to the recorded XLA output)."""
    case = _KERNELS[cid]
    got = replay.run_kernel(case, replay.kernel_inputs(case, record_arrays),
                            "cpu")
    _, bad = replay.hold_kernel(case, got, record_arrays)
    assert not bad, bad


@pytest.mark.parametrize("variant", sorted(replay.VARIANTS))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_port_cpu_holds_engine_tokens(arch, variant, port_models):
    case = _ENGINES[arch]
    model, params = port_models(arch)
    got = replay.run_engine(case, variant, model, params, "cpu")
    miss = replay.first_mismatch(got, case["tokens"][variant],
                                 case["margins"])
    assert miss is None, f"{arch} {variant}: {miss}"


def test_port_cpu_holds_cluster_routes_tiers_and_tokens(record_arrays):
    got = replay.run_cluster(_META, record_arrays, "cpu")
    want = _META["cluster"]["results"]
    assert sorted(got) == sorted(int(r) for r in want)
    for rid, r in got.items():
        w = want[str(rid)]
        assert not r["failed"]
        assert (r["routes"], r["tier"], r["tokens"]) == (
            w["routes"], w["tier"], w["tokens"]), rid


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", WIRE_ARCHS)
def test_port_cpu_finishes_recorded_jax_slot(arch, paged, record_arrays):
    case = _WIRES[arch]
    toks, prefilled = replay.run_wire(_META, record_arrays, case, paged,
                                      "cpu")
    assert toks == case["tokens"] and len(toks) == 12
    assert prefilled == 0


def _close_to_record(fresh, want):
    """A fresh JAX output against the recorded one: equal but for the last
    bit of a float (f32 1e-6, bf16 one unit in the last place)."""
    if want.dtype == np.uint16:
        a = (fresh.astype(np.uint32) << 16).view(np.float32)
        b = (want.astype(np.uint32) << 16).view(np.float32)
        return np.allclose(a, b, rtol=2 ** -7, atol=2 ** -7)
    return np.allclose(fresh, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cid", sorted(_KERNELS))
def test_fresh_jax_run_reproduces_kernel_case(cid, record_arrays):
    case = _KERNELS[cid]
    inputs = replay.kernel_inputs(case, record_arrays)
    assert replay.digest(*(inputs[k] for k in sorted(inputs))) == case[
        "inputs_sha256"]
    for suffix, out in jax_kernel(case, inputs).items():
        want = record_arrays[f"{cid}/{suffix}"]
        assert out.dtype == want.dtype and out.shape == want.shape
        assert _close_to_record(out, want), suffix


@pytest.mark.parametrize("arch", [
    a if a == "qwen2-vl-2b" else pytest.param(a, marks=pytest.mark.slow)
    for a in ALL_ARCHS])
def test_fresh_jax_run_reproduces_engine_tokens(arch):
    """JAX's four engine variants decode the recorded tokens again, with the
    recorded margins (to 1e-3 of their size, the record keeps 4 digits)."""
    case = _ENGINES[arch]
    jm, jp = jax_model(arch, _META["params"][arch])
    for variant in replay.VARIANTS:
        toks, margins = jax_engine(jm, jp, case, variant)
        assert toks == case["tokens"][variant], variant
        if variant == "dense-f1":
            for rid, m in case["margins"].items():
                np.testing.assert_allclose(margins[rid], m, rtol=1e-3,
                                           atol=1e-6)


if __name__ == "__main__":
    sys.exit(main())
