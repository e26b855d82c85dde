"""The paged prefill and the page-budget admission against the benchmark's
own yardsticks, on the CPU at reduced sizes in float32:

* a group prefilled straight into the pool's pages, then decoded by the
  fused block (no graphs on the CPU) through those pages, gives the float32
  reference's logits (``moabench/reference/model.py``'s full forward), on
  a GQA Qwen-shaped and an MHA hd-96 Phi-shaped tier;
* a reduced run of ``phi3v-describe-poisson`` whose cloud pool holds fewer
  pages than its slots' full sequences comes out correct, its requests
  having waited for pages;
* the same run with one layer's K/V written to the wrong pages, or with
  half of a block's slots given another slot's tokens, comes out not
  correct.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from moabench import arch, run, spec, testing
from moabench.reference import model as ref_model

CELL = "phi3v-describe-poisson"
SEED = 2 ** 31 + 2509


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tier_arch(tier: int, **over):
    """Tier ``tier`` of the cell's configuration at the tests' size."""
    m = dict(spec.config(spec.cell(CELL)["config"])["tiers"][tier]["model"],
             **testing.SMALL_MODEL)
    m.update(tie_word_embeddings=False, vocab_size=500, **over)
    return arch.arch(m)


SHAPES = {"qwen-gqa": lambda: _tier_arch(0),
          "phi-mha-hd96": lambda: _tier_arch(1, num_key_value_heads=4,
                                             head_dim=96)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_paged_prefill_and_fused_decode_give_the_reference_logits(shape):
    from repro_torch.config import ServingConfig
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    a = SHAPES[shape]()
    w = arch.make_weights(a, 17, 1, "float32", "cpu")
    model = build_model(arch.model_config(a, "float32"), attn_impl="torch",
                        device="cpu")
    eng = TierEngine(model, w, ServingConfig(
        max_batch=4, max_seq=128, paged=True, kv_page_size=16,
        fused_steps=4), eos_id=-1)
    seen = {"prefill": [], "decode": []}
    prefill, decode = eng.model.prefill_paged, eng.model.decode_step

    def prefill_seen(*args, **kw):
        out = prefill(*args, **kw)
        seen["prefill"].append(out.clone())
        return out

    def decode_seen(*args, **kw):
        logits, cache = decode(*args, **kw)
        seen["decode"].append(logits.clone())
        return logits, cache
    eng.model.prefill_paged, eng.model.decode_step = prefill_seen, decode_seen
    rng = np.random.default_rng(4)
    reqs = []
    # one 32-token bucket: three padded rows (and a pad row), each
    # crossing 16-row pages after the 16 image rows
    for rid, (n, max_new) in enumerate(((17, 6), (21, 9), (30, 3))):
        img = rng.uniform(0, 255, (7 + rid, 11)).astype(np.float32)
        ids = rng.integers(3, a.vocab, n).astype(np.int32)
        eng.submit(rid, ids, max_new=max_new, extras={
            "patches": ref_model.stub_patches(img, a.patches,
                                              a.frontend_dim)})
        reqs.append((ids, img, max_new))
    with torch.no_grad():
        done = {s.rid: s.generated for s in eng.run_until_drained()}
    assert len(seen["prefill"]) == 1  # the three rows prefilled as a group
    seqs = []
    for rid, (ids, img, max_new) in enumerate(reqs):
        toks = done[rid]
        assert len(toks) == max_new
        first = a.patches + len(ids) - 1
        seqs.append({"ids": np.r_[ids, toks[:-1]], "image": img,
                     "rows": np.arange(first, first + max_new)})
    ref = ref_model.logits_at(a, w, seqs, "cpu")
    steps = torch.stack(seen["decode"])  # (steps, B, V)
    for rid, lg in enumerate(ref):
        torch.testing.assert_close(seen["prefill"][0][rid], lg[0],
                                   rtol=1e-4, atol=1e-4)
        # slot rid decoded its j-th token at fused step j - 1
        torch.testing.assert_close(steps[:len(lg) - 1, rid], lg[1:],
                                   rtol=1e-4, atol=1e-4)


def _pressured():
    """The cell's configuration at the tests' size with 8 slots of 1024
    rows, its cloud pool cut to 16 pages of 64 rows, one full sequence,
    where its slots' full sequences take 128 (a request here reserves
    1-16, 4 on average)."""
    cfg = testing.small_config(CELL, max_batch=8)
    cfg["serving"]["max_seq"] = 1024
    cfg["tiers"][1]["serving"] = {"kv_pool_pages": 16}
    return cfg


def _run(before_window=None, rate=4.0):
    engines = {}

    def keep(built):
        engines.update(built.engines)
        if before_window is not None:
            before_window(built)
    # a warm-up burst of 12 requests at once puts the cloud's pool under
    # pressure; the drain ends as soon as the window's requests resolve
    res = run.run_cell(CELL, SEED, 1.0, False, device="cpu", rate=rate,
                       cfg_override=_pressured(),
                       params_override=dict(
                           testing.SMALL_TRAFFIC, drain_s=60.0,
                           warm={"requests": 12, "spread_s": 0.0},
                           output={"dist": "uniform", "min": 24, "max": 48}),
                       before_window=keep, log=lambda s: None)
    return res, engines


def test_a_pressured_cloud_pool_runs_correct():
    res, engines = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    cloud = engines["cloud"]
    assert cloud.pool.num_pages == 16 and cloud.page_waits > 0


def _wrong_pages(monkeypatch, built):
    """Layer 1's K and V land one page further on (the next page of the
    row's table, the next row's at its end), everything else as the
    program writes it."""
    from repro_torch.models import transformer

    write = transformer.write_pages
    calls = []

    def wrong(pool, at, rows):
        calls.append(1)
        if len(calls) % 4 in (3, 0):  # the third and fourth of a prefill
            at = dict(at, dst=at["dst"].roll(pool.shape[1]))
        write(pool, at, rows)
    monkeypatch.setattr(transformer, "write_pages", wrong)


def _half_batch(monkeypatch, built):
    """The second half of a block's live slots get the first live slot's
    tokens (``test_moabench_runs.py``'s fault, which runs this cell at its
    own rate, where a CPU window's blocks hold one live slot)."""
    for eng in built.engines.values():
        fused = eng._fused

        def broken(tokens, positions, budgets, teff, k, rids, _f=fused):
            out = _f(tokens, positions, budgets, teff, k, rids).copy()
            live = np.flatnonzero(np.asarray(budgets) > 0)
            for i in live[(len(live) + 1) // 2:]:
                out[i] = out[live[0]]
            return out
        monkeypatch.setattr(eng, "_fused", broken)


@pytest.mark.parametrize("fault", ["wrong_pages", "half_batch"])
def test_a_broken_pressured_run_is_not_correct(monkeypatch, fault):
    plant = {"wrong_pages": _wrong_pages, "half_batch": _half_batch}[fault]
    res, _ = _run(lambda built: plant(monkeypatch, built), rate=8.0)
    assert res["correct"] is False, res["checks"]
