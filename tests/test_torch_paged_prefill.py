"""The paged prefill (``DecoderLM.prefill_paged`` under
``TierEngine._prefill_pages``): each layer's K/V goes into the group's
reserved pages as the layer computes it, with no whole-model K/V and no
capacity-wide copy. Held here, on the CPU in float32:

* the pool it writes equals, bit for bit, what the capacity-wide path
  (``prefill`` + the scatter through the page tables) writes: every page
  but the null page, ``pos``, ``index``, the page tables and the logits; on
  a GQA Qwen-shaped and an MHA hd-96 Phi-shaped reduced model, with a
  padded row, rows crossing page boundaries, a row longer than its
  reservation and rows reserving different page counts;
* a pool smaller than ``max_batch`` full sequences serves the tokens of an
  unpressured one, counting its page waits (``page_waits``,
  ``page_wait_s``) and recording them as ``engine.page_wait`` spans;
* a prefill budget (``prefill_positions``) splits groups without changing
  a token.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.config import ServingConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import (TierEngine, _at,  # noqa: E402
                                        _get, _named_leaves)
from repro_torch.serving.paged import pages_needed  # noqa: E402

PAGE = 16
SHAPES = {
    # GQA: 4 query heads over 2 KV heads of 32
    "qwen2-vl-2b": lambda: reduced_config("qwen2-vl-2b"),
    # MHA at Phi-3-Vision's head size
    "phi-3-vision-4.2b": lambda: dataclasses.replace(
        reduced_config("phi-3-vision-4.2b"), head_dim=96),
}


def _engine(cfg, params=None, **serving):
    model = build_model(cfg.replace(dtype="float32"), attn_impl="torch",
                        device="cpu")
    sv = dict(max_batch=4, max_seq=128, paged=True, kv_page_size=PAGE,
              fused_steps=4)
    sv.update(serving)
    return TierEngine(model, model.init(0) if params is None else params,
                      ServingConfig(**sv), eos_id=-1)


def _capacity_copy(eng, batch, slots, total, pt_rows, npg):
    """The capacity-wide path the paged prefill replaced: the whole
    model's K/V padded to ``max_seq``, then scattered through the tables."""
    logits, cache1 = eng.model.prefill(eng.params, batch, eng.serving.max_seq)
    slots_d = torch.as_tensor(slots).long()
    total_d = torch.as_tensor(total)
    cap = cache1["pos"].shape[1]
    cache1["pos"] = torch.where(cache1["pos"] < total_d[:, None],
                                cache1["pos"], -1)
    cache1["index"] = (torch.clamp(total_d, max=cap) % cap).to(torch.int32)
    for name, one in _named_leaves(cache1):
        pool = _get(eng.cache, name)
        bax = eng._axis_by_name[name][0]
        if name not in eng._paged_names:
            pool[_at(bax, slots_d)] = one.to(pool.dtype)
            continue
        one = one.reshape(one.shape[:bax + 1] + (eng._n_pt, PAGE)
                          + one.shape[bax + 2:])
        pt_sl = torch.as_tensor(pt_rows[:, :npg]).long()
        pool[_at(bax, pt_sl)] = one[_at(bax + 1, slice(0, npg))].to(
            pool.dtype)
    eng.cache["pages"][slots_d] = torch.as_tensor(pt_rows)
    return logits


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_paged_prefill_writes_the_capacity_copys_pages_bit_for_bit(shape):
    cfg = SHAPES[shape]()
    a = _engine(cfg)
    b = _engine(cfg, params=a.params)
    rng = np.random.default_rng(3)
    # every page starts as the same garbage in both pools
    for name in a._paged_names:
        junk = torch.as_tensor(rng.normal(size=tuple(_get(
            a.cache, name).shape)).astype(np.float32))
        _get(a.cache, name).copy_(junk)
        _get(b.cache, name).copy_(junk)
    prefix, bucket = cfg.num_patches, 32
    lengths = np.array([5, 23, 32, 5], np.int32)  # the last row pads row 0
    max_new = [2, 60, 10]
    toks = rng.integers(3, cfg.vocab_size, (4, bucket)).astype(np.int32)
    toks[3] = toks[0]
    for i, n in enumerate(lengths):
        toks[i, n:] = 0
    patches = rng.normal(size=(3, prefix, cfg.frontend_dim)).astype(
        np.float32)
    batch = {"tokens": torch.as_tensor(toks),
             "lengths": torch.as_tensor(lengths),
             "patches": torch.as_tensor(np.concatenate([patches,
                                                        patches[:1]]))}
    total = lengths + prefix
    slots = [0, 1, 2]
    for eng in (a, b):
        for slot, n in zip(slots, max_new):
            need = pages_needed(int(total[slot]) + n, PAGE, 128)
            eng._assign_pages(slot, eng._reserve_pages(need))
    # one page (shorter than the prompt), six (past it), four
    assert [len(a._slot_pages[s]) for s in slots] == [1, 6, 4]
    slots_arr = np.asarray(slots + [0], np.int32)
    pt_rows = a._pt[slots_arr]
    npg = 6
    with torch.no_grad():
        got = a._prefill_insert(batch, slots_arr, total, pt_rows, npg)
        want = _capacity_copy(b, batch, slots_arr, total, pt_rows, npg)
    assert torch.equal(got, want)
    for name, leaf in _named_leaves(a.cache):
        other = _get(b.cache, name)
        if name in a._paged_names:
            # page 0 is the null page: its content is garbage either way
            leaf, other = leaf[:, 1:], other[:, 1:]
        assert torch.equal(leaf, other), name


def _jobs(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        toks = rng.integers(3, cfg.vocab_size, int(rng.integers(6, 50)))
        patches = rng.normal(size=(cfg.num_patches, cfg.frontend_dim))
        out.append((rid, toks.astype(np.int32), int(rng.integers(4, 40)),
                    {"patches": patches.astype(np.float32)}))
    return out


def _serve(eng, jobs):
    for rid, toks, max_new, extras in jobs:
        eng.submit(rid, toks, max_new=max_new, extras=extras)
    return {s.rid: list(s.generated) for s in eng.run_until_drained()}


def test_a_pool_smaller_than_full_sequences_serves_the_same_tokens():
    cfg = SHAPES["qwen2-vl-2b"]()
    jobs = _jobs(cfg, 8)
    free = _engine(cfg)
    want = _serve(free, jobs)
    assert free.page_waits == 0
    # 12 pages where 4 slots of full sequences would take 32; a request
    # reserves 2-7
    small = _engine(cfg, params=free.params, kv_pool_pages=12)
    small.tier = "cloud"
    tracing.clear()
    tracing.enable()
    try:
        got = _serve(small, jobs)
    finally:
        tracing.disable()
    spans = tracing.records()
    tracing.clear()
    assert got == want
    assert small.page_waits > 0 and small.page_wait_s > 0
    small.pool.check()
    assert small.pool.pages_used == 0
    waits = [s for s in spans if s.name == "engine.page_wait"]
    assert len(waits) == small.page_waits
    assert all(s.tier == "cloud" and s.parent == 0 and s.t1_ns >= s.t0_ns
               for s in waits)
    assert sum(s.t1_ns - s.t0_ns for s in waits) / 1e9 == pytest.approx(
        small.page_wait_s, rel=1e-3, abs=1e-4)
    blocks = [s for s in spans if s.name == "engine.decode_block"]
    assert blocks and all(s.attrs["pool_pages"] == 12
                          and 0 < s.attrs["pages_used"] <= 12
                          for s in blocks)
    groups = [s for s in spans if s.name == "engine.prefill_group"]
    assert sorted(r[0] for s in groups for r in s.attrs["rows"]) == list(
        range(len(jobs)))
    for s in groups:
        assert s.attrs["kv_pages"] == sum(
            pages_needed(cfg.num_patches + r[1] + jobs[r[0]][2], PAGE, 128)
            for r in s.attrs["rows"])


def test_a_prefill_budget_splits_groups_and_keeps_the_tokens():
    cfg = SHAPES["phi-3-vision-4.2b"]()
    jobs = _jobs(cfg, 6, seed=8)
    free = _engine(cfg)
    free.prefill_positions = 0  # unbounded
    want = _serve(free, jobs)
    cut = _engine(cfg, params=free.params)
    # every prompt here pads to a 16-, 32- or 64-token bucket
    cut.prefill_positions = 2 * (cfg.num_patches + 64)
    tracing.clear()
    tracing.enable()
    try:
        got = _serve(cut, jobs)
    finally:
        tracing.disable()
    groups = [s for s in tracing.records()
              if s.name == "engine.prefill_group"]
    tracing.clear()
    assert got == want
    assert all(s.attrs["rows_padded"] * (cfg.num_patches + s.attrs["bucket"])
               <= cut.prefill_positions for s in groups)
    assert cut._group_rows(cfg.num_patches + 64) == 2
    assert free._group_rows(cfg.num_patches + 64) == 4
