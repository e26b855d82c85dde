"""The fused decode block as CUDA graphs (``TierEngine._fused_static``),
and the extents its step hands a paged pool's decode attention.

On the card, each step of the block of a family whose cache writes by
absolute position is one CUDA graph per context bucket, captured at the
bucket's second use and replayed k times; the ssm and hybrid families, and
every engine on the CPU, run the block eagerly. The cases marked ``gpu`` hold a graphed engine to an eager one
(the same engine class with its graphs turned off through its private
state) on the same requests and operations at reduced qwen2-vl widths in
bf16, paged and dense, at temperature 0 and 0.7: tokens, ``pos``,
``index``, the page tables and every K/V leaf equal after each step,
through a slot that dies mid-block on its budget, a block split under page
pressure, context buckets that change between blocks, an admission
between blocks, ``inject_slot`` and ``restore`` before a replay. On the
CPU the same scenario runs with a stand-in for the graph that replays the
captured step against the tensors its capture saw, as a graph reads the
addresses it captured, so a graph kept over replaced storage shows here.

A paged engine's step hands the decode attention each slot's extent
(index + 1 for a live slot, 0 for a dead one), so the paged graphed and
eager cases run with extents. The extent cases: the tokens, positions and
tables of a paged engine with extents equal those with them off (CPU f32,
and on the card), at reduced qwen2-vl and a Phi-3-Vision-shaped hd-96 MHA
model; the engine's row counters against a hand count; and, on the card,
the paged kernel with extents against its plain version at the cells'
(hd, group) pairs and a lean instance, replayed from a graph with other
extents.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import ServingConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MAX_SPLIT_ROWS, PLAN_MIN_ROWS, decode_attention_paged_cuda,
    decode_attention_paged_plain, decode_attention_split_plain,
    lean_instance, plan_blocks, plan_split_rows, resident_blocks)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import (TierEngine, _named_leaves,  # noqa: E402
                                        _tree_map)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class _Replay:
    """A CPU stand-in for one captured step: a replay runs the step against
    the cache and parameter tensors the capture saw."""

    def __init__(self, eng, ctx):
        self.eng, self.ctx = eng, ctx
        self.cache = _tree_map(lambda t: t, eng.cache)
        self.params = eng.params

    def replay(self):
        eng = self.eng
        live = eng.cache, eng.params
        eng.cache, eng.params = self.cache, self.params
        try:
            eng._static_step(self.ctx)
        finally:
            eng.cache, eng.params = live


def _stand_in_graphs(monkeypatch, eng):
    """Turn ``eng``'s graph path on with :class:`_Replay` for the capture."""

    def capture(ctx):
        eng.decode_graph_captures += 1
        return _Replay(eng, ctx), {}

    eng._graph_ok = True
    monkeypatch.setattr(eng, "_capture", capture)
    monkeypatch.setattr(eng, "_side_stream", contextlib.nullcontext)


#: the reduced models: the Qwen edge's, and a Phi-3-Vision-shaped MHA one at
#: the cell's head dim (4 heads of 96 over 4 KV heads)
ARCHS = {"qwen2-vl-2b": ("qwen2-vl-2b", {}),
         "phi-3-vision hd96": ("phi-3-vision-4.2b", {"head_dim": 96})}


def _model(device, dtype, arch="qwen2-vl-2b"):
    name, widths = ARCHS[arch]
    cfg = reduced_config(name).replace(dtype=dtype, **widths)
    attn = "cuda" if device.type == "cuda" else "auto"
    model = build_model(cfg, attn_impl=attn, device=device)
    return model, model.init(0)


def _serving(paged):
    # 12 pages of 16 rows hold rids 0-2's budgets (2 + 5 + 5 pages), so rid 3
    # waits and the blocks split at rid 0's end (page pressure)
    return ServingConfig(max_batch=4, max_seq=128, fused_steps=4,
                         paged=paged, kv_page_size=16, kv_pool_pages=12)


def _state(eng):
    """Every slot's tokens and every cache leaf, on the host."""
    toks = {s.rid: list(s.generated) for s in eng.slots if s is not None}
    toks.update({s.rid: list(s.generated) for s in eng.finished})
    return toks, _tree_map(lambda t: t.detach().to("cpu", copy=True),
                           eng.cache)


def _drive(eng):
    """The scenario; the state after each step. rid 0 (budget 1 after its
    first token) dies in its first block; rid 2 carries patches, so the
    context bucket grows from 64 to 96 while it decodes; rid 4 arrives
    between blocks; rid 1 is extracted and injected back between blocks;
    the engine then returns to a snapshot and drains."""
    cfg = eng.cfg
    rng = np.random.default_rng(7)
    prompt = lambda n: rng.integers(4, cfg.vocab_size, n).astype(np.int32)
    patches = rng.standard_normal((cfg.num_patches, cfg.frontend_dim)
                                  ).astype(np.float32)
    eng.submit(0, prompt(30), max_new=2)
    eng.submit(1, prompt(20), max_new=60)
    eng.submit(2, prompt(40), max_new=20, extras={"patches": patches})
    eng.submit(3, prompt(12), max_new=16)
    states = []

    def steps(n):
        for _ in range(n):
            eng.step()
            states.append(_state(eng))

    steps(3)
    snap = eng.snapshot()
    steps(2)
    eng.submit(4, prompt(9), max_new=12)
    steps(2)
    eng.inject_slot(eng.extract_slot(1, remove=True))
    steps(2)
    eng.restore(snap)
    while eng.waiting or any(s is not None for s in eng.slots):
        steps(1)
    return states


def _tokens_and_tables(states):
    """Each step's tokens, ``pos``, ``index`` and page tables: what a paged
    block with extents must leave as one without them does (the K/V rows a
    dead slot writes, never read, may differ)."""
    keep = ("['pos']", "['index']", "['pages']")
    return [(toks, {name: t for name, t in _named_leaves(cache)
                    if name in keep}) for toks, cache in states]


def _without_extents(monkeypatch):
    """Drop the extents the engine's step hands the model's paged decode
    dispatcher, so the kernel attends every row of the bucket (the control
    the extent cases compare against)."""
    real = attn_mod.decode_attention_paged

    def every_row(*args, lens=None, **kw):
        return real(*args, **kw)

    monkeypatch.setattr(attn_mod, "decode_attention_paged", every_row)


def _assert_same(got, want):
    assert len(got) == len(want)
    for (toks, cache), (toks0, cache0) in zip(got, want):
        assert toks == toks0
        for (name, a), (_, b) in zip(_named_leaves(cache),
                                     _named_leaves(cache0)):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_cpu_and_recurrent_blocks_run_eagerly(arch):
    """On the CPU every family's block runs eagerly, and the ssm/hybrid
    families never take the graph path: their steps count as eager."""
    cfg = reduced_config(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    eng = TierEngine(model, model.init(0),
                     ServingConfig(max_batch=2, max_seq=64, fused_steps=4),
                     eos_id=-1)
    assert not eng._graph_ok
    for rid in range(3):
        eng.submit(rid, np.arange(4, 14 + 3 * rid, dtype=np.int32),
                   max_new=6 + rid)
    blocks = []
    real = eng._fused

    def count(*args):
        blocks.append(args[4])
        return real(*args)

    eng._fused = count
    eng.run_until_drained()
    assert eng.decode_graph_steps == 0 and eng.decode_graph_captures == 0
    assert eng.decode_eager_steps == sum(blocks) > 0


@pytest.mark.parametrize("temp", [0.0, 0.7])
@pytest.mark.parametrize("paged", [False, True])
def test_graph_keys_and_invalidation_on_the_cpu(monkeypatch, paged, temp):
    """The graph path's bookkeeping, with a stand-in replay that reads the
    storage its capture saw: the same tokens and cache as the eager block
    at every step; a bucket's first step eager, its second captured; every
    graph dropped and captured again after ``restore`` replaced the
    cache."""
    model, params = _model(torch.device("cpu"), "float32")
    want = _drive(TierEngine(model, params, _serving(paged), eos_id=-1,
                             sample_temp=temp, seed=3))
    eng = TierEngine(model, params, _serving(paged), eos_id=-1,
                     sample_temp=temp, seed=3)
    _stand_in_graphs(monkeypatch, eng)
    blocks = []
    real = eng._fused

    def record(*args):
        blocks.append(args[3:5])  # (teff, k)
        return real(*args)

    eng._fused = record
    got = _drive(eng)
    _assert_same(got, want)
    teffs = {teff for teff, _ in blocks}
    assert len(teffs) >= 2  # the bucket changes between blocks
    # each bucket captured once before the restore, the ones used after it
    # once more; every other step a replay
    assert len(teffs) < eng.decode_graph_captures <= 2 * len(teffs)
    assert eng.decode_graph_steps > eng.decode_eager_steps > 0
    assert eng.decode_graph_steps + eng.decode_eager_steps == sum(
        k for _, k in blocks)
    assert 1 in {k for _, k in blocks} or not paged  # a split block


def test_replays_count_the_launches_their_capture_recorded():
    """A capture's wrapper calls are taken back out of the counters and
    counted again on every replay."""
    wrapper = ops.decode_attention_paged
    ops.reset_launches()
    before = ops.launch_counts()
    wrapper.launches += 2
    wrapper.by_shape[(32, 2)] = 2
    taken = ops.take_launches_since(before)
    assert taken == {"decode_attention_paged": (2, {(32, 2): 2})}
    assert ops.launches()["decode_attention_paged"] == 0
    assert ops.launches_by_shape()["decode_attention_paged"] == {}
    for _ in range(3):
        ops.add_launches(taken)
    assert ops.launches()["decode_attention_paged"] == 6
    assert ops.launches_by_shape()["decode_attention_paged"] == {(32, 2): 6}
    ops.reset_launches()


@pytest.mark.gpu
@pytest.mark.parametrize("temp", [0.0, 0.7])
@pytest.mark.parametrize("paged", [False, True])
def test_graphed_block_equals_eager_on_the_card(cuda, paged, temp):
    """A graphed engine against an eager one on the card, bf16 at reduced
    qwen2-vl widths: equal tokens, ``pos``, ``index``, page tables and K/V
    after every step of the scenario; the same kernel launches counted;
    graphs replayed, and captured again after ``restore``."""
    model, params = _model(cuda, "bfloat16")
    eager = TierEngine(model, params, _serving(paged), eos_id=-1,
                       sample_temp=temp, seed=3)
    eager._graph_ok = False
    ops.reset_launches()
    want = _drive(eager)
    want_launches = ops.launches_by_shape()
    eng = TierEngine(model, params, _serving(paged), eos_id=-1,
                     sample_temp=temp, seed=3)
    assert eng._graph_ok
    ops.reset_launches()
    got = _drive(eng)
    _assert_same(got, want)
    assert ops.launches_by_shape() == want_launches
    assert eager.decode_graph_steps == 0
    assert eng.decode_graph_steps > eng.decode_eager_steps > 0
    assert eng.decode_graph_captures >= 3


@pytest.mark.gpu
def test_a_dropped_graphed_engine_frees_its_memory(cuda):
    """An engine's graphs, their pool and its block state go with it, the
    cycle collector off: once a first engine has warmed the device's
    capture stream (its library workspaces live as long as the process), a
    second engine's graphed run leaves the allocated bytes as it found
    them."""
    import gc

    model, params = _model(cuda, "bfloat16")

    def run():
        eng = TierEngine(model, params, _serving(True), eos_id=-1)
        _drive(eng)
        assert eng.decode_graph_steps > 0

    run()
    torch.cuda.synchronize()
    gc.disable()
    try:
        held = torch.cuda.memory_allocated()
        run()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == held
    finally:
        gc.enable()


@pytest.mark.parametrize("temp", [0.0, 0.7])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_extents_keep_the_tokens(monkeypatch, arch, temp):
    """A paged engine whose fused step hands attention each slot's extent
    (index + 1 live, 0 dead) against the same engine with extents off, on
    the CPU in f32 through the scenario (a slot dying in its first block,
    a bucket change, an admission, extract and inject, a restore): the same
    tokens, ``pos``, ``index`` and page tables after every step."""
    model, params = _model(torch.device("cpu"), "float32", arch)
    off = TierEngine(model, params, _serving(True), eos_id=-1,
                     sample_temp=temp, seed=3)
    with monkeypatch.context() as m:
        _without_extents(m)
        want = _tokens_and_tables(_drive(off))
    eng = TierEngine(model, params, _serving(True), eos_id=-1,
                     sample_temp=temp, seed=3)
    calls = []
    real = ops.decode_attention_paged

    def seen(*args, lens=None, **kw):
        calls.append(lens is not None and bool((lens == 0).any()))
        return real(*args, lens=lens, **kw)

    monkeypatch.setattr(ops, "decode_attention_paged", seen)
    got = _tokens_and_tables(_drive(eng))
    assert any(calls)  # extents were passed, a dead slot's 0 among them
    assert len(got) == len(want)
    for (toks, tables), (toks0, tables0) in zip(got, want):
        assert toks == toks0
        for name, t in tables.items():
            assert torch.equal(t, tables0[name]), name


def test_decode_rows_counters_count_one_block():
    """``decode_rows_live`` / ``decode_rows_grid`` and the block span's
    ``rows_live`` / ``rows_grid``, hand-counted for one block of 4 steps:
    a slot at position 10 with 2 tokens of budget attends 11 + 12 rows, one
    at 20 with 9 attends 21 + 22 + 23 + 24; the grid is 4 slots x the
    32-row bucket x 4 steps."""
    from repro_torch import tracing

    model, params = _model(torch.device("cpu"), "float32")
    eng = TierEngine(model, params, ServingConfig(
        max_batch=4, max_seq=128, fused_steps=4, paged=True,
        kv_page_size=16), eos_id=-1)
    eng.submit(0, np.arange(4, 14, dtype=np.int32), max_new=3)
    eng.submit(1, np.arange(4, 24, dtype=np.int32), max_new=10)
    tracing.clear()
    tracing.enable()
    try:
        eng.step()
    finally:
        tracing.disable()
    live, grid = (11 + 12) + (21 + 22 + 23 + 24), 4 * 32 * 4
    assert (eng.decode_rows_live, eng.decode_rows_grid) == (live, grid)
    block = [sp for sp in tracing.records() if sp.name == "engine.decode_block"]
    assert len(block) == 1
    assert (block[0].attrs["rows_live"], block[0].attrs["rows_grid"]) == (
        live, grid)
    tracing.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("temp", [0.0, 0.7])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_extents_keep_the_tokens_on_the_card(monkeypatch, cuda, arch,
                                            temp):
    """On the card in f32 (the kernel with extents against the kernel
    without, graphed both): the same tokens, ``pos``, ``index`` and page
    tables after every step of the scenario."""
    model, params = _model(cuda, "float32", arch)
    off = TierEngine(model, params, _serving(True), eos_id=-1,
                     sample_temp=temp, seed=3)
    with monkeypatch.context() as m:
        _without_extents(m)
        want = _tokens_and_tables(_drive(off))
    eng = TierEngine(model, params, _serving(True), eos_id=-1,
                     sample_temp=temp, seed=3)
    got = _tokens_and_tables(_drive(eng))
    assert eng.decode_graph_steps > 0
    for (toks, tables), (toks0, tables0) in zip(got, want):
        assert toks == toks0
        for name, t in tables.items():
            assert torch.equal(t, tables0[name]), name


# a lean instance against its split mirror with P rounded to bf16 (the
# kernels' tests' tolerance: one bf16 ulp where the f32 sums round apart,
# plus P's two roundings)
LEAN_TOL = 8e-3

# the paged kernel with extents: phi-3-vision's (hd 96, group 1), the Qwen
# pair's (128, 6) and (128, 7), and a lean instance (256, 16); (hd, query
# heads, KV heads)
EXTENT_KERNEL_CASES = {
    "hd96 group 1": (96, 32, 32),
    "hd128 group 6": (128, 12, 2),
    "hd128 group 7": (128, 28, 4),
    "hd256 group 16 (lean)": (256, 16, 1),
}


def _extent_pool(rng, extents, t, page, h, kh, hd):
    """A pool where slot i holds positions 0..e-1 in its reserved pages (a
    shuffled table, the tail the null page) and queries at e - 1; a slot
    of extent 0 is dead: its table the null page, its positions a stale
    request's 0..t-1."""
    b = len(extents)
    used = [-(-e // page) for e in extents]
    n_pages = sum(used) + 1
    kp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kh, hd)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    perm = rng.permutation(n_pages - 1) + 1
    pages = np.zeros((b, -(-t // page)), np.int32)
    pos = np.full((b, t), -1, np.int32)
    pq = np.zeros((b,), np.int32)
    at = 0
    for i, (e, u) in enumerate(zip(extents, used)):
        pages[i, :u] = perm[at:at + u]
        at += u
        n = e or t  # a dead slot: a stale request's t positions
        pos[i, :n] = np.arange(n)
        pq[i] = n - 1
    return q, kp, vp, pages, pq, pos


@pytest.mark.gpu
@pytest.mark.parametrize("t", [2048, 4096])
@pytest.mark.parametrize("case", list(EXTENT_KERNEL_CASES))
def test_decode_paged_kernel_extents_match_plain(cuda, case, t):
    """bf16, page 256: extents 0, 1, a page - 1, a page, a split of 1024
    +- 1, T - 100 and T against the plain version (2e-2) and, lean, the
    bf16-P split mirror at the device's split length (LEAN_TOL); a dead
    slot exactly 0; a graph captured at one set of extents replays others
    (its grid is fixed) equal to eager calls."""
    hd, h, kh = EXTENT_KERNEL_CASES[case]
    page = 256
    extents = (0, 1, 255, 256, 1023, 1025, t - 100, t)
    rng = np.random.default_rng(hd + h + t)
    q, kp, vp, pages, pq, pos = (torch.as_tensor(x, device=cuda)
                                 for x in _extent_pool(rng, extents, t, page,
                                                       h, kh, hd))
    q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
    lens = torch.tensor(extents, dtype=torch.int32, device=cuda)
    got = decode_attention_paged_cuda(q, kp, vp, pages, pq, pos, lens=lens)
    want = decode_attention_paged_plain(q, kp, vp, pages, pq, pos, lens=lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    if lean_instance(hd, h // kh):
        blocks = plan_blocks(len(extents), kh, t, resident_blocks(
            cuda.index or 0, torch.bfloat16, hd, h // kh), PLAN_MIN_ROWS,
            MAX_SPLIT_ROWS)
        rows = plan_split_rows(extents, kh, blocks, PLAN_MIN_ROWS,
                               MAX_SPLIT_ROWS)
        idx = pages.long()
        kc = kp[idx].reshape(len(extents), -1, kh, hd)[:, :t]
        vc = vp[idx].reshape(len(extents), -1, kh, hd)[:, :t]
        mirror = decode_attention_split_plain(
            q, kc, vc, pq, pos, split_rows=rows, lens=lens,
            p_dtype=torch.bfloat16)
        torch.testing.assert_close(got.float(), mirror.float(),
                                   rtol=LEAN_TOL, atol=LEAN_TOL)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_paged_cuda(q, kp, vp, pages, pq, pos,
                                          lens=lens)
    for other in ((t, 0, 1, 2, 3, 4, 5, 6), (0,) * len(extents)):
        lens.copy_(torch.tensor(other, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attention_paged_cuda(
            q, kp, vp, pages, pq, pos, lens=lens))
