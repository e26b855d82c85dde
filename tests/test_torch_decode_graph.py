"""The fused decode block as CUDA graphs (``TierEngine._fused_static``).

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
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import ServingConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import (TierEngine, _named_leaves,  # noqa: E402
                                        _tree_map)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread (the suite runs files in parallel, and the small
    CPU steps here slow down by tens of times when the workers' threads
    outnumber the cores); the count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _model(device, dtype):
    cfg = reduced_config("qwen2-vl-2b").replace(dtype=dtype)
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
