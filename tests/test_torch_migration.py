"""Cross-tier KV migration in the port: per-slot extract / wire / inject
between the port's paged and dense engines at temperature 0 and 0.7, in
both directions between the JAX package's TierEngine and the port's
(float32, temperature 0, reduced qwen2-vl-2b, same converted weights), a
bf16 payload byte for byte the JAX package's, the wire and injection's
negative paths (each leaving the engine untouched), snapshot/restore
carrying the per-slot sampling keys, and a hybrid (recurrent) slot moved
between the packages in both directions."""
import dataclasses
import json
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import ml_dtypes  # noqa: E402  (ships with jax; the JAX side of the wire)

from repro.config import ServingConfig as JServingConfig  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.engine import SeqState as JSeqState  # noqa: E402
from repro.serving.engine import SlotPayload as JSlotPayload  # noqa: E402
from repro.serving.engine import TierEngine as JTierEngine  # noqa: E402
from repro_torch.config import ServingConfig  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import (MIGRATION_WIRE_VERSION,  # noqa: E402
                                        MigrationError, SeqState,
                                        SlotPayload, TierEngine)

torch.set_float32_matmul_precision("highest")
POOLS = {"dense": dict(paged=False), "paged": dict(paged=True,
                                                  kv_page_size=16)}


@pytest.fixture(scope="module")
def models(family_model):
    cfg, jp = family_model("vlm")
    tm = build_model(reduced_config(cfg.name).replace(dtype="float32"),
                     device="cpu")
    return cfg, j_build(cfg), jp, tm, params_from_numpy(
        jax.device_get(jp), "cpu")


def _sv(pool, max_seq=64, **kw):
    return dict(max_batch=3, max_seq=max_seq, fused_steps=8, **POOLS[pool],
                **kw)


def port_engine(models, pool, temp=0.0, seed=0, **kw):
    _, _, _, tm, tp = models
    return TierEngine(tm, tp, ServingConfig(**_sv(pool, **kw)),
                      sample_temp=temp, seed=seed)


def jax_engine(models, pool, **kw):
    _, jm, jp, _, _ = models
    return JTierEngine(jm, jp, JServingConfig(**_sv(pool, **kw)))


def jobs(cfg, n=3, max_new=20, seed=0):
    """Staggered prompt lengths; patches on every other request."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        toks = (np.arange(4 + 3 * rid) % 300 + 4).astype(np.int32)
        extras = {}
        if rid % 2 == 0:
            extras["patches"] = rng.standard_normal(
                (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        out.append((rid, toks, max_new, extras))
    return out


def _submit(eng, js):
    for rid, toks, max_new, extras in js:
        eng.submit(rid, toks, max_new=max_new, extras=extras)


def _drained(eng):
    return {s.rid: list(s.generated) for s in eng.run_until_drained()}


def _donor_wire(eng, js, rid=1, steps=1):
    _submit(eng, js)
    for _ in range(steps):
        eng.step()
    payload = eng.extract_slot(rid)
    wire = payload.to_bytes()
    assert payload.nbytes == len(wire)
    return payload, wire


# ---------------------------------------------------------------------------
# port to port: paged <-> dense, temperature 0 and 0.7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temp", [0.0, 0.7], ids=["t0", "t0.7"])
@pytest.mark.parametrize("src,dst", [("paged", "dense"), ("dense", "paged")])
def test_port_roundtrip_across_pool_kinds(models, src, dst, temp):
    """extract -> wire -> inject into an engine of the other pool kind
    continues the request with the tokens of the unmigrated run (at
    temperature 0.7 too: the slot's key and the hash of its positions
    travel with it)."""
    cfg = models[0]
    js = jobs(cfg)
    donor_ref = port_engine(models, src, temp)
    _submit(donor_ref, js)
    ref = _drained(donor_ref)
    donor = port_engine(models, src, temp)
    payload, wire = _donor_wire(donor, js)
    back = SlotPayload.from_bytes(wire)
    for name, leaf in payload.leaves.items():  # leaves round-trip bitwise
        assert torch.equal(back.leaves[name], leaf.cpu()), name
    target = port_engine(models, dst, temp)
    target.inject_slot(back)
    got = _drained(target)
    assert target.prefill_tokens == 0  # no second prefill: rows shipped
    assert got[1] == ref[1]
    if dst == "paged":
        assert target.pool.gauges()["pages_free"] == target.serving.pool_pages


def test_fused_and_per_token_draw_alike_at_temperature(models):
    """The keyed draw needs no advancing state: the per-token path and the
    fused block give the same tokens at temperature 0.7."""
    cfg = models[0]
    rng = np.random.default_rng(1)
    # every request with patches: one prefill group, so both paths admit
    # rid i into slot i (the key is the slot's)
    js = [(rid, toks, 12, {"patches": rng.standard_normal(
        (cfg.num_patches, cfg.frontend_dim)).astype(np.float32)})
        for rid, toks, _, _ in jobs(cfg)]
    out = {}
    for fused in (1, 8):
        eng = port_engine(models, "dense", 0.7)
        eng.fused_steps = fused
        _submit(eng, js)
        out[fused] = _drained(eng)
    assert out[1] == out[8]
    greedy = port_engine(models, "dense")
    _submit(greedy, js)
    assert _drained(greedy) != out[8]  # the temperature does draw


# ---------------------------------------------------------------------------
# across the two packages (f32, temperature 0)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dst", ["dense", "paged"])
@pytest.mark.parametrize("src", ["dense", "paged"])
def test_jax_extract_port_inject(models, src, dst):
    cfg = models[0]
    js = jobs(cfg)
    ref = jax_engine(models, src)
    _submit(ref, js)
    want = {s.rid: list(s.generated) for s in ref.run_until_drained()}
    _, wire = _donor_wire(jax_engine(models, src), js)
    payload = SlotPayload.from_bytes(wire)
    assert payload.key.dtype == np.uint32 and payload.key.shape == (2,)
    target = port_engine(models, dst)
    target.inject_slot(payload)
    got = _drained(target)
    assert target.prefill_tokens == 0
    assert got[1] == want[1]


@pytest.mark.parametrize("dst", ["dense", "paged"])
@pytest.mark.parametrize("src", ["dense", "paged"])
def test_port_extract_jax_inject(models, src, dst):
    cfg = models[0]
    js = jobs(cfg)
    ref = jax_engine(models, dst)
    _submit(ref, js)
    want = {s.rid: list(s.generated) for s in ref.run_until_drained()}
    _, wire = _donor_wire(port_engine(models, src), js)
    payload = JSlotPayload.from_bytes(wire)
    target = jax_engine(models, dst)
    target.inject_slot(payload)
    got = {s.rid: list(s.generated) for s in target.run_until_drained()}
    assert target.prefill_tokens == 0
    assert got[1] == want[1]


def _bf16_rows(rng, spec):
    rows = {}
    for name, (shape, dtype) in spec.items():
        if dtype == "bfloat16":
            rows[name] = rng.standard_normal(shape).astype(
                ml_dtypes.bfloat16)
        else:
            rows[name] = rng.integers(-1, 60, shape).astype(np.int32)
    return rows


def test_bf16_payload_bytes_equal_jax(models):
    """The same bf16 rows, seq state and key make the same wire bytes in
    both packages, and each package reads the other's leaves bitwise."""
    cfg = models[0]
    bcfg = cfg.replace(dtype="bfloat16")
    tm = build_model(reduced_config(cfg.name).replace(dtype="bfloat16"),
                     device="cpu")
    eng = TierEngine(tm, tm.init(0), ServingConfig(**_sv("paged")))
    spec = eng._row_specs
    jeng = JTierEngine(j_build(bcfg), jax.device_get(
        j_build(bcfg).init(jax.random.PRNGKey(0))),
        JServingConfig(**_sv("paged")))
    assert spec == {k: (tuple(s), d) for k, (s, d) in
                    jeng._row_specs.items()}
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    assert spec["['blocks']['k']"] == ((L, 64, K, hd), "bfloat16")
    assert spec["['pos']"] == ((64,), "int32")
    assert spec["['index']"] == ((), "int32")
    rows = _bf16_rows(np.random.default_rng(0), spec)
    key = np.asarray([123, 4567], np.uint32)
    seq = dict(rid=5, prompt_len=12, generated=[7, 8], max_new=9,
               t_submit=1.5, session="s")
    common = dict(version=MIGRATION_WIRE_VERSION, model=cfg.name,
                  family=cfg.family, max_seq=64, position=13, key=key,
                  prompt_tokens=np.arange(12, dtype=np.int32),
                  extras_fp=b"\x01\x02")
    jwire = JSlotPayload(seq=JSeqState(**seq), leaves=rows,
                         **common).to_bytes()
    tleaves = {}
    for name, r in rows.items():
        if str(r.dtype) == "bfloat16":
            tleaves[name] = torch.from_numpy(r.view(np.int16)).view(
                torch.bfloat16)
        else:
            tleaves[name] = torch.from_numpy(r)
    twire = SlotPayload(seq=SeqState(**seq), leaves=tleaves,
                        **common).to_bytes()
    assert twire == jwire
    back = SlotPayload.from_bytes(jwire)
    for name, leaf in back.leaves.items():
        assert torch.equal(leaf, tleaves[name]), name
    # a real bf16 extraction crosses both ways and re-serializes to the
    # same bytes
    eng.submit(0, np.arange(4, 20, dtype=np.int32), max_new=12)
    eng.step()
    wire = eng.extract_slot(0).to_bytes()
    assert JSlotPayload.from_bytes(wire).to_bytes() == wire
    jback = JSlotPayload.from_bytes(wire)
    jback._wire = None
    assert jback.to_bytes() == wire


# ---------------------------------------------------------------------------
# negative paths: MigrationError, target engine untouched
# ---------------------------------------------------------------------------


@pytest.fixture()
def payload(models):
    eng = port_engine(models, "dense")
    eng.submit(0, np.asarray([4, 5, 6, 7], np.int32), max_new=20)
    eng.step()
    return eng.extract_slot(0)


def _assert_untouched(eng):
    assert all(s is None for s in eng.slots)
    assert not any(op == "inject" for op, _ in eng.journal)
    if eng.pool is not None:
        assert eng.pool.gauges()["pages_free"] == eng.serving.pool_pages


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_inject_rejects_wrong_wire_version(models, payload, pool):
    bad = SlotPayload.from_bytes(payload.to_bytes())
    bad.version = MIGRATION_WIRE_VERSION + 1
    eng = port_engine(models, pool)
    with pytest.raises(MigrationError, match="wire format version"):
        eng.inject_slot(bad)
    _assert_untouched(eng)


def test_inject_rejects_wrong_model(family_model, payload):
    cfg, _ = family_model("dense")
    tm = build_model(reduced_config(cfg.name).replace(dtype="float32"),
                     device="cpu")
    eng = TierEngine(tm, tm.init(0), ServingConfig(**_sv("dense")))
    with pytest.raises(MigrationError, match="model-specific"):
        eng.inject_slot(payload)
    _assert_untouched(eng)


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_inject_rejects_mismatched_cache_axes(models, payload, pool):
    eng = port_engine(models, pool, max_seq=128)  # donor used 64
    with pytest.raises(MigrationError, match="row shape"):
        eng.inject_slot(payload)
    _assert_untouched(eng)


def test_inject_rejects_wrong_dtype_leaf_set_and_key(models, payload):
    eng = port_engine(models, "paged")
    name = "['blocks']['k']"
    bad = dataclasses.replace(payload, _wire=None, leaves=dict(
        payload.leaves, **{name: payload.leaves[name].to(torch.bfloat16)}))
    with pytest.raises(MigrationError, match="dtype"):
        eng.inject_slot(bad)
    fewer = dataclasses.replace(payload, _wire=None, leaves={
        k: v for k, v in payload.leaves.items() if k != "['pos']"})
    with pytest.raises(MigrationError, match="leaf mismatch"):
        eng.inject_slot(fewer)
    keyless = dataclasses.replace(payload, _wire=None,
                                  key=np.zeros(3, np.uint32))
    with pytest.raises(MigrationError, match="key"):
        eng.inject_slot(keyless)
    _assert_untouched(eng)


def test_inject_rejects_when_pages_run_out(models, payload):
    eng = port_engine(models, "paged", kv_pool_pages=4)
    eng.submit(9, np.asarray([4, 5, 6], np.int32), max_new=60)
    eng.step()  # holds all four pages
    assert eng.pool.gauges()["pages_free"] == 0
    with pytest.raises(MigrationError, match="no free KV pages"):
        eng.inject_slot(payload)
    assert [s.rid for s in eng.slots if s is not None] == [9]
    assert not any(op == "inject" for op, _ in eng.journal)
    assert eng.pool.gauges()["pages_free"] == 0


def test_inject_rejects_when_full_and_duplicate(models, payload):
    _, _, _, tm, tp = models
    eng = TierEngine(tm, tp, ServingConfig(**dict(_sv("dense"),
                                                  max_batch=1)))
    eng.inject_slot(payload)
    with pytest.raises(MigrationError, match="already occupies"):
        eng.inject_slot(payload)
    other = SlotPayload.from_bytes(payload.to_bytes())
    other.seq.rid = 7
    with pytest.raises(MigrationError, match="no free"):
        eng.inject_slot(other)


def test_extract_remove_frees_slot(models):
    eng = port_engine(models, "paged")
    eng.submit(0, np.asarray([4, 5, 6], np.int32), max_new=20)
    eng.step()
    eng.extract_slot(0, remove=True)
    assert all(s is None for s in eng.slots)
    with pytest.raises(MigrationError):
        eng.extract_slot(0)
    assert eng.run_until_drained() == []
    assert eng.pool.gauges()["pages_free"] == eng.serving.pool_pages


def test_wire_rejects_garbage_and_truncation(payload):
    wire = payload.to_bytes()
    with pytest.raises(MigrationError, match="magic"):
        SlotPayload.from_bytes(b"NOTKV" + wire[5:])
    with pytest.raises(MigrationError, match="truncated"):
        SlotPayload.from_bytes(wire[:len(wire) // 2])
    with pytest.raises(MigrationError, match="truncated"):
        SlotPayload.from_bytes(wire[:7])
    with pytest.raises(MigrationError, match="checksum"):
        SlotPayload.from_bytes(wire[:-1] + bytes([wire[-1] ^ 1]))
    for mutate in (lambda h: h.pop("key"),
                   lambda h: h["leaves"][0].update(shape=[-2, 4]),
                   lambda h: h["leaves"][0].update(dtype="float77")):
        hlen = struct.unpack_from("<HII", wire, 5)[1]
        head = json.loads(wire[15:15 + hlen])
        mutate(head)
        blob = json.dumps(head).encode()
        bad = (wire[:5] + struct.pack("<HII", MIGRATION_WIRE_VERSION,
                                      len(blob), zlib.crc32(blob))
               + blob + wire[15 + hlen:])
        with pytest.raises(MigrationError):
            SlotPayload.from_bytes(bad)


# ---------------------------------------------------------------------------
# snapshot / restore carries the per-slot keys
# ---------------------------------------------------------------------------


def test_snapshot_restore_carries_slot_keys(models):
    cfg = models[0]
    eng = port_engine(models, "paged", 0.7, seed=3)
    _submit(eng, jobs(cfg, max_new=16))
    eng.step()
    snap = eng.snapshot()
    assert snap["keys"].dtype == np.uint32 and snap["keys"].shape == (3, 2)
    np.testing.assert_array_equal(snap["keys"], eng._keys)
    k0 = len(eng.finished)
    eng.run_until_drained()
    first = {s.rid: list(s.generated) for s in eng.finished[k0:]}
    eng._keys[:] = 0  # a restore must bring the keys back
    eng.restore(snap)
    np.testing.assert_array_equal(eng._keys, snap["keys"])
    k1 = len(eng.finished)
    eng.run_until_drained()
    again = {s.rid: list(s.generated) for s in eng.finished[k1:]}
    assert again == first and len(first) == 3


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_hybrid_slot_migrates_between_packages(family_model, direction):
    """A hybrid (RecurrentGemma) slot, its ring wrapped (a 40-token prompt
    over the reduced window of 32), moves between the packages through the
    wire mid-decode and finishes with the donor package's unmigrated
    tokens: the ring KV, the RG-LRU conv windows and f32 states travel."""
    cfg, jp = family_model("hybrid")
    tm = build_model(reduced_config(cfg.name).replace(dtype="float32"),
                     device="cpu")
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    sv = dict(max_batch=2, max_seq=96, fused_steps=4)
    prompt = (np.arange(40) % 300 + 4).astype(np.int32)

    def make(pkg):
        if pkg == "jax":
            return JTierEngine(j_build(cfg), jp, JServingConfig(**sv))
        return TierEngine(tm, tp, ServingConfig(**sv))

    src, dst = direction.split("-to-")
    ref = make(src)
    ref.submit(0, prompt, max_new=16)
    want = _drained(ref)[0]
    donor = make(src)
    donor.submit(0, prompt, max_new=16)
    donor.step()
    wire = donor.extract_slot(0).to_bytes()
    payload = (JSlotPayload if dst == "jax" else SlotPayload).from_bytes(wire)
    assert any("rglru" in name for name in payload.leaves)
    target = make(dst)
    target.inject_slot(payload)
    assert _drained(target)[0] == want
    assert target.prefill_tokens == 0


@pytest.mark.slow
@pytest.mark.parametrize("route", ["jax-to-port", "port-to-jax",
                                   "paged-to-dense", "dense-to-paged"])
def test_moe_slot_migrates(family_model, route):
    """A moe (reduced Qwen3-MoE) slot, prefilled beside a neighbour in its
    own group, moves through the wire mid-decode, between the packages and
    between the port's pool kinds, and finishes with the donor's
    unmigrated tokens."""
    cfg, jp = family_model("moe")
    tm = build_model(reduced_config(cfg.name).replace(dtype="float32"),
                     device="cpu")
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    prompts = [(np.arange(n) % 300 + 4).astype(np.int32) for n in (9, 21)]

    def make(kind):
        sv = _sv("paged" if kind == "paged" else "dense", max_seq=96)
        if kind == "jax":
            return JTierEngine(j_build(cfg), jp, JServingConfig(**sv))
        return TierEngine(tm, tp, ServingConfig(**sv))

    def submit(eng):
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, max_new=16)

    src, dst = route.split("-to-")
    ref = make(src)
    submit(ref)
    want = _drained(ref)[1]
    donor = make(src)
    submit(donor)
    donor.step()
    wire = donor.extract_slot(1).to_bytes()
    payload = (JSlotPayload if dst == "jax" else SlotPayload).from_bytes(wire)
    target = make(dst)
    target.inject_slot(payload)
    assert _drained(target)[1] == want
    assert target.prefill_tokens == 0
