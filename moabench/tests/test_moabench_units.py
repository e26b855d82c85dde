"""CPU tests of the benchmark's pieces: finding them by name, the traffic's
repeatability, the metric arithmetic, the work counts, and the float32
reference against the port's plain path at a reduced size."""
from __future__ import annotations

import itertools
import json

import numpy as np
import pytest
import torch

from moabench import arch, readers, spec, testing
from moabench import yardstick as ys
from moabench.reference import complexity as ref_cx
from moabench.reference import model as ref_model
from moabench.trace import _union
from moabench.traffic.generator import Traffic, load_mix

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


# -- found by name -----------------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_cell_pieces_found_by_name(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    c = spec.cell(name)
    assert (c["config"], c["traffic"], c["chips"], c["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    cfg = spec.config(c["config"])
    assert any(x["name"] == cfg["name"] and x["file"].endswith(
        f"configs/{cfg['name']}.json") for x in BENCH["configs"])
    assert load_mix(c["traffic"])["loop"] in ("open", "closed")
    for trace in (False, True):
        ms = spec.metrics_for(BENCH, name, trace)
        assert ms, (name, trace)
        for m in ms:
            assert callable(spec.reader(m["name"]))
    assert {m["name"] for m in spec.metrics_for(BENCH, name, False)} >= {
        "setup_s"}


def test_every_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            e2e = {x["name"] for x in spec.metrics_for(BENCH, w, False)}
            assert m["moves"] in e2e, (m["name"], w)


def test_unknown_names_raise():
    with pytest.raises(FileNotFoundError):
        spec.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no.such.metric")
    with pytest.raises(FileNotFoundError):
        load_mix("no-such-mix")


# -- traffic -----------------------------------------------------------------


def _mix(name):
    c = spec.cell(name)
    return load_mix(c["traffic"]), c.get("params", {})


def test_open_mix_repeats_for_a_seed_and_reorders_across_seeds():
    mix, params = _mix("qwen-vqa-poisson")
    seed = 2 ** 31 + 99
    a, b = Traffic(mix, params, seed), Traffic(mix, params, seed)
    oa, sa = a.window(20.0)
    ob, sb = b.window(20.0)
    np.testing.assert_array_equal(oa, ob)
    assert sa == sb
    assert np.array_equal(a.prompt_ids(sa[0], 0), b.prompt_ids(sb[0], 0))
    oc, sc = Traffic(mix, params, seed + 1).window(20.0)
    assert len(oc) == len(oa) and oc[-1] == pytest.approx(oa[-1])
    assert sorted(map(repr, sc)) == sorted(map(repr, sa))
    assert sc != sa
    assert 0 < oa[0] and oa[-1] <= 20.0


def test_closed_mix_and_images_repeat():
    mix, params = load_mix("describe-closed"), {}
    t1, t2 = Traffic(mix, params, 5), Traffic(mix, params, 5)
    first = list(itertools.islice(t1.stream(16), 300))
    assert first == list(itertools.islice(t2.stream(16), 300))
    clients = mix["clients"]
    assert all(s.image >= 0 for s in first)
    assert all(128 <= s.max_new <= 512 for s in first[clients:])
    # the first round starts part-way: residual lengths, some below 128
    head = [s.max_new for s in first[:clients]]
    assert min(head) >= 1 and max(head) <= 512 and min(head) < 128
    small = dict(mix, image=dict(mix["image"], pool=3, side_min=40,
                                 side_span=30))
    i1, i2 = Traffic(small, {}, 5).images(), Traffic(small, {}, 5).images()
    for x, y, (side, _) in zip(i1, i2, Traffic(small, {}, 5).pool_specs):
        assert x.shape == (side, side)  # drawn at its own side
        np.testing.assert_array_equal(x, y)


def test_prompt_ids_carry_the_drawn_counts():
    mix, params = _mix("qwen-vqa-poisson")
    t = Traffic(mix, params, 3)
    for i, s in enumerate(t.window(10.0)[1][:20]):
        ids = t.prompt_ids(s, i)
        assert len(ids) == s.tokens and ids[0] == 1
        assert (ids == 3).sum() == s.sentences
        assert ((ids >= 4) & (ids < 1000)).sum() == min(
            s.entities, s.tokens - 1 - s.sentences)
        assert ids.max() < 32_000


# -- arithmetic --------------------------------------------------------------


class _Run:
    def __init__(self, requests, t0=0.0, t1=10.0, token_t=()):
        self.requests, self.t0, self.t1 = requests, t0, t1
        self.token_t = list(token_t)
        self.drain_end = 25.0


def test_p95_over_every_request_nearest_rank():
    reqs = [{"ttft": i / 100.0, "due": 0.0} for i in range(1, 201)]
    assert readers.tail_ms(_Run(reqs), "ttft") == pytest.approx(1900.0)
    # a failed request sits above every finished one
    reqs = [{"ttft": 0.1, "due": 0.0}] * 95 + [{"ttft": float("inf"),
                                                "due": 5.0}] * 5
    assert readers.tail_ms(_Run(reqs), "ttft") == pytest.approx(100.0)
    reqs = [{"ttft": 0.1, "due": 0.0}] * 94 + [{"ttft": float("inf"),
                                                "due": 5.0}] * 6
    assert readers.tail_ms(_Run(reqs), "ttft") == pytest.approx(25000.0)


def test_tokens_over_the_window_and_idle_share():
    run = _Run([], t0=1.0, t1=3.0, token_t=[0.5, 1.0, 2.0, 2.5, 3.0, 3.5])
    assert readers.tokens_per_s(run) == pytest.approx(4 / 2.0)
    merged = _union(np.array([[0, 2], [1, 3], [5, 6], [5.5, 5.7]], float))
    np.testing.assert_array_equal(merged, [[0, 3], [5, 6]])

    class T:
        window_s, busy_s = 4.0, 1.0
    run.trace = T()
    assert readers.idle_pct(run) == pytest.approx(75.0)


def test_decode_step_time_counts_only_steps_that_admitted_nothing():
    """The decode step time is read from the fused decode blocks alone (a
    step that also admitted holds its prefill group outside the block), in
    the window, over the decode steps each block ran."""
    class P:
        blocks = [("edge", 1.0, 1.4, [5], [8], 8),
                  ("cloud", 2.2, 2.5, [9, 3], [4, 2], 4),
                  ("edge", 0.1, 0.9, [5], [8], 8),
                  ("edge", 2.6, 2.7, [], [], 0)]
    run = _Run([], t0=1.0, t1=3.0)
    run.probe = P()
    # in the window, with decode: 0.4 s + 0.3 s over 12 steps
    assert readers.decode_step_ms(run) == pytest.approx(1e3 * 0.7 / 12)


def test_work_counts_against_hand_counts():
    a = arch.Arch("t", layers=2, d=8, heads=4, kv_heads=2, head_dim=4,
                  d_ff=16, vocab=300, tied=True, patches=3, frontend_dim=5,
                  rope_theta=1e4, eps=1e-6)
    f, b = ys.flash_prefill(a, [3])
    # pairs (causal, S=3): 6; per pair per head 4*hd flops
    assert f == 2 * 6 * 4 * 4 * 4
    assert b == 2 * 2 * 3 * 4 * (2 * 4 + 2 * 2)
    f, b = ys.decode_paged_step(a, [5, 7])
    assert f == 2 * 4 * 4 * 4 * 12
    assert b == 2 * 2 * ((2 * 5 * 2 * 4 + 2 * 4 * 4) + (2 * 7 * 2 * 4
                                                          + 2 * 4 * 4))
    assert ys.image_stats(10, 20) == (30.0 * 200, 4 * (200 + 265))
    lin = 2 * (8 * 16 * 2 + 8 * 8 * 2 + 3 * 8 * 16)
    assert a.linear_params == lin
    assert ys.decode_flops(a, 5) == 2 * lin + 4 * 2 * 4 * 4 * 5 + 2 * 300 * 8
    assert ys.prefill_flops(a, 4, True) == (2 * lin * 4 + 4 * 2 * 16 * 10
                                            + 2 * 300 * 8 + 2 * 5 * 8 * 3)
    assert ys.least_s(989e12, 0) == pytest.approx(1.0)
    assert ys.least_s(0, 3.35e12) == pytest.approx(1.0)


# -- the reference against the port's plain path ------------------------------


def _small_arch(tied):
    m = dict(spec.config("ec-qwen2vl2b-qwen25vl7b")["tiers"][1]["model"],
             **testing.SMALL_MODEL)
    m.update(tie_word_embeddings=tied, rms_norm_eps=1e-5, vocab_size=500)
    return arch.arch(m)


@pytest.mark.parametrize("tied", [True, False])
def test_reference_matches_port_prefill_and_decode_f32(tied):
    from repro_torch.models import build_model

    a = _small_arch(tied)
    w = arch.make_weights(a, 11, 0, "float32", "cpu")
    model = build_model(arch.model_config(a, "float32"), attn_impl="torch",
                        device="cpu")
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (9, 13)).astype(np.float32)
    ids = rng.integers(0, a.vocab, 21).astype(np.int64)
    patches = ref_model.stub_patches(img, a.patches, a.frontend_dim)
    batch = {"tokens": torch.as_tensor(ids[None].astype(np.int32)),
             "patches": torch.as_tensor(patches[None])}
    with torch.no_grad():
        logits, cache = model.prefill(w, batch, 64)
        nxt = torch.tensor([[7]], dtype=torch.int32)
        pos = torch.tensor([a.patches + len(ids)], dtype=torch.int32)
        dec, _ = model.decode_step(w, cache, {"tokens": nxt,
                                              "positions": pos})
    s = a.patches + len(ids)
    ref = ref_model.logits_at(a, w, [{"ids": np.r_[ids, 7], "image": img,
                                      "rows": [s - 1, s]}], "cpu")[0]
    torch.testing.assert_close(logits[0], ref[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dec[0], ref[1], rtol=1e-4, atol=1e-4)


def test_reference_scores_match_port_plain_scorer():
    from repro_torch.core import complexity as port_cx

    rng = np.random.default_rng(1)
    for h, w in [(33, 65), (64, 64), (97, 40)]:
        img = np.clip(rng.normal(128, 60, (h, w)), 0, 255).astype(np.float32)
        got = float(port_cx.image_complexity(img[None], use_kernel=False)
                    ["c_img"][0])
        assert abs(got - ref_cx.image_score(img)) < 1e-5
    ids = np.array([1, 5, 900, 3, 2000, 3000, 3, 40], np.int32)
    got = float(port_cx.text_complexity_from_counts(8, 3, 2)["c_text"])
    assert abs(got - ref_cx.text_score(ids)) < 1e-7


TIERS = [(c["name"], i) for c in BENCH["configs"]
         for i, _ in enumerate(spec.config(c["name"])["tiers"])]


@pytest.mark.parametrize("cfg,tier", TIERS)
def test_weight_layout_is_the_programs_at_full_width(cfg, tier):
    from repro_torch.models import build_model

    a = arch.arch(spec.config(cfg)["tiers"][tier]["model"])
    model = build_model(arch.model_config(a, "bfloat16"), device="cpu")
    want = {p: tuple(t.shape) for p, t in arch.leaves(
        model.param_shapes())}
    have = {p: s for p, s, _ in arch.layout(a)}
    assert want == have


def test_benchmark_json_is_well_formed():
    text = json.dumps(BENCH)
    assert len(text) < 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


# -- the reference control plane ---------------------------------------------


def _policy_cfg():
    return spec.config(BENCH["configs"][0]["name"])


def test_reference_eq5_eq6_and_threshold_by_hand():
    from moabench.reference import policy as ref_policy

    cfg = _policy_cfg()
    pol, tiers = cfg["policy"], cfg["tiers"]
    calm = {"loads": {"edge": 0.1}, "queue_depths": {"edge": 0, "cloud": 0},
            "bandwidth_bps": 300e6, "health": {}}
    assert ref_policy.route(0.4, 0.5, calm, pol, tiers) == "edge"
    assert ref_policy.route(0.6, 0.5, calm, pol, tiers) == "cloud"
    busy = dict(calm, loads={"edge": 0.9})
    assert ref_policy.route(0.1, 0.5, busy, pol, tiers) == "cloud"
    fast = dict(calm, bandwidth_bps=600e6)
    assert ref_policy.route(0.1, 0.5, fast, pol, tiers) == "cloud"
    assert ref_policy.fusion({"image": "edge", "text": "cloud"},
                             tiers) == "cloud"
    assert ref_policy.fusion({"image": "edge", "text": "edge"},
                             tiers) == "edge"
    taus = {"image": 0.5, "text": 0.5}
    deep_edge = dict(calm, queue_depths={"edge": 6, "cloud": 0})
    assert ref_policy.update(taus, deep_edge, pol, tiers) == pytest.approx(
        {"image": 0.48, "text": 0.48})
    deep_cloud = dict(calm, queue_depths={"edge": 0, "cloud": 6})
    assert ref_policy.update(taus, deep_cloud, pol, tiers) == pytest.approx(
        {"image": 0.52, "text": 0.52})
    assert ref_policy.update(taus, calm, pol, tiers) == taus


def test_reference_uplink_is_one_fifo_server_and_downlink_by_hand():
    from moabench.reference import policy as ref_policy

    cfg = _policy_cfg()
    tiers, wan = cfg["tiers"], cfg["wan"]
    cloud = next(t for t in tiers if t["uplink_bps"] > 0)
    bps, rtt = cloud["uplink_bps"], cloud["rtt_s"]
    routes = {"image": "cloud", "text": "cloud"}
    sizes = {"image": ("image", 1000 * 1000), "text": ("text", 100)}
    b = ref_policy.payload_bytes(routes, sizes, "cloud", tiers, wan)
    assert b == {"cloud": 500_000 + 400}
    split = ref_policy.payload_bytes({"image": "edge", "text": "cloud"},
                                     sizes, "cloud", tiers, wan)
    vis = cloud["model"]["vision_config"]
    assert split == {"cloud": 400 + vis["num_patches"] * vis["frontend_dim"]
                     * 4.0}
    assert ref_policy.payload_bytes({"image": "edge", "text": "edge"},
                                    sizes, "edge", tiers, wan) == {}
    sec = rtt + 8.0 * 500_400 / bps
    got = ref_policy.wan_seconds([(0.0, b), (0.001, b), (10.0, {}),
                                  (20.0, b)], tiers)
    assert got == pytest.approx([sec, 2 * sec - 0.001, 0.0, sec])
    assert ref_policy.downlink_seconds(cloud, 10, wan) == pytest.approx(
        rtt + 8.0 * 40 / bps)
    assert ref_policy.downlink_seconds(tiers[0], 10, wan) == 0.0


def test_probe_fails_loudly_when_a_wrapped_method_is_gone_or_changed():
    from moabench import serve

    class Engine:
        def step(self):
            return 0

        def _admit_group(self, jobs, slots, bucket):
            return None

    eng = Engine()
    with pytest.raises(serve.MissingHook, match="_fused is gone"):
        serve.Probe()._spans("edge", eng)
    eng._fused = lambda tokens, positions, budgets, k_steps, rids: None
    with pytest.raises(serve.MissingHook, match="_fused takes"):
        serve.Probe()._spans("edge", eng)


def test_route_check_replays_the_estimator_and_threshold():
    from moabench.reference import check

    cfg = _policy_cfg()
    obs = [(0, {"edge": 0.5, "cloud": 0.25}, {"edge": 6, "cloud": 0},
            300e6)]
    state = {"loads": {"edge": 0.1, "cloud": 0.05},
             "queue_depths": {"edge": 6, "cloud": 0},
             "bandwidth_bps": 300e6, "health": {}}
    taus = {"image": 0.5, "text": 0.5, "audio": 0.5}
    first = {"scores": {"image": 0.7, "text": 0.2}, "taus": taus,
             "state": state, "routes": {"image": "cloud", "text": "edge"},
             "served": "cloud"}
    second = dict(first, taus={m: 0.48 for m in taus},
                  routes={"image": "cloud", "text": "edge"})
    assert check.route_faults([first, second], obs, cfg) == 0
    # a load the EWMA would not give, a threshold that did not move, a
    # modality kept on the edge above its threshold, a wrong serving tier
    bad_state = dict(first, state=dict(state, loads={"edge": 0.5,
                                                     "cloud": 0.05}))
    assert check.route_faults([bad_state, second], obs, cfg) == 1
    assert check.route_faults([first, dict(second, taus=taus)], obs,
                              cfg) == 1
    assert check.route_faults([dict(first, routes={"image": "edge",
                                                   "text": "edge"})],
                              obs, cfg) == 1
    assert check.route_faults([dict(first, served="edge")], obs, cfg) == 1
