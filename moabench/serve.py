"""The system under test and the harness's calls into it.

:func:`build` turns a configuration file into one ``TierEngine`` per tier
(weights from ``arch.make_weights``, ``eos_id=-1`` so that random weights
never end a request early) behind a ``ClusterServer`` with the class's
defaults: the MoA-Off policy, no hedging, faults, speculation, sessions or
prefix store. Requests go in through ``ClusterServer.build_request`` with
explicit token ids and ``submit_request``, the two halves of ``submit``
(the toy tokenizer salts its word hashes per process, so text would not
give the same ids twice), and ``ClusterServer.run`` drives them.

:class:`Probe` is everything the harness records. In every run it watches
each engine's token stream (the ``on_token`` hook the runtime installs,
wrapped) and the scheduler's ``score`` call, both on the host's monotonic
clock, and the policy's ``decide`` call with what it was given (the scores,
its threshold and its system-state reading) and what it chose. In the
``--trace 1`` runs (``attach_detail``) it also puts spans around each
engine's ``step``, its prefill group (``_admit_group``) and its fused decode
block (``_fused``), with the shapes each was given. The last two are
private methods of ``TierEngine``: where one is missing, or takes other
arguments than these spans expect, ``attach_detail`` raises
:class:`MissingHook` naming it, so that a traced run fails loudly instead of
leaving the metrics that read these spans silent.
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from moabench import arch as arch_mod
from moabench.arch import leaves


@dataclass
class Built:
    server: object
    engines: Dict[str, object]
    archs: Dict[str, arch_mod.Arch]
    weights: Dict[str, Dict]
    remote: str


def build(cfg: Dict, seed: int, device: str) -> Built:
    from repro_torch.config import ClusterTopology, ServingConfig, TierSpec
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine
    from repro_torch.serving.tiers import ClusterServer

    dtype, attn_impl = cfg["dtype"], cfg["attn_impl"]
    engines, archs, weights, specs = {}, {}, {}, []
    for i, tier in enumerate(cfg["tiers"]):
        name = tier["name"]
        a = arch_mod.arch(tier["model"])
        w = arch_mod.make_weights(a, seed, i, dtype, device)
        model = build_model(arch_mod.model_config(a, dtype),
                            attn_impl=attn_impl, device=device)
        want = {p: tuple(t.shape) for p, t in leaves(model.param_shapes())}
        have = {p: tuple(t.shape) for p, t in leaves(w)}
        if want != have:
            diff = sorted(set(want.items()) ^ set(have.items()))
            raise ValueError(f"{name}: the benchmark's weight layout is not "
                             f"the program's: {diff}")
        serving = ServingConfig(**{**cfg["serving"],
                                   **tier.get("serving", {})})
        engines[name] = TierEngine(model, w, serving, eos_id=-1)
        archs[name], weights[name] = a, w
        cm = tier["cost_model"]
        specs.append(TierSpec(
            name=name, model=a.name, num_chips=int(cm["num_chips"]),
            flops_per_s=float(cm["flops_per_s"]), hbm_bw=float(cm["hbm_bw"]),
            mfu=float(cm["mfu"]), uplink_bps=float(tier["uplink_bps"]),
            rtt_s=float(tier["rtt_s"]), capability=float(tier["capability"])))
    topo = ClusterTopology(cfg["topology"], tuple(specs))
    server = ClusterServer(engines, topology=topo)
    return Built(server, engines, archs, weights, topo.default_remote.name)


# ---------------------------------------------------------------------------
# what the harness records
# ---------------------------------------------------------------------------

#: the program's methods the probe wraps, with the arguments its wrappers
#: pass on: (owner, attribute, parameter names)
HOOKS = (("scheduler", "score", ("request",)),
         ("scheduler", "observe", None),
         ("policy", "decide", ("request", "scores", "state")),
         ("engine", "step", ()),
         ("engine", "_admit_group", ("jobs", "slots", "bucket")),
         ("engine", "_fused", ("tokens", "positions", "budgets", "teff",
                               "k_steps", "rids")))


class MissingHook(RuntimeError):
    """A method the probe wraps is gone or takes other arguments."""


def _hook(owner: str, obj, attr: str):
    """``obj.attr``, checked against :data:`HOOKS`."""
    want = next(h[2] for h in HOOKS if h[0] == owner and h[1] == attr)
    fn = getattr(obj, attr, None)
    if not callable(fn):
        raise MissingHook(f"{type(obj).__name__}.{attr} is gone: the "
                          f"benchmark's probe wraps it")
    got = tuple(inspect.signature(fn).parameters)
    if want is not None and got != want:
        raise MissingHook(f"{type(obj).__name__}.{attr} takes {got}, the "
                          f"benchmark's probe passes {want}")
    return fn


@dataclass
class Probe:
    first: Dict[int, float] = field(default_factory=dict)
    last: Dict[int, float] = field(default_factory=dict)
    tokens: Dict[int, List[int]] = field(default_factory=dict)
    token_t: List[float] = field(default_factory=list)
    # (rid, t start, t end, lateness s, image (h, w) or None)
    scores: List[tuple] = field(default_factory=list)
    # trace runs: (name, t0, t1) host spans
    spans: List[tuple] = field(default_factory=list)
    # trace runs: (tier, t0, t1, [(text tokens, with image)])
    groups: List[tuple] = field(default_factory=list)
    # trace runs: (tier, t0, t1, live positions, live budgets, k)
    blocks: List[tuple] = field(default_factory=list)
    # every decision, in order: rid, scores, thresholds, state, routes
    decisions: List[Dict] = field(default_factory=list)
    # every observation fed to the state estimator: (decisions made
    # before it, its loads, queue depths and bandwidth reading)
    observations: List[tuple] = field(default_factory=list)

    def attach(self, built: Built) -> None:
        sched = built.server.scheduler
        score = _hook("scheduler", sched, "score")
        policy = sched.policy
        decide = _hook("policy", policy, "decide")

        def decided(request, scores, state):
            taus = dict(policy.taus)
            out = decide(request, scores, state)
            self.decisions.append({
                "rid": request.rid,
                "scores": {m: float(c) for m, c in scores.items()},
                "taus": taus,
                "state": {"loads": dict(state.loads),
                          "queue_depths": dict(state.queue_depths),
                          "bandwidth_bps": float(state.bandwidth_bps),
                          "health": dict(state.health)},
                "routes": dict(out.routes)})
            return out
        policy.decide = decided
        observe = _hook("scheduler", sched, "observe")

        def observed(**kw):
            self.observations.append((
                len(self.decisions), dict(kw.get("loads") or {}),
                dict(kw.get("queue_depths") or {}), kw.get("bandwidth_bps")))
            return observe(**kw)
        sched.observe = observed

        def scored(request):
            t0 = time.monotonic()
            out = score(request)
            img = request.modalities.get("image")
            hw = (tuple(np.shape(img.data)) if img is not None
                  and img.data is not None else None)
            self.scores.append((request.rid, t0, time.monotonic(),
                                t0 - request.arrival_s, hw))
            return out
        sched.score = scored
        for tier, eng in built.engines.items():
            self._stream(eng)

    def _stream(self, eng) -> None:
        hook = eng.on_token

        def on_token(rid, tok, t):
            if rid not in self.first:
                self.first[rid] = t
                self.tokens[rid] = []
            self.last[rid] = t
            self.tokens[rid].append(int(tok))
            self.token_t.append(t)
            if hook is not None:
                hook(rid, tok, t)
        eng.on_token = on_token

    def attach_detail(self, built: Built) -> None:
        for tier, eng in built.engines.items():
            self._spans(tier, eng)

    def _spans(self, tier: str, eng) -> None:
        step = _hook("engine", eng, "step")
        admit_group = _hook("engine", eng, "_admit_group")
        fused = _hook("engine", eng, "_fused")

        def step_span():
            t0 = time.monotonic()
            n = step()
            self.spans.append((f"{tier} engine.step", t0, time.monotonic()))
            return n

        def group_span(jobs, slots, bucket):
            rows = [(len(j["tokens"]), "patches" in j["extras"])
                    for j in jobs]
            t0 = time.monotonic()
            out = admit_group(jobs, slots, bucket)
            t1 = time.monotonic()
            self.groups.append((tier, t0, t1, rows))
            self.spans.append((f"{tier} prefill group", t0, t1))
            return out

        def fused_span(tokens, positions, budgets, teff, k_steps, rids):
            live = np.asarray(budgets) > 0
            pos = np.asarray(positions)[live].copy()
            bud = np.asarray(budgets)[live].copy()
            t0 = time.monotonic()
            out = fused(tokens, positions, budgets, teff, k_steps, rids)
            t1 = time.monotonic()
            self.blocks.append((tier, t0, t1, pos, bud, int(k_steps)))
            self.spans.append((f"{tier} fused decode block", t0, t1))
            return out
        eng.step, eng._admit_group, eng._fused = (step_span, group_span,
                                                  fused_span)


# ---------------------------------------------------------------------------
# driving the traffic
# ---------------------------------------------------------------------------


@dataclass
class Sent:
    """One request the harness sent."""

    rid: int
    due: float
    spec: object
    ids: np.ndarray
    request: object


class Driver:
    """Sends a mix's requests through the server and keeps what it sent."""

    def __init__(self, built: Built, traffic, images: List[np.ndarray]):
        self.built = built
        self.server = built.server
        self.traffic = traffic
        self.images = images
        self.sent: Dict[int, Sent] = {}
        self.resolved: Dict[int, object] = {}
        self._n = 0
        self._seen = 0

    def request(self, spec, due: Optional[float] = None,
                stream: int = 5) -> Sent:
        ids = self.traffic.prompt_ids(spec, self._n, stream)
        self._n += 1
        img = self.images[spec.image] if spec.image >= 0 else None
        req = self.server.build_request("", img, max_new=spec.max_new,
                                        slo_s=self.traffic.slo_s,
                                        prompt_ids=ids)
        if due is not None:
            req.arrival_s = due
        s = Sent(req.rid, req.arrival_s, spec, ids, req)
        self.sent[req.rid] = s
        return s

    def submit(self, s: Sent) -> None:
        self.server.submit_request(s.request)

    def run(self, timeout_s: float) -> List[object]:
        """Drive for up to ``timeout_s``; returns the newly resolved."""
        res = self.server.run(timeout_s=max(timeout_s, 0.0))
        new = res[self._seen:]
        self._seen = len(res)
        for r in new:
            self.resolved[r.rid] = r
        return new

    def drain(self, rids, deadline: float) -> None:
        while (any(r not in self.resolved for r in rids)
               and time.monotonic() < deadline):
            self.run(deadline - time.monotonic())

    def warm(self) -> None:
        """The mix's warm-up burst, drained before the window."""
        offsets, specs = self.traffic.warm()
        if not specs:
            return
        t0 = time.monotonic() + 0.01
        rids = []
        for off, spec in zip(offsets, specs):
            s = self.request(spec, t0 + off, stream=6)
            self.submit(s)
            rids.append(s.rid)
        self.drain(rids, time.monotonic() + 120.0)
        if any(r not in self.resolved for r in rids):
            raise RuntimeError("the warm-up burst did not drain in 120 s")


@dataclass
class Window:
    t0: float
    t1: float
    rids: List[int]
    drain_end: float
    counters0: Dict
    counters1: Dict


def counters(built: Built) -> Dict:
    sched = built.server.scheduler
    out = {"score_time_s": sched.score_time_s, "n_scored": sched.n_scored}
    for tier, eng in built.engines.items():
        for k in ("steps", "decode_tokens", "prefill_tokens"):
            out[f"{tier}.{k}"] = getattr(eng, k)
    return out


def open_loop(drv: Driver, seconds: float, trace=None) -> Window:
    """Arrivals due on a fixed schedule from the window's start, whether or
    not earlier ones have finished; then a drain until every arrival of the
    window resolved or ``drain_s`` passed."""
    offsets, specs = drv.traffic.window(seconds)
    sent = [drv.request(spec) for spec in specs]
    if trace is not None:
        trace.start()
    t0 = time.monotonic()
    c0 = counters(drv.built)
    for s, off in zip(sent, offsets):
        s.request.arrival_s = s.due = t0 + float(off)
        drv.submit(s)
    end = t0 + seconds
    while time.monotonic() < end:
        drv.run(end - time.monotonic())
    t1 = time.monotonic()
    c1 = counters(drv.built)
    if trace is not None:
        trace.stop()
    rids = [s.rid for s in sent]
    # the drain starts once the profiler has stopped, which takes seconds
    drv.drain(rids, time.monotonic() + float(drv.traffic.mix["drain_s"]))
    return Window(t0, t1, rids, time.monotonic(), c0, c1)


def closed_loop(drv: Driver, seconds: float, trace=None,
                probe: Optional[Probe] = None) -> Window:
    """``clients`` clients, each sending its next request when its last one
    completes. The ramp (every client's first request admitted, or queued
    behind a tier whose slots are all busy) is set-up; the window counts
    every token streamed inside it."""
    mix = drv.traffic.mix
    clients = int(mix["clients"])
    queue = drv.traffic.stream()
    active: Dict[int, int] = {}

    def send(client: int) -> None:
        s = drv.request(next(queue))
        drv.submit(s)
        active[s.rid] = client

    def step(timeout_s: float) -> None:
        for r in drv.run(timeout_s):
            client = active.pop(r.rid, None)
            if client is not None:
                send(client)

    def ramped() -> bool:
        full = {t: e.free_slot_count() == 0
                for t, e in drv.built.engines.items()}
        for rid in first_round:
            if rid in probe.first:
                continue
            if not any(full[t] and any(j["rid"] == rid for j in e.waiting)
                       for t, e in drv.built.engines.items()):
                return False
        return True

    for c in range(clients):
        send(c)
    first_round = set(active)
    deadline = time.monotonic() + float(mix["ramp_timeout_s"])
    while not ramped():
        if time.monotonic() > deadline:
            raise RuntimeError("the closed loop's ramp did not fill the "
                               f"slots in {mix['ramp_timeout_s']} s")
        step(0.01)
    if trace is not None:
        trace.start()
    t0 = time.monotonic()
    c0 = counters(drv.built)
    window_rids = set(active)
    end = t0 + seconds
    while time.monotonic() < end:
        window_rids.update(active)
        step(0.01)
    t1 = time.monotonic()
    c1 = counters(drv.built)
    if trace is not None:
        trace.stop()
    window_rids.update(active)
    return Window(t0, t1, sorted(window_rids), t1, c0, c1)
