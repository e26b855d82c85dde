"""Serving launcher: MoA-Off scheduler + live engines on reduced models,
driven by a synthetic request stream through the unified cluster runtime.
Counterpart of ``repro/launch/serve.py``; the engines run on ``--device``
(``cuda`` by default, ``cpu`` on request).

Default is the paper's two-tier edge/cloud pair; ``--topology`` selects any
registered ``ClusterTopology`` (e.g. ``edge-regional-cloud``) and spins up
one reduced-model engine per tier. ``--arrival-rate`` paces arrivals as an
open-loop Poisson process, and ``--hedge-after`` / ``--fail-rate`` exercise
straggler hedging and snapshot/restore fault recovery against the live
engines (the same lifecycle the simulator models virtually). ``--fault-plan``
injects a deterministic chaos schedule (timed crash/slow/degrade/flap
windows), and ``--quarantine-after`` / ``--retry-backoff`` / ``--shed``
enable the tier-health circuit breaker, retry backoff and deadline-aware
load shedding. ``--byzantine`` adds message-level wire faults (frame
corruption, drops, dups, reorders — all detected by checksums and the
exactly-once delivery ledger) and ``--audit`` runs the runtime invariant
auditor at completion. ``--sessions N --turns T`` serves a multi-turn chat
workload whose later turns resume their parked KV, ``--prefix-cache-mb``
turns on the prefix store, and ``--migrate`` (with ``--hedge-in-service``
or ``--migrate-threshold``) moves in-flight slots between tiers.

PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --bandwidth 300e6
PYTHONPATH=src python -m repro_torch.launch.serve --topology edge-regional-cloud
PYTHONPATH=src python -m repro_torch.launch.serve --arrival-rate 4 --hedge-after 1
PYTHONPATH=src python -m repro_torch.launch.serve --sessions 2 --turns 2 --prefix-cache-mb 64 --migrate
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from repro_torch.config import (TOPOLOGIES, ResilienceConfig, ServingConfig,
                                get_topology)
from repro_torch.data.synthetic import make_image
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.tiers import ClusterServer, build_cluster_engines

build_engines = build_cluster_engines  # legacy alias


def parse_replicas(specs) -> dict:
    """Parse repeated ``--replicas tier=N`` flags into {tier: N}."""
    out = {}
    for spec in specs or ():
        tier, _, n = spec.partition("=")
        if not tier or not n.isdigit() or int(n) < 1:
            raise SystemExit(f"--replicas expects tier=N with N >= 1, "
                             f"got {spec!r}")
        out[tier] = int(n)
    return out


# flags whose engine paths this port does not have yet -> their ROADMAP item
_UNPORTED = {
    "speculate": ("--speculate", "item 9 (speculative decoding)"),
}


def _refuse_unported(args) -> None:
    """Exit with a message for every flag whose path is not ported; a flag
    is never silently ignored."""
    for attr, (flag, item) in _UNPORTED.items():
        if getattr(args, attr):
            raise SystemExit(f"{flag} is not ported to repro_torch yet: "
                             f"ROADMAP queue 1, {item}")
    if args.transport != "local":
        raise SystemExit("--transport process is not ported to repro_torch "
                         "yet: ROADMAP queue 1, item 10 (replica processes)")


def _local_pools(topo, sv: ServingConfig, counts: dict, device: str) -> dict:
    """Replicated tiers behind in-process transports on ``device``: the
    replicas of a tier share one model and its parameters."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine
    from repro_torch.serving.pool import EnginePool
    from repro_torch.serving.transport import LocalTransport

    pools = {}
    for i, tier in enumerate(topo.tiers):
        cfg = reduced_config(tier.model).replace(dtype="float32")
        model = build_model(cfg, device=device)
        params = model.init(i)
        pools[tier.name] = EnginePool(tier.name, [
            LocalTransport(TierEngine(model, params, sv))
            for _ in range(counts[tier.name])])
    return pools


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--bandwidth", type=float, default=None,
                    help="override every remote uplink (bps); default keeps "
                         "the topology's declared links")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused-steps", type=int, default=8,
                    help="decode steps fused per host call (1 = legacy "
                         "per-token path)")
    ap.add_argument("--decode-impl", default="auto",
                    choices=["auto", "torch", "cuda"],
                    help="decode attention backend (auto = the CUDA kernel "
                         "for CUDA tensors, plain PyTorch on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device the engines and the image-statistics "
                         "kernel run on")
    ap.add_argument("--topology", default="edge-cloud",
                    choices=sorted(TOPOLOGIES),
                    help="cluster topology to serve (one engine per tier)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in req/s; 0 = "
                         "submit everything immediately (closed batch)")
    ap.add_argument("--hedge-after", type=float, default=0.0,
                    help="clone a still-queued request onto the least-"
                         "loaded other tier after this many seconds "
                         "(first finisher wins, loser is cancelled)")
    ap.add_argument("--fail-rate", type=float, default=0.0,
                    help="probability an enqueued request kills its node; "
                         "the engine is rebuilt from its last snapshot")
    ap.add_argument("--fault-plan", default=None, metavar="JSON",
                    help="deterministic chaos schedule: inline JSON (or a "
                         "path to a JSON file) of timed crash/slow/degrade/"
                         "flap windows — see repro.serving.faults.FaultPlan")
    ap.add_argument("--byzantine", default=None, metavar="JSON",
                    help="byzantine wire-fault schedule: inline JSON (or a "
                         "path) of corrupt/msg_drop/msg_dup/msg_reorder "
                         "windows, merged into --fault-plan; or "
                         "'storm[:SEED]' for the canned whole-run storm")
    ap.add_argument("--audit", action="store_true",
                    help="run the InvariantAuditor at completion: "
                         "exactly-once outcomes, clean delivery ledgers, "
                         "no stuck stations, KV page conservation")
    ap.add_argument("--retry-backoff", action="store_true",
                    help="capped exponential backoff with deterministic "
                         "jitter between fault retries (instead of "
                         "immediate re-enqueue)")
    ap.add_argument("--shed", action="store_true",
                    help="load shedding: fail a request up front (terminal "
                         "'shed' outcome) when it is already past its SLO "
                         "at first enqueue or at a retry")
    ap.add_argument("--quarantine-after", type=int, default=0,
                    help="open a tier's circuit breaker after this many "
                         "consecutive service failures and re-route its "
                         "traffic to the best available tier until a probe "
                         "succeeds (0 = health tracking off)")
    ap.add_argument("--migrate", action="store_true",
                    help="cross-tier KV migration: hedged clones of "
                         "in-service stragglers receive the donor's "
                         "extracted cache slot instead of re-prefilling, "
                         "and fault recovery re-homes in-flight slots onto "
                         "surviving compatible tiers")
    ap.add_argument("--hedge-in-service", action="store_true",
                    help="hedge mid-decode stragglers too (speculative "
                         "backup clones; with --migrate they receive the "
                         "donor's cache rows instead of re-prefilling)")
    ap.add_argument("--migrate-threshold", type=int, default=0,
                    help="preempt-migrate the in-service request with the "
                         "most remaining decode work when a tier's "
                         "occupancy (active + queued) reaches this value "
                         "(0 = off; implies --migrate)")
    ap.add_argument("--speculate", default=None, metavar="DRAFT:TARGET",
                    help="cross-tier speculative decoding: the DRAFT tier "
                         "drafts token blocks that the TARGET tier verifies "
                         "in one batched decode step (e.g. edge:cloud); "
                         "requests fused on TARGET speculate when the "
                         "acceptance-rate EWMA clears SpecConfig.min_accept")
    ap.add_argument("--slo", type=float, default=5.0,
                    help="per-request SLO in seconds (drives EDF admission "
                         "and the on-time/goodput accounting)")
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="per-engine prefix store budget in MB: prompts "
                         "extending a cached prefix (e.g. a shared system "
                         "prompt) copy its KV rows and prefill only the "
                         "suffix (0 = off)")
    ap.add_argument("--sessions", type=int, default=0,
                    help="serve a multi-turn chat workload instead of "
                         "single-shot requests: this many sessions of "
                         "--turns turns each (shared system prompt); a "
                         "finished turn's KV parks on its tier and the "
                         "next turn resumes it, prefilling only the new "
                         "tokens")
    ap.add_argument("--turns", type=int, default=3,
                    help="turns per session (with --sessions)")
    ap.add_argument("--session-move-threshold", type=int, default=0,
                    help="ship a parked session to the scheduler's "
                         "preferred compatible tier when the parked tier "
                         "is this much deeper in occupancy (0 = always "
                         "sticky)")
    ap.add_argument("--max-seq", type=int, default=128,
                    help="engine cache capacity (grow it for long "
                         "multi-turn histories)")
    ap.add_argument("--paged", dest="paged", action="store_true",
                    default=True,
                    help="paged KV pool with continuous admission and "
                         "copy-free CoW prefix sharing (launcher default)")
    ap.add_argument("--no-paged", dest="paged", action="store_false",
                    help="escape hatch: dense per-slot KV cache")
    ap.add_argument("--kv-page-size", type=int, default=64,
                    help="KV rows per physical page (power of two dividing "
                         "--max-seq; with --paged)")
    ap.add_argument("--replicas", action="append", metavar="TIER=N",
                    help="replicate a tier's engine N ways behind a "
                         "load-balanced pool (repeatable, e.g. "
                         "--replicas edge=2 --replicas cloud=4); "
                         "unlisted tiers keep one replica")
    ap.add_argument("--transport", default="local",
                    choices=["local", "process"],
                    help="replica execution: 'local' steps every replica "
                         "in this process (parity/debug baseline); "
                         "'process' runs each replica in its own worker "
                         "process behind the message transport")
    ap.add_argument("--idle-poll", type=float, default=0.0,
                    help="idle-wait cap in seconds for the serving loop "
                         "(0 = event-driven: sleep until the next "
                         "scheduled event)")
    args = ap.parse_args(argv)
    _refuse_unported(args)

    sv = ServingConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                       fused_steps=args.fused_steps,
                       decode_impl=args.decode_impl,
                       prefix_cache_mb=args.prefix_cache_mb,
                       paged=args.paged, kv_page_size=args.kv_page_size,
                       idle_poll_s=args.idle_poll)
    topo = get_topology(args.topology)
    if args.bandwidth is not None:
        topo = dataclasses.replace(topo, tiers=tuple(
            dataclasses.replace(t, uplink_bps=args.bandwidth)
            if t.is_remote else t for t in topo.tiers))
    print(f"topology {topo.name}: tiers {', '.join(topo.names)}")
    plan = None
    if args.fault_plan:
        raw = args.fault_plan
        if os.path.exists(raw):
            raw = open(raw).read()
        plan = FaultPlan.from_json(raw)
    if args.byzantine:
        raw = args.byzantine
        if raw.startswith("storm"):
            _, _, s = raw.partition(":")
            byz = FaultPlan.byzantine_storm(seed=int(s) if s else args.seed)
        else:
            if os.path.exists(raw):
                raw = open(raw).read()
            byz = FaultPlan.from_json(raw)
        if plan is None:
            plan = byz
        else:  # merge wire faults into the timed chaos schedule
            plan = FaultPlan(list(plan.events) + list(byz.events),
                             fail_rate=plan.fail_rate,
                             wire_seed=byz.wire_seed or plan.wire_seed)
        kinds = sorted({e.kind for e in byz.events})
        print(f"byzantine wires: {', '.join(kinds)} "
              f"(wire_seed={plan.wire_seed})")
    resilience = None
    if args.quarantine_after > 0 or args.retry_backoff or args.shed:
        resilience = ResilienceConfig(
            health=args.quarantine_after > 0,
            quarantine_after=max(args.quarantine_after, 1),
            retry_backoff=args.retry_backoff, shed=args.shed)
    reps = parse_replicas(args.replicas)
    unknown = set(reps) - set(topo.names)
    if unknown:
        raise SystemExit(f"--replicas names unknown tiers {sorted(unknown)} "
                         f"(topology has {list(topo.names)})")
    if reps:
        counts = {name: reps.get(name, 1) for name in topo.names}
        engines = _local_pools(topo, sv, counts, args.device)
        rep_str = " ".join(f"{t}x{n}" for t, n in sorted(counts.items()))
        print(f"replicas: {rep_str} | transport {args.transport}")
    else:
        engines = build_engines(topo, sv, device=args.device)
    server = ClusterServer(engines, topology=topo,
                           hedge_after_s=args.hedge_after,
                           fail_rate=args.fail_rate, migrate=args.migrate,
                           migrate_threshold=args.migrate_threshold,
                           hedge_in_service=args.hedge_in_service,
                           sessions=args.sessions > 0,
                           session_move_threshold=args.session_move_threshold,
                           fault_plan=plan, resilience=resilience,
                           audit=args.audit)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    if args.sessions > 0:
        system = "you are a Helpful assistant; answer with Care. "
        for turn in range(args.turns):
            delay = 0.0
            for s in range(args.sessions):
                if args.arrival_rate > 0:
                    delay += rng.exponential(1.0 / args.arrival_rate)
                text = (system if turn == 0 else "") + (
                    f"turn {turn}: tell me more about Topic {s}. ")
                server.submit_turn(f"chat-{s}", text, max_new=args.max_new,
                                   slo_s=args.slo, delay_s=delay)
            server.run()  # turns of one session are sequential
        results = server.results
    else:
        delay = 0.0
        for i in range(args.requests):
            u = rng.beta(1.6, 1.6)
            img = make_image(rng, u, 64, 64)
            text = (f"Request {i}: describe the Scene {i * 3}. "
                    + "and then explain why it matters. "
                    * rng.integers(1, 12))
            if args.arrival_rate > 0:
                delay += rng.exponential(1.0 / args.arrival_rate)
            server.submit(text, image=img, max_new=args.max_new,
                          slo_s=args.slo, delay_s=delay)
        results = server.run()
    wall = time.perf_counter() - t0
    per_tier = {}
    for r in results:
        per_tier[r.tier] = per_tier.get(r.tier, 0) + 1
    lat = np.mean([r.latency_s for r in results])
    ttft = np.mean([r.ttft_s for r in results])
    on_time = sum(r.on_time for r in results)
    split = " ".join(f"{t}={n}" for t, n in sorted(per_tier.items()))
    print(f"served {len(results)} requests | {split} | mean latency "
          f"{lat:.3f}s | mean ttft {ttft:.3f}s | {on_time}/{len(results)} "
          f"within SLO | goodput {on_time / max(wall, 1e-9):.2f} req/s")
    hedged = sum(r.hedged for r in results)
    retries = sum(r.retries for r in results)
    trunc = sum(r.truncated for r in results)
    if hedged or retries or trunc:
        print(f"hedged={hedged} retries={retries} truncated={trunc} "
              f"engine restores={server.backend.restores}")
    failed = sum(r.failed for r in results)
    if plan is not None or resilience is not None or failed:
        shed = sum(r.fail_reason == "shed" for r in results)
        degraded = sum(r.degraded for r in results)
        ok = sum((not r.failed) and r.on_time for r in results)
        health = server.runtime.health
        states = (" ".join(f"{t}={s}" for t, s in
                           sorted(health.snapshot().items()))
                  if health is not None else "off")
        print(f"resilience: failed={failed - shed} shed={shed} "
              f"degraded={degraded} | goodput {ok}/{len(results)} | "
              f"quarantines={health.quarantine_count if health else 0} "
              f"rescued-sessions={server.runtime.rescued_sessions} | "
              f"health {states}")
    if server.runtime.migrate:
        mig = sum(r.migrated for r in results)
        mb = sum(r.migration_bytes for r in results)
        print(f"migrated={mig} requests ({server.runtime.migrations} slot "
              f"moves, {mb / 1e6:.2f} MB of cache rows shipped)")
    if args.sessions > 0 or args.prefix_cache_mb > 0:
        resumed = sum(r.warm == "resume" for r in results)
        hits = sum(r.warm == "prefix" for r in results)
        saved = sum(r.warm_tokens for r in results)
        print(f"sessions: {resumed} resumed turns, {hits} prefix hits, "
              f"{saved:.0f} cached tokens never re-prefilled, "
              f"{server.runtime.session_moves} parked-state moves")
    ws = server.runtime.wire_stats
    if args.byzantine or args.audit or ws:
        print(f"wire: corruptions {ws.get('corrupt_detected', 0)}/"
              f"{ws.get('corrupt_injected', 0)} detected "
              f"(undetected={ws.get('corrupt_undetected', 0)}) | "
              f"dropped={ws.get('msgs_dropped', 0)} "
              f"duped={ws.get('msgs_duped', 0)} "
              f"reordered={ws.get('msgs_reordered', 0)} | "
              f"dups suppressed={ws.get('dups_suppressed', 0)} "
              f"dup finishes={ws.get('dup_finishes_suppressed', 0)} "
              f"resyncs={ws.get('resyncs', 0)}")
    if args.audit:
        verdict = server.runtime.auditor.last
        if verdict.get("clean"):
            print(f"audit: CLEAN ({verdict['requests']} requests, "
                  f"{verdict['outcomes']} outcomes, every invariant held)")
        else:
            print(f"audit: {len(verdict.get('violations', []))} "
                  f"VIOLATION(S)")
            for v in verdict.get("violations", []):
                print(f"  ! {v}")
    dec = sum(p.decode_tokens for p in server.pools.values())
    pre = sum(p.prefill_tokens for p in server.pools.values())
    enc = sum(p.encode_tokens for p in server.pools.values())
    print(f"engine throughput: {dec / max(wall, 1e-9):.1f} decode tok/s, "
          f"{pre} prompt tokens prefilled, {enc} patch tokens encoded "
          f"({server.backend.offloaded_encodes} images encoded off-fusion; "
          f"fused_steps={args.fused_steps})")
    for tier, pool in sorted(server.pools.items()):
        if len(pool) == 1 and pool.transports[0].kind == "local":
            continue  # unreplicated local tier: nothing pool-level to add
        rows = " | ".join(
            f"r{s['replica']}[{s['kind'][0]}]"
            f"{' DEAD' if not s['alive'] else ''} "
            f"active={s['active']}/{s['slots']} queue={s['queue']} "
            f"kv={s['kv_headroom']:.2f} dec={s['decode_tokens']}"
            for s in pool.replica_stats())
        print(f"  replicas[{tier}]: {rows}")
    if args.paged:
        for tier, pool in sorted(server.pools.items()):
            for i, tr in enumerate(pool.transports):
                if tr.kind != "local":
                    continue  # gauges live in the worker process
                g = tr.engine.kv_gauges()
                name = tier if len(pool) == 1 else f"{tier}/{i}"
                print(f"  kv[{name}]: {g['pages_free']}/{g['pages_total']} "
                      f"pages free, {g['pages_shared']} shared (CoW), "
                      f"high-water {g['pages_high_water']} "
                      f"({g['pages_high_water'] * g['page_bytes'] / 1e6:.2f} "
                      f"MB peak)")
    for r in sorted(results, key=lambda r: r.rid)[:10]:
        flags = "".join(f" {f}" for f, on in
                        (("hedged", r.hedged), ("truncated", r.truncated),
                         (f"retries={r.retries}", r.retries)) if on)
        print(f"  rid={r.rid} tier={r.tier:9s} routes={r.routes} "
              f"lat={r.latency_s:.3f}s ttft={r.ttft_s:.3f}s{flags}")
    server.close()  # joins process-transport workers; no-op for local


if __name__ == "__main__":
    main()
