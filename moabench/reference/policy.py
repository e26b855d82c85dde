"""Plain reference of the MoA-Off control plane's decisions (paper 3.2) and
of the modelled WAN uplink, as a configuration states them.

* Eq. 5 for one modality on the local tier: the edge keeps it iff
  ``c <= tau``, the edge's load is at most ``edge_load_max`` and the
  bandwidth reading is at most ``bandwidth_beta``; otherwise it goes to
  the remote tier whose capability-scaled threshold accepts it.
* Eq. 6: the fused generation runs on the most capable tier any modality
  went to.
* The adaptive threshold: after each decision every tau moves by
  ``tau_step`` against the queue imbalance between local and remote tiers
  (down when the local queues are deeper or a local tier is overloaded,
  up when the remote ones are), clipped to [0.05, 0.95].
* The uplink: one FIFO server a remote tier. A request's payload (its
  modalities routed to the remote tier, the embeddings of images encoded
  on the edge for a remote fusion, at least ``prompt_floor_bytes``) is
  sent when it arrives or when the link frees, and lands after
  ``rtt_s + 8 * bytes / uplink_bps``. Its WAN time is landing - arrival.
* The system state: each observation the runtime feeds the scheduler
  (the tiers' occupancy, queue depths and the WAN bandwidth) moves the
  loads and the bandwidth by an EWMA of weight ``ewma_alpha``; queue
  depths are taken as observed.

The inputs are the scores the program decided with (``score_gap`` holds
them to the reference scorer) and the raw observations it fed its state
estimator, recorded at each call. The state and the threshold are the
reference's own, carried from the configuration's start values through
every observation and decision.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def _local(tiers: Sequence[Dict]) -> List[Dict]:
    return [t for t in tiers if float(t["uplink_bps"]) <= 0]


def _remote(tiers: Sequence[Dict]) -> List[Dict]:
    return [t for t in tiers if float(t["uplink_bps"]) > 0]


def _healthy(tiers: Sequence[Dict], health: Dict[str, str]) -> List[Dict]:
    ok = [t for t in tiers
          if health.get(t["name"], "healthy") not in ("quarantined",
                                                      "probing")]
    return ok or list(tiers)


def route(c: float, tau: float, state: Dict, pol: Dict,
          tiers: Sequence[Dict]) -> str:
    """Eq. 5 for one modality of complexity ``c`` under ``state``."""
    health = state.get("health", {})
    loads = state["loads"]
    keep = []
    for t in _healthy(_local(tiers), health):
        load_ok = loads.get(t["name"], 0.0) <= pol["edge_load_max"]
        if pol["paper_faithful_bandwidth"]:
            edge = (c <= tau and load_ok
                    and state["bandwidth_bps"] <= pol["bandwidth_beta"])
        else:
            feasible = state["bandwidth_bps"] >= pol["bandwidth_beta"] * 0.1
            edge = (c <= tau and load_ok) or not feasible
        if edge:
            keep.append(t)
    if len(keep) > 1:
        raise NotImplementedError("more than one eligible local tier")
    if keep:
        return keep[0]["name"]
    remotes = _healthy(_remote(tiers), health)
    ok = [t for t in remotes
          if c <= tau + (1.0 - tau) * float(t["capability"])]
    if len(ok) > 1:
        raise NotImplementedError("more than one eligible remote tier")
    if ok:
        return ok[0]["name"]
    return max(_remote(tiers), key=lambda t: float(t["capability"]))["name"]


def fusion(routes: Dict[str, str], tiers: Sequence[Dict]) -> str:
    """Eq. 6: the most capable routed tier (remote before local, then by
    name, on a tie)."""
    by = {t["name"]: t for t in tiers}
    return max(sorted(set(routes.values())),
               key=lambda n: (float(by[n]["capability"]),
                              float(by[n]["uplink_bps"]) > 0, n))


def update(taus: Dict[str, float], state: Dict, pol: Dict,
           tiers: Sequence[Dict]) -> Dict[str, float]:
    """The adaptive threshold after one decision."""
    if not pol["adaptive_tau"]:
        return dict(taus)
    local = {t["name"] for t in _local(tiers)}
    qd = state["queue_depths"]
    qe = sum(d for t, d in qd.items() if t in local)
    qc = sum(d for t, d in qd.items() if t not in local)
    top = max((state["loads"].get(t, 0.0) for t in local), default=0.0)
    imbalance = (qe - qc) / (qe + qc + 4.0)
    if abs(imbalance) < 0.25 and top <= pol["edge_load_max"]:
        return dict(taus)
    delta = (-pol["tau_step"] if imbalance > 0 or top > pol["edge_load_max"]
             else pol["tau_step"])
    return {m: min(0.95, max(0.05, v + delta)) for m, v in taus.items()}


def observe(state: Dict, loads: Dict[str, float],
            queue_depths: Dict[str, int], bandwidth_bps, pol: Dict) -> Dict:
    """The state after one observation."""
    a = pol["ewma_alpha"]
    out = {"loads": dict(state["loads"]),
           "queue_depths": dict(state["queue_depths"]),
           "bandwidth_bps": state["bandwidth_bps"], "health": {}}
    for t, v in loads.items():
        out["loads"][t] = (1 - a) * out["loads"].get(t, 0.0) + a * float(v)
    for t, d in queue_depths.items():
        out["queue_depths"][t] = int(d)
    if bandwidth_bps is not None:
        out["bandwidth_bps"] = ((1 - a) * out["bandwidth_bps"]
                                + a * float(bandwidth_bps))
    return out


def decisions(recorded: Sequence[Dict], observations: Sequence[tuple],
              pol: Dict, tiers: Sequence[Dict]
              ) -> List[Tuple[Dict, Dict, Dict, str]]:
    """For each recorded decision, in the order they were made: the state
    and the thresholds the reference holds when it is made, its routes and
    its fusion tier. ``observations`` are (decisions made before it,
    loads, queue depths, bandwidth) in the order they were fed."""
    names = [t["name"] for t in tiers]
    state = {"loads": {n: 0.0 for n in names},
             "queue_depths": {n: 0 for n in names},
             "bandwidth_bps": float(pol["initial_bandwidth_bps"]),
             "health": {}}
    taus = {m: float(v) for m, v in pol["taus"].items()}
    out, k = [], 0
    for i, d in enumerate(recorded):
        while k < len(observations) and observations[k][0] <= i:
            state = observe(state, *observations[k][1:], pol)
            k += 1
        routes = {m: route(float(c), taus.get(m, 0.5), state, pol, tiers)
                  for m, c in d["scores"].items()}
        out.append((state, dict(taus), routes, fusion(routes, tiers)))
        taus = update(taus, state, pol, tiers)
    return out


def payload_bytes(routes: Dict[str, str], sizes: Dict[str, Tuple[str, int]],
                  fusion_tier: str, tiers: Sequence[Dict],
                  wan: Dict) -> Dict[str, float]:
    """Bytes each remote tier's uplink carries for one request. ``sizes``
    maps a modality to (kind, count): pixels of an image, tokens of a
    text."""
    by = {t["name"]: t for t in tiers}
    out: Dict[str, float] = {}
    for m, tier in routes.items():
        if float(by[tier]["uplink_bps"]) > 0:
            kind, n = sizes[m]
            b = (int(n * wan["image_bytes_per_pixel"]) if kind == "image"
                 else n * wan["text_bytes_per_token"])
            out[tier] = out.get(tier, 0.0) + b
    if float(by[fusion_tier]["uplink_bps"]) > 0:
        out[fusion_tier] = out.get(fusion_tier, 0.0) or float(
            wan["prompt_floor_bytes"])
        vis = by[fusion_tier]["model"]["vision_config"]
        for m, tier in routes.items():
            if sizes[m][0] == "image" and tier != fusion_tier:
                out[fusion_tier] += float(vis["num_patches"]
                                          * vis["frontend_dim"]
                                          * wan["embedding_bytes_per_value"])
    return out


def wan_seconds(arrivals: Sequence[Tuple[float, Dict[str, float]]],
                tiers: Sequence[Dict]) -> List[float]:
    """WAN time of each request, given in arrival order as (arrival time,
    bytes per remote tier): one FIFO server a link, every link in
    parallel, the request done when its last transfer lands."""
    by = {t["name"]: t for t in tiers}
    free: Dict[str, float] = {}
    out = []
    for t, per_tier in arrivals:
        done = t
        for tier in sorted(per_tier):
            spec = by[tier]
            start = max(t, free.get(tier, t))
            sec = float(spec["rtt_s"]) + 8.0 * per_tier[tier] / max(
                float(spec["uplink_bps"]), 1.0)
            free[tier] = start + sec
            done = max(done, start + sec)
        out.append(done - t)
    return out


def downlink_seconds(tier: Dict, tokens: int, wan: Dict) -> float:
    """The modelled return leg of ``tokens`` response tokens from a remote
    tier to the user (0 from a local one), over the uplink's rate."""
    bps = float(tier["uplink_bps"])
    if bps <= 0:
        return 0.0
    return float(tier["rtt_s"]) + 8.0 * tokens * wan[
        "response_bytes_per_token"] / bps
