"""The comparison that decides ``correct``.

Given what the timed path produced in a run (every request of the window
with its scores, and the tokens the program streamed for each finished
one), it computes the numbers a cell compares, each against the limit in
the cell's file:

* ``score_gap``: the largest gap between the program's complexity score of
  a modality and the reference's (``complexity.py``), over every scored
  image and text of the window;
* ``stream_faults``: finished requests whose stream is not what was asked
  (not exactly ``max_new`` tokens, since no token ends a request, or a
  token outside the vocabulary, or a result whose tokens are not the ones
  streamed); an exact count, limit 0;
* ``logit_gap.<tier>``: over a sample of the finished requests each tier
  served, the widest gap by which a served token's logit lies below the
  float32 reference's best logit at its position (``model.py``). The
  sample is drawn from the seed and holds each tier's longest request;
* ``route_faults``: decisions, of every request the run scored, whose
  system state, threshold, per-modality routes or serving tier differ from
  the plain estimator, Eq. 5/6 and adaptive threshold (``policy.py``) fed
  the same scores and observations; an exact count, limit 0;
* ``wan_faults``: requests whose modelled WAN time differs by more than
  a microsecond from the reference's FIFO uplink (``policy.py``) over the
  same arrivals and routes; an exact count, limit 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from moabench.reference import complexity, model
from moabench.reference import policy as ref_policy

#: how far a WAN time may sit from the reference's: float rounding of
#: times on the monotonic clock, far below any transfer
WAN_TOLERANCE_S = 1e-6


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 pixels rounded to bfloat16 (the scores' control)."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def score_gap(requests: Sequence[Dict], images: Sequence[np.ndarray],
              control: bool = False) -> float:
    """Largest |program score - reference score| over the window. With
    ``control``, the reference's own scores of bfloat16 pixels stand in
    for the program's."""
    ref_img: Dict[int, float] = {}
    gap = 0.0
    for r in requests:
        if r.get("c_text") is not None:
            gap = max(gap, abs(r["c_text"] - complexity.text_score(r["ids"])))
        k = r.get("image_index", -1)
        if k >= 0 and r.get("c_image") is not None:
            if k not in ref_img:
                ref_img[k] = complexity.image_score(images[k])
            got = (complexity.image_score(bf16_round(images[k])) if control
                   else r["c_image"])
            gap = max(gap, abs(got - ref_img[k]))
    return gap


def stream_faults(requests: Sequence[Dict], vocab: Dict[str, int]) -> int:
    bad = 0
    for r in requests:
        if not r.get("finished"):
            continue
        toks = np.asarray(r["tokens"], np.int64)
        if (len(toks) != r["max_new"] or toks.min(initial=0) < 0
                or toks.max(initial=0) >= vocab[r["tier"]]
                or list(r["result_tokens"]) != list(toks)):
            bad += 1
    return bad


def sample(requests: Sequence[Dict], seed: int, tokens_per_tier: int,
           max_per_tier: int) -> Dict[str, List[Dict]]:
    """The finished requests whose tokens the reference re-scores: per
    tier, the longest (most tokens, then longest prompt), then others in
    an order drawn from the seed until ``tokens_per_tier`` served tokens
    or ``max_per_tier`` requests."""
    rng = np.random.default_rng([int(seed), 7])
    by_tier: Dict[str, List[Dict]] = {}
    for r in requests:
        if r.get("finished"):
            by_tier.setdefault(r["tier"], []).append(r)
    out = {}
    for tier in sorted(by_tier):
        rs = by_tier[tier]
        longest = max(range(len(rs)), key=lambda i: (len(rs[i]["tokens"]),
                                                     len(rs[i]["ids"]), -i))
        order = [longest] + [int(i) for i in rng.permutation(len(rs))
                             if i != longest]
        pick, n = [], 0
        for i in order:
            if n >= tokens_per_tier or len(pick) >= max_per_tier:
                break
            pick.append(rs[i])
            n += len(rs[i]["tokens"])
        out[tier] = pick
    return out


def logit_gaps(picked: Dict[str, List[Dict]], archs: Dict, weights: Dict,
               images: Sequence[np.ndarray], device,
               quantize: Optional[str] = None) -> Dict[str, float]:
    """Widest served-token gap per tier (see ``model.served_gaps``)."""
    out = {}
    for tier, rs in picked.items():
        served = [{"ids": r["ids"], "tokens": r["tokens"],
                   "image": images[r["image_index"]]
                   if r["image_index"] >= 0 else None} for r in rs]
        gaps = model.served_gaps(archs[tier], weights[tier], served, device,
                                 quantize=quantize)
        out[tier] = float(max(float(g.max(initial=0.0)) for g in gaps))
    return out


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-9 * max(1.0, abs(b))


def route_faults(decided: Sequence[Dict], observations: Sequence[tuple],
                 cfg: Dict) -> int:
    """Decisions whose state, threshold, routes or serving tier are not
    the reference's. ``decided`` holds every decision of the run in
    order, each with the tier that served its request (None if none
    did)."""
    ref = ref_policy.decisions(decided, observations, cfg["policy"],
                               cfg["tiers"])
    bad = 0
    for d, (state, taus, routes, fusion) in zip(decided, ref):
        got = d["state"]
        same_state = (
            _close(got["bandwidth_bps"], state["bandwidth_bps"])
            and all(_close(got["loads"].get(t, 0.0), v)
                    for t, v in state["loads"].items())
            and all(got["queue_depths"].get(t, 0) == v
                    for t, v in state["queue_depths"].items())
            and not got["health"])
        same_tau = all(_close(d["taus"].get(m, 0.5), v)
                       for m, v in taus.items())
        served = d.get("served")
        if (not same_state or not same_tau or d["routes"] != routes
                or (served is not None and served != fusion)):
            bad += 1
    return bad


def wan_faults(decided: Sequence[Dict], cfg: Dict) -> int:
    """Requests whose WAN time is not the reference uplink's over the same
    arrivals, in the order the program decided them, and its routes."""
    arrivals = []
    for d in decided:
        fusion = ref_policy.fusion(d["routes"], cfg["tiers"])
        arrivals.append((d["arrival"], ref_policy.payload_bytes(
            d["routes"], d["sizes"], fusion, cfg["tiers"], cfg["wan"])))
    ref = ref_policy.wan_seconds(arrivals, cfg["tiers"])
    return sum(1 for d, w in zip(decided, ref)
               if d["wan_s"] is not None
               and not abs(d["wan_s"] - w) <= WAN_TOLERANCE_S)


def numbers(requests: Sequence[Dict], picked: Dict[str, List[Dict]],
            archs: Dict, weights: Dict, images: Sequence[np.ndarray],
            device, decided: Sequence[Dict], observations: Sequence[tuple],
            cfg: Dict) -> Dict[str, float]:
    """Every number a cell compares, by name."""
    out = {"score_gap": score_gap(requests, images),
           "stream_faults": float(stream_faults(
               requests, {t: a.vocab for t, a in archs.items()})),
           "route_faults": float(route_faults(decided, observations, cfg)),
           "wan_faults": float(wan_faults(decided, cfg))}
    for tier, g in logit_gaps(picked, archs, weights, images,
                              device).items():
        out[f"logit_gap.{tier}"] = g
    return out


def control_numbers(requests: Sequence[Dict],
                    picked: Dict[str, List[Dict]], archs: Dict,
                    weights: Dict, images: Sequence[np.ndarray],
                    device) -> Dict[str, float]:
    """The same numbers with the reference in the program's place, one
    precision below the configuration's: the scores of bfloat16 pixels
    (the scorer states float32) and the tokens of float8 weights (the
    models state bfloat16)."""
    out = {"score_gap": score_gap(requests, images, control=True)}
    for tier, g in logit_gaps(picked, archs, weights, images, device,
                              quantize="fp8").items():
        out[f"logit_gap.{tier}"] = g
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit in the cell's file is a fault."""
    rows, ok = [], True
    for name in sorted(nums):
        lim = limits.get(name)
        val = nums[name]
        good = lim is not None and np.isfinite(val) and val <= lim
        ok &= bool(good)
        rows.append((name, val, lim))
    return ok, rows
