"""Calibrated accuracy model P(correct | difficulty, tier).

The simulator's ground truth. Shape chosen so that (a) easy requests are
answered equally well by both tiers — the property MoA-Off exploits — and
(b) the tier MEANS over the request distribution match the paper's Table 1
endpoints (cloud-only ~76-78%, edge-only ~61-64% on VQAv2; slightly lower on
MMBench). MoA-Off / PerLLM accuracies are NOT fitted — they emerge from
routing, which is the point of the reproduction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AccuracyModel:
    # P(correct | d) = base - slope*d - cliff*max(0, d - knee)
    # knee ~= τ: requests below the offloading threshold are answered (almost)
    # as well by the edge model — the property the MoA-Off routing exploits;
    # above it the weak model degrades steeply (matches the 15pp edge-cloud
    # gap of Table 1 given the synthetic difficulty distribution)
    base: float = 0.935
    cloud_slope: float = 0.32
    edge_slope: float = 0.32
    edge_knee: float = 0.50
    edge_cliff: float = 2.4
    late_penalty: float = 0.9  # SLO-missed responses lose some utility

    def p_correct(self, difficulty: float, tier: str,
                  capability: float = None) -> float:
        """P(correct). ``capability`` ∈ [0,1] interpolates the cliff between
        the edge curve (0.0) and the cloud curve (1.0); when omitted it is
        inferred from the legacy tier name."""
        d = float(np.clip(difficulty, 0.0, 1.0))
        if capability is None:
            # conservative fallback: only the literal cloud tier gets the
            # cliff-free curve; unknown tier names behave edge-grade
            capability = 1.0 if tier == "cloud" else 0.0
        p = self.base - self.cloud_slope * d
        p -= (1.0 - float(np.clip(capability, 0.0, 1.0))) \
            * self.edge_cliff * max(0.0, d - self.edge_knee)
        return float(np.clip(p, 0.02, 0.99))

    def sample(self, rng: np.random.Generator, difficulty: float, tier: str,
               on_time: bool = True, capability: float = None) -> bool:
        p = self.p_correct(difficulty, tier, capability)
        if not on_time:
            p *= self.late_penalty
        return bool(rng.random() < p)

    def mean_accuracy(self, tier: str, n: int = 20001,
                      capability: float = None) -> float:
        ds = np.linspace(0, 1, n)
        return float(np.mean([self.p_correct(d, tier, capability)
                              for d in ds]))


# dataset-flavoured variants (MMBench is a bit harder across the board)
VQAV2 = AccuracyModel()
MMBENCH = AccuracyModel(base=0.925, cloud_slope=0.34, edge_cliff=2.6)
