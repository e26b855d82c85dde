"""Analytic per-request cost model: FLOPs, HBM bytes, transfer bytes, latency.

Drives the discrete-event simulator AND the roofline sanity checks. All
formulas derive from the real ModelConfig (param counts come from the same
spec trees that build the models — no hand-entered sizes).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.config import ModelConfig, TierConfig
from repro_torch.core.request import ModalityInput, Request


@functools.lru_cache(maxsize=64)
def _active_params(cfg: ModelConfig) -> int:
    return cfg.active_param_count()


@functools.lru_cache(maxsize=64)
def _kv_bytes_per_token(cfg: ModelConfig) -> int:
    """KV-cache bytes appended per generated/prefilled token (bf16)."""
    if cfg.family == "ssm":
        return 0  # O(1) state instead
    hd, k = cfg.resolved_head_dim, cfg.num_kv_heads
    n_attn = cfg.num_layers
    if cfg.family == "hybrid":
        n_attn = sum(1 for b in cfg.block_pattern if b == "local_attn") * (
            cfg.num_layers // len(cfg.block_pattern))
    return 2 * n_attn * k * hd * 2  # k+v, bf16


def prefill_flops(cfg: ModelConfig, prompt_tokens: int,
                  image_tokens: int = 0) -> float:
    """2·N_active per token matmul FLOPs + quadratic attention term."""
    s = prompt_tokens + image_tokens
    linear = 2.0 * _active_params(cfg) * s
    if cfg.family == "ssm":
        attn = 2.0 * cfg.num_layers * s * cfg.ssm_chunk * cfg.d_inner
    else:
        hd, h = cfg.resolved_head_dim, cfg.num_heads
        eff_ctx = s
        if cfg.family == "hybrid":
            eff_ctx = min(s, cfg.local_window)
        attn = 4.0 * cfg.num_layers * s * eff_ctx * h * hd / 2.0  # causal half
    return linear + attn


def decode_flops(cfg: ModelConfig, context_len: int) -> float:
    """FLOPs for ONE generated token at the given context length."""
    linear = 2.0 * _active_params(cfg)
    if cfg.family == "ssm":
        attn = 2.0 * cfg.num_layers * cfg.d_inner * cfg.ssm_state
    else:
        hd, h = cfg.resolved_head_dim, cfg.num_heads
        ctx = context_len
        if cfg.family == "hybrid":
            ctx = min(ctx, cfg.local_window)
        attn = 4.0 * cfg.num_layers * ctx * h * hd
    return linear + attn


def decode_hbm_bytes(cfg: ModelConfig, context_len: int) -> float:
    """HBM traffic for one decode step: weights + KV read (the decode bound)."""
    weight_bytes = 2.0 * _active_params(cfg)  # bf16 resident weights
    kv = _kv_bytes_per_token(cfg) * min(
        context_len,
        cfg.local_window if cfg.family == "hybrid" else context_len)
    if cfg.family == "ssm":
        kv = (cfg.num_layers * cfg.ssm_heads * cfg.ssm_head_dim
              * cfg.ssm_state * 4.0)
    return weight_bytes + kv


def weights_bytes(cfg: ModelConfig) -> float:
    return 2.0 * cfg.param_count()


@dataclass
class PhaseCost:
    flops: float
    hbm_bytes: float
    seconds: float


def phase_latency(flops: float, hbm_bytes: float, tier: TierConfig,
                  batch: int = 1) -> float:
    """Roofline latency on a tier: max(compute, memory) + dispatch."""
    t_c = flops / (tier.num_chips * tier.flops_per_s * tier.mfu)
    t_m = hbm_bytes / (tier.num_chips * tier.hbm_bw)
    return max(t_c, t_m) + tier.startup_s / max(batch, 1)


def request_phase_costs(cfg: ModelConfig, prompt_tokens: int,
                        image_tokens: int, decode_tokens: int,
                        tier: TierConfig,
                        cached_tokens: int = 0) -> Dict[str, PhaseCost]:
    """Phase costs of one request. ``cached_tokens`` > 0 is a prefix-cache /
    resumed-session hit: the leading tokens' KV rows are reused, so the
    prefill phase pays only the suffix — the quadratic attention discount
    falls out of the prefix-sum difference (suffix queries still attend the
    full context). HBM keeps the full-context KV traffic (cached rows are
    read back; suffix rows are written)."""
    pf = prefill_flops(cfg, prompt_tokens, image_tokens)
    if cached_tokens > 0:
        cached = min(int(cached_tokens), max(prompt_tokens + image_tokens - 1,
                                             0))
        pf = max(0.0, pf - prefill_flops(cfg, cached))
    pb = 2.0 * _active_params(cfg) + _kv_bytes_per_token(cfg) * (
        prompt_tokens + image_tokens)
    prefill = PhaseCost(pf, pb, phase_latency(pf, pb, tier))
    ctx = prompt_tokens + image_tokens
    df = db = 0.0
    dsec = 0.0
    for i in range(decode_tokens):
        f = decode_flops(cfg, ctx + i)
        b = decode_hbm_bytes(cfg, ctx + i)
        df += f
        db += b
    dsec = phase_latency(df, db, tier)  # amortized (continuous batching)
    return {"prefill": prefill, "decode": PhaseCost(df, db, dsec)}


def transfer_seconds(num_bytes: float, bandwidth_bps: float,
                     rtt_s: float) -> float:
    return rtt_s + 8.0 * num_bytes / max(bandwidth_bps, 1.0)


# -- return path (downlink) ---------------------------------------------------

#: bytes per generated token riding the downlink back to the user (token ids
#: / short detokenized text chunks)
RESPONSE_BYTES_PER_TOKEN = 4.0


def downlink_seconds(num_tokens: float, spec) -> float:
    """Seconds for ``num_tokens`` of response to ride a remote tier's
    downlink back to the user (0 for local tiers). ``TierSpec.downlink_bps``
    sizes the return path; 0 falls back to the (usually symmetric) uplink."""
    if not getattr(spec, "is_remote", False):
        return 0.0
    bps = getattr(spec, "downlink_bps", 0.0) or spec.uplink_bps
    return transfer_seconds(num_tokens * RESPONSE_BYTES_PER_TOKEN, bps,
                            spec.rtt_s)


def embedding_bytes(cfg: ModelConfig) -> float:
    """Bytes of compact patch embeddings shipped for ONE off-fusion image in
    the fusion model's geometry (fp32, matching the live backend's
    ``TierEngine.encode_image`` payload)."""
    return float((cfg.num_patches or 256)
                 * (cfg.frontend_dim or cfg.d_model) * 4.0)


# -- cross-tier speculative decoding ------------------------------------------


def speculation_uplink_bytes(decode_tokens: int, k: int,
                             accept_rate: float) -> float:
    """Expected draft-block bytes riding the target tier's uplink for one
    speculated request: every verify round ships ``k`` proposed token ids
    (priced like the embed_bytes fusion uplink — one lump charged at
    arrival by both execution backends)."""
    a = min(max(float(accept_rate), 0.0), 1.0)
    per_round = a * k + 1.0  # expected commits per round (accepts + bonus)
    rounds = float(np.ceil(max(int(decode_tokens), 0) / per_round))
    return rounds * k * RESPONSE_BYTES_PER_TOKEN


def speculation_costs(target_cfg: ModelConfig, draft_cfg: ModelConfig,
                      target_tier: TierConfig, draft_tier: TierConfig,
                      decode_tokens: int, context_len: int, k: int,
                      accept_rate: float,
                      rtt_s: float = 0.0) -> Dict[str, float]:
    """Analytic schedule of draft-and-verify decode for one request.

    Per round: ``k`` sequential decode steps on the DRAFT tier, one
    round-trip shipping the draft block, and ONE chunked verify on the
    TARGET — a single weights pass covering ``k+1`` positions plus their
    KV reads, which is the whole speedup: the target pays its memory-bound
    weight read once per ``accept_rate*k + 1`` committed tokens instead of
    once per token. Expected commits per round follow the acceptance EWMA;
    total commits always equal ``decode_tokens`` (output is exactly the
    target-only stream).
    """
    a = min(max(float(accept_rate), 0.0), 1.0)
    per_round = a * k + 1.0
    d = max(int(decode_tokens), 0)
    rounds = int(np.ceil(d / per_round)) if d else 0
    drafted = rounds * k
    accepted = max(d - rounds, 0)  # each round commits accepts + 1 bonus
    # draft side: k sequential single-token steps per round
    df = db = 0.0
    for i in range(k):
        df += decode_flops(draft_cfg, context_len + i)
        db += decode_hbm_bytes(draft_cfg, context_len + i)
    draft_round_s = phase_latency(df, db, draft_tier)
    # target side: one chunk = one weights read + (k+1) tokens' compute/KV
    vf = decode_flops(target_cfg, context_len) * (k + 1)
    vb = (decode_hbm_bytes(target_cfg, context_len)
          + (decode_hbm_bytes(target_cfg, context_len)
             - 2.0 * _active_params(target_cfg)) * k)
    verify_round_s = phase_latency(vf, vb, target_tier)
    link_round_s = float(rtt_s)  # block bytes ride the arrival uplink lump
    seconds = rounds * (draft_round_s + link_round_s + verify_round_s)
    return {"rounds": rounds, "drafted": drafted, "accepted": accepted,
            "draft_s": rounds * draft_round_s,
            "verify_s": rounds * verify_round_s,
            "link_s": rounds * link_round_s, "seconds": seconds,
            "draft_flops": rounds * df, "draft_hbm_bytes": rounds * db,
            "verify_flops": rounds * vf, "verify_hbm_bytes": rounds * vb}


# -- cross-tier KV migration -------------------------------------------------

#: tier-to-tier fabric when neither side sits behind a WAN uplink (two edge
#: boxes on the same LAN segment)
LAN_BPS = 10e9
LAN_RTT_S = 0.001


def slot_payload_bytes(cfg: ModelConfig, context_tokens: int) -> float:
    """Analytic size of one migrated slot (``TierEngine.extract_slot``):
    per-token KV rows for the attended context plus any O(1) recurrent state,
    plus a small header/SeqState overhead. Mirrors the live wire format's
    accounting without materializing it."""
    tokens = context_tokens
    state = 0.0
    if cfg.family == "ssm":
        state = (cfg.num_layers * cfg.ssm_heads * cfg.ssm_head_dim
                 * cfg.ssm_state * 4.0)
    elif cfg.family == "hybrid":
        tokens = min(tokens, cfg.local_window)  # ring window rows only
        state = cfg.num_layers * (cfg.lru_width or cfg.d_model) * 4.0
    return _kv_bytes_per_token(cfg) * tokens + state + 2048.0


def migration_seconds(payload_bytes: float, src, dst) -> float:
    """Seconds to ship a slot payload from tier ``src`` to tier ``dst``
    (TierSpec-likes). The payload rides the remote party's WAN uplink —
    preferring the destination's, matching how the runtime routes migration
    transfers through its per-remote-tier link stations — or a LAN hop when
    both tiers are local."""
    if getattr(dst, "is_remote", False):
        return transfer_seconds(payload_bytes, dst.uplink_bps, dst.rtt_s)
    if getattr(src, "is_remote", False):
        return transfer_seconds(payload_bytes, src.uplink_bps, src.rtt_s)
    return transfer_seconds(payload_bytes, LAN_BPS, LAN_RTT_S)


def modality_tokens(cfg: ModelConfig, mod: ModalityInput) -> int:
    """How many backbone tokens a modality contributes."""
    if mod.kind == "image":
        return cfg.num_patches or 256
    if mod.kind == "text":
        return int(mod.meta.get("tokens", 64))
    if mod.kind == "audio":
        return int(mod.meta.get("frames", cfg.encoder_seq or 1500))
    return 0
