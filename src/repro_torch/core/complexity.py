"""§3.1 Lightweight Heterogeneous Modality-Aware module. Counterpart of
``repro/core/complexity.py``.

Image complexity (§3.1.1): weighted sum of resolution / edge-density /
entropy-texture / sharpness indicators from the image-statistics kernel
(``repro_torch.kernels``), with the plain PyTorch oracle as fallback.

Text complexity (§3.1.2): token-length + entity-density terms over the toy
tokenizer's token classes, computed in float32 in the JAX package's order
of operations (routing decisions depend on these scores bit for bit).

Audio complexity (beyond-paper extension, same recipe): frame count +
spectral-flux + frame-entropy over precomputed mel frames.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

from repro_torch.config import ComplexityConfig

ArrayLike = Union[np.ndarray, torch.Tensor]


def _as_tensor(x: ArrayLike, device: str) -> torch.Tensor:
    """A tensor stays where it is; a numpy array moves to ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# ---------------------------------------------------------------------------
# image (kernel-backed)
# ---------------------------------------------------------------------------


def image_complexity(imgs: ArrayLike,
                     cc: ComplexityConfig = ComplexityConfig(),
                     use_kernel: bool = True) -> Dict[str, torch.Tensor]:
    """imgs: (B, H, W) float32 in [0,255] -> dict incl. ``c_img`` (B,).

    ``use_kernel=True`` goes through the kernel wrapper: a numpy batch
    moves to the card (``cuda``), a tensor stays on its device (a CPU
    tensor takes the plain version there). ``use_kernel=False`` runs the
    plain PyTorch oracle, on the CPU for a numpy batch."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    if use_kernel:
        x = _as_tensor(imgs, "cuda")
        stats = kops.image_stats(x.float().contiguous())
    else:
        x = _as_tensor(imgs, "cpu")
        stats = kref.image_stats_batch_ref(x)
    return kops.image_complexity_from_stats(stats, x.shape[1], x.shape[2], cc)


def calibrate_percentiles(imgs: ArrayLike,
                          cc: ComplexityConfig = ComplexityConfig()
                          ) -> ComplexityConfig:
    """Fit the P5/P95 normalizers (Eq. 2 & 4) on a calibration set."""
    from repro_torch.kernels import ops as kops

    x = _as_tensor(imgs, "cuda")
    stats = kops.image_stats(x.float().contiguous())
    n = x.shape[1] * x.shape[2]
    g = stats["sobel_sum"].cpu().numpy() / n
    lm = stats["lap_sum"].cpu().numpy() / n
    lv = stats["lap_sq_sum"].cpu().numpy() / n - lm ** 2
    return dataclasses.replace(
        cc,
        edge_p5=float(np.percentile(g, 5)),
        edge_p95=float(np.percentile(g, 95)),
        lap_p5=float(np.percentile(lv, 5)),
        lap_p95=float(np.percentile(lv, 95)),
    )


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def text_complexity_from_counts(num_tokens, num_entities, num_sentences,
                                cc: ComplexityConfig = ComplexityConfig()):
    """Vectorized §3.1.2. All args (B,) arrays or scalars; float32."""
    num_tokens = _f32(num_tokens)
    num_entities = _f32(num_entities)
    num_sentences = torch.clamp(_f32(num_sentences), min=1.0)
    c_len = torch.clamp(num_tokens / cc.len_l0, max=1.0)
    c_ner = torch.clamp((num_entities / num_sentences) / cc.ner_gamma, max=1.0)
    c_text = cc.beta_len * c_len + cc.beta_ner * c_ner
    return {"c_len": c_len, "c_ner": c_ner, "c_text": c_text}


def text_complexity_from_tokens(tokens: torch.Tensor, pad_id: int,
                                entity_mask: torch.Tensor,
                                sentence_end_mask: torch.Tensor,
                                cc: ComplexityConfig = ComplexityConfig()):
    """tokens (B, L) + per-token class masks -> §3.1.2 scores."""
    tokens = torch.as_tensor(tokens)
    entity_mask = torch.as_tensor(entity_mask)
    sentence_end_mask = torch.as_tensor(sentence_end_mask)
    valid = tokens != pad_id
    n_tok = valid.sum(dim=-1)
    n_ent = (entity_mask & valid).sum(dim=-1)
    n_sent = (sentence_end_mask & valid).sum(dim=-1)
    return text_complexity_from_counts(n_tok, n_ent, n_sent, cc)


# ---------------------------------------------------------------------------
# audio (beyond-paper, same single-pass recipe)
# ---------------------------------------------------------------------------


def audio_complexity(frames: ArrayLike,
                     cc: ComplexityConfig = ComplexityConfig()):
    """frames: (B, T, F) precomputed mel features -> dict incl ``c_audio``."""
    frames = _as_tensor(frames, "cpu").float()
    b, t, f = frames.shape
    c_dur = torch.full((b,), min(1.0, t / float(cc.audio_ref_frames)),
                       dtype=torch.float32, device=frames.device)
    flux = torch.abs(torch.diff(frames, dim=1)).mean(dim=(1, 2))
    c_flux = 1.0 - torch.exp(-flux)
    e = torch.clamp(frames - frames.amin(dim=(1, 2), keepdim=True), min=1e-9)
    p = e / e.sum(dim=2, keepdim=True)
    ent = -(p * torch.log(p)).sum(dim=2).mean(dim=1) / np.log(f)
    c_audio = (c_dur + c_flux + ent) / 3.0
    return {"c_dur": c_dur, "c_flux": c_flux, "c_ent": ent,
            "c_audio": c_audio}
