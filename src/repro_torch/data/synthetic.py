"""Synthetic multimodal data with CONTROLLED complexity.

The paper evaluates on VQAv2/MMBench images; offline we generate parametric
images whose §3.1.1 indicators (edge density, entropy, sharpness) are driven
by a single latent ``content`` knob u ∈ [0,1] — this lets benchmarks sweep
the estimator's whole operating range and ties request difficulty to what
the scorer can actually observe (plus noise), mirroring real data.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.request import ModalityInput, Request


def make_image(rng: np.random.Generator, content: float, h: int = 256,
               w: int = 256) -> np.ndarray:
    """One grayscale image in [0,255]; higher ``content`` => more edges,
    texture entropy and sharpness (all §3.1.1 indicators move together)."""
    u = float(np.clip(content, 0.0, 1.0))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 128.0 + 40.0 * np.sin(2 * np.pi * xx / max(w, 1))
    # edge structure: superimposed gratings whose frequency grows with u
    for k in range(1, 2 + int(6 * u)):
        f = 2.0 ** k
        img += (30.0 * u) * np.sign(np.sin(2 * np.pi * (xx + yy) * f / w))
    # texture: white noise amplitude grows with u
    img += rng.normal(0.0, 5.0 + 55.0 * u, (h, w)).astype(np.float32)
    # low-content images are additionally blurred (lower Laplacian variance)
    if u < 0.5:
        kdim = 1 + 2 * int((0.5 - u) * 8)
        if kdim > 1:
            kern = np.ones(kdim, np.float32) / kdim
            img = np.apply_along_axis(
                lambda r: np.convolve(r, kern, mode="same"), 1, img)
            img = np.apply_along_axis(
                lambda c: np.convolve(c, kern, mode="same"), 0, img)
    return np.clip(img, 0, 255).astype(np.float32)


def synth_image_batch(rng: np.random.Generator, contents, h=256, w=256):
    return np.stack([make_image(rng, c, h, w) for c in contents])


def make_text_meta(rng: np.random.Generator, content: float) -> Dict[str, float]:
    """Token/entity/sentence counts whose §3.1.2 score tracks ``content``.

    VQA-style prompts: mostly short questions (quadratic in the latent so the
    mass sits low), occasionally long multi-entity instructions.
    """
    u = float(np.clip(content, 0.0, 1.0))
    tokens = int(16 + u * u * 900 + rng.integers(0, 24))
    sentences = max(1, tokens // 24)
    entities = int(sentences * u * 3.0 + rng.integers(0, 2))
    return {"tokens": tokens, "entities": entities, "sentences": sentences}


class RequestGenerator:
    """Poisson stream of multimodal requests for the simulator/engine.

    difficulty = mean of the latent modality contents + noise: the scorer sees
    only the realized payloads, never the latent — exactly the deployment
    situation (complexity is a PROXY for difficulty).
    """

    def __init__(self, seed: int = 0, arrival_rate: float = 20.0,
                 image_hw: int = 256, materialize_images: bool = False,
                 p_image: float = 0.95, decode_tokens: int = 64,
                 slo_s: float = 8.0):
        self.rng = np.random.default_rng(seed)
        self.rate = arrival_rate
        self.hw = image_hw
        self.materialize = materialize_images
        self.p_image = p_image
        self.decode_tokens = decode_tokens
        self.slo_s = slo_s

    def generate(self, n: int) -> List[Request]:
        t = 0.0
        out = []
        for rid in range(n):
            t += self.rng.exponential(1.0 / self.rate)
            u_img = self.rng.beta(1.6, 1.6)  # latent image content
            u_txt = self.rng.beta(1.4, 2.2)  # text skews simpler
            mods: Dict[str, ModalityInput] = {}
            if self.rng.random() < self.p_image:
                # resolution is INDEPENDENT of content difficulty (a big photo
                # isn't a hard question) — size-based routing (PerLLM's
                # constraint) therefore carries no difficulty signal, while
                # the §3.1.1 complexity score blends content + resolution
                v_size = self.rng.beta(2.0, 2.0)
                hw = int(384 + 896 * v_size)
                c_img = float(np.clip(0.8 * u_img + 0.2 * v_size
                                      + self.rng.normal(0, 0.03), 0, 1))
                if self.materialize:
                    img = make_image(self.rng, u_img, self.hw, self.hw)
                    mods["image"] = ModalityInput(
                        "image", data=img,
                        size_bytes=int(img.size * 0.5),  # ~jpeg-ish
                        meta={"h": self.hw, "w": self.hw, "content_c": u_img})
                else:
                    mods["image"] = ModalityInput(
                        "image", size_bytes=int(hw * hw * 1.2),  # ~jpeg q90
                        meta={"h": hw, "w": hw, "content_c": c_img})
            tmeta = make_text_meta(self.rng, u_txt)
            mods["text"] = ModalityInput(
                "text", meta=tmeta, size_bytes=int(tmeta["tokens"] * 4))
            # VQA-style: the image carries most of the task difficulty
            if "image" in mods:
                base = 0.75 * u_img + 0.25 * u_txt
            else:
                base = u_txt
            difficulty = float(np.clip(
                base + self.rng.normal(0, 0.06), 0, 1))
            out.append(Request(rid=rid, arrival_s=t, modalities=mods,
                               decode_tokens=self.decode_tokens,
                               difficulty=difficulty, slo_s=self.slo_s))
        return out


def make_token_batch(rng: np.random.Generator, batch: int, seq: int,
                     vocab: int) -> Dict[str, np.ndarray]:
    """Deterministic synthetic LM batch (Zipf-ish marginals + shift labels)."""
    z = rng.zipf(1.3, size=(batch, seq + 1))
    toks = (z % (vocab - 4) + 4).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
