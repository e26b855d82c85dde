"""The one generator every traffic mix of the benchmark goes through.

A mix is a JSON file of parameters beside this module (``<mix>.json``);
a cell may override some of them (the offered rate, the number of
clients). The distributions are those of the port's
``data/synthetic.py::RequestGenerator``, copied here and repaired:

* each image is drawn at the side that was drawn for it (the original
  materialised every image at one fixed ``image_hw``);
* images come from a pool of ``image.pool`` distinct images drawn in
  set-up, because drawing a 384-1280 px image costs tens of
  milliseconds of host time;
* prompts carry real token ids (word, entity and sentence-end classes of
  the toy tokenizer), made to the drawn counts.

Two random streams keep the work of a run steady across seeds. The
*shape* stream, seeded by the mix's ``shape_seed``, draws the multiset of
request sizes, image sides and contents and inter-arrival gaps; it is the
same for every run. The run's ``--seed`` draws the order of the requests
and of the gaps, the pixels of the images and the token ids. So every
seed sends the same sizes and arrivals, in another order.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent

# token classes of the toy tokenizer (``data/tokenizer.py``), copied
BOS_ID = 1
SENT_END_ID = 3
ENTITY_BASE = 4
ENTITY_RANGE = 996
WORD_BASE = 1000
WORD_VOCAB = 32_000  # every word id stays below the smallest vocab served


@dataclass(frozen=True)
class RequestSpec:
    """One request's sizes: prompt token count, its entity and sentence
    counts, output tokens, and the index of its image in the pool (-1: no
    image)."""

    tokens: int
    entities: int
    sentences: int
    max_new: int
    image: int


def load_mix(name: str) -> Dict:
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    with open(path) as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------


def _box_same(img: np.ndarray, k: int, axis: int) -> np.ndarray:
    """``np.convolve(row, ones(k) / k, mode="same")`` along ``axis`` for an
    odd ``k``, over the whole array at once (zeros outside the image)."""
    pad = [(0, 0), (0, 0)]
    pad[axis] = (k // 2 + 1, k // 2)
    c = np.cumsum(np.pad(img, pad), axis=axis, dtype=np.float64)
    n = img.shape[axis]
    hi = np.take(c, np.arange(k, k + n), axis=axis)
    lo = np.take(c, np.arange(0, n), axis=axis)
    return ((hi - lo) / k).astype(np.float32)


def make_image(rng: np.random.Generator, content: float, h: int,
               w: int) -> np.ndarray:
    """One grayscale image in [0, 255] (``synthetic.py::make_image``):
    higher ``content`` gives more edges, texture entropy and sharpness."""
    u = float(np.clip(content, 0.0, 1.0))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 128.0 + 40.0 * np.sin(2 * np.pi * xx / max(w, 1))
    for k in range(1, 2 + int(6 * u)):
        f = 2.0 ** k
        img += (30.0 * u) * np.sign(np.sin(2 * np.pi * (xx + yy) * f / w))
    img += rng.normal(0.0, 5.0 + 55.0 * u, (h, w)).astype(np.float32)
    if u < 0.5:
        kdim = 1 + 2 * int((0.5 - u) * 8)
        if kdim > 1:
            img = _box_same(_box_same(img, kdim, 1), kdim, 0)
    return np.clip(img, 0, 255).astype(np.float32)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


class Traffic:
    """A mix's requests for one run: the image pool, the window's arrivals
    (open loop) or the clients' request sequence (closed loop), and the
    warm-up burst."""

    def __init__(self, mix: Dict, params: Optional[Dict], seed: int):
        self.mix = dict(mix)
        self.mix.update(params or {})
        self.seed = int(seed)
        self.loop = self.mix["loop"]
        if self.loop not in ("open", "closed"):
            raise ValueError(f"mix {mix.get('name')!r}: loop must be 'open' "
                             f"or 'closed', not {self.loop!r}")
        self.slo_s = float(self.mix["slo_s"])
        shape = np.random.default_rng(int(self.mix["shape_seed"]))
        im = self.mix["image"]
        n_pool = int(im["pool"])
        a, b = im["side_beta"]
        ca, cb = im["content_beta"]
        self.pool_specs: List[Tuple[int, float]] = [
            (int(im["side_min"] + im["side_span"] * shape.beta(a, b)),
             float(shape.beta(ca, cb))) for _ in range(n_pool)]

    # -- sizes (shape stream) ------------------------------------------------

    def _specs(self, rng: np.random.Generator, n: int) -> List[RequestSpec]:
        tx, out, im = self.mix["text"], self.mix["output"], self.mix["image"]
        ta, tb = tx["content_beta"]
        specs = []
        for _ in range(n):
            u = float(rng.beta(ta, tb))
            tokens = int(tx["base"] + u * u * tx["quad"]
                         + rng.integers(0, tx["jitter"]))
            sentences = max(1, tokens // tx["sentence_tokens"])
            entities = int(sentences * u * 3.0 + rng.integers(0, 2))
            if out["dist"] == "lognormal":
                m = out["median"] * np.exp(out["sigma"] * rng.normal())
                max_new = int(np.clip(round(m), out["min"], out["max"]))
            elif out["dist"] == "uniform":
                max_new = int(rng.integers(out["min"], out["max"] + 1))
            else:
                raise ValueError(f"unknown output dist {out['dist']!r}")
            image = (int(rng.integers(0, im["pool"]))
                     if rng.random() < self.mix["p_image"] else -1)
            specs.append(RequestSpec(tokens, entities, sentences, max_new,
                                     image))
        return specs

    def _shape_rng(self, *stream: int) -> np.random.Generator:
        return np.random.default_rng([int(self.mix["shape_seed"]), *stream])

    def _run_rng(self, *stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *stream])

    def window(self, seconds: float) -> Tuple[np.ndarray, List[RequestSpec]]:
        """Open loop: arrival offsets (s, from the window's start) and the
        requests. The gaps are Poisson at the mix's ``rate``, drawn until
        they pass ``seconds``; a seed reorders the same gaps and the same
        requests."""
        rate = float(self.mix["rate"])
        shape = self._shape_rng(1)
        gaps, total = [], 0.0
        while True:
            g = float(shape.exponential(1.0 / rate))
            if total + g > seconds:
                break
            total += g
            gaps.append(g)
        specs = self._specs(shape, len(gaps))
        run = self._run_rng(1)
        gaps = np.asarray(gaps)[run.permutation(len(gaps))]
        specs = [specs[i] for i in run.permutation(len(specs))]
        return np.cumsum(gaps), specs

    def stream(self, block: int = 1024) -> Iterator[RequestSpec]:
        """Closed loop: the requests the clients send, in the order they
        are sent, without end (blocks of ``block`` requests, each a fixed
        multiset in an order drawn from the seed). The first ``clients``
        requests, one a client, are cut to a residual length: the output
        left of a request found in flight at a random moment (a length
        drawn in proportion to itself, times a uniform share), so that the
        window opens on clients in every stage of their requests, as in a
        loop that has run for a while, and not on all of them starting
        together."""
        clients = int(self.mix.get("clients", 0))
        rng = self._run_rng(3)
        n = 0
        for b in itertools.count():
            specs = self._specs(self._shape_rng(2, b), block)
            for i in self._run_rng(2, b).permutation(block):
                spec = specs[i]
                if n < clients:
                    spec = dataclasses.replace(
                        spec, max_new=self._residual(rng, spec.max_new))
                n += 1
                yield spec

    def _residual(self, rng: np.random.Generator, length: int) -> int:
        out = self.mix["output"]
        while rng.random() * out["max"] > length:  # length-biased draw
            length = self._specs(rng, 1)[0].max_new
        return max(1, int(np.ceil(rng.random() * length)))

    def warm(self) -> Tuple[np.ndarray, List[RequestSpec]]:
        """The warm-up burst: ``warm.requests`` requests of the mix spread
        evenly over ``warm.spread_s`` seconds (none for a closed loop,
        whose ramp warms)."""
        w = self.mix.get("warm", {})
        n = int(w.get("requests", 0))
        specs = self._specs(self._shape_rng(3), n)
        return np.linspace(0.0, float(w.get("spread_s", 0.0)), n), specs

    # -- payloads (run stream) -----------------------------------------------

    def images(self) -> List[np.ndarray]:
        """The pool's images, each at its own side, pixels from the seed."""
        return [make_image(np.random.default_rng([self.seed, 4, i]), c, s, s)
                for i, (s, c) in enumerate(self.pool_specs)]

    def prompt_ids(self, spec: RequestSpec, index: int,
                   stream: int = 5) -> np.ndarray:
        """Token ids of one prompt: BOS, then words, with ``sentences``
        sentence ends spread evenly and ``entities`` entity ids at random
        places among the words."""
        rng = np.random.default_rng([self.seed, stream, index])
        n = spec.tokens
        ids = rng.integers(WORD_BASE, WORD_VOCAB, n).astype(np.int32)
        ids[0] = BOS_ID
        ends = np.unique(np.linspace(n - 1, 1, spec.sentences).astype(int))
        ids[ends] = SENT_END_ID
        free = np.setdiff1d(np.arange(1, n), ends)
        k = min(spec.entities, free.size)
        at = rng.choice(free, size=k, replace=False)
        ids[at] = ENTITY_BASE + rng.integers(0, ENTITY_RANGE, k)
        return ids
