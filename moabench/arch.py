"""A tier's model as the benchmark reads it from a configuration file, and
the weights the benchmark makes for it.

The file states each model with the key names of its published
``config.json``; :func:`arch` turns them into the few sizes the benchmark,
its work counts and its reference need. The weights are the benchmark's
own: made on the device from the run's seed, in the dtype they are served
in, as one flat buffer per tier filled by one ``randn`` call and then
scaled leaf by leaf in place. The program and the reference both receive
this tree and nothing derived from it.

The tree's layout is the serving program's parameter format (the names
and layer-stacked shapes of ``DecoderLM``); the harness checks it against
the model's own ``param_shapes()`` before serving.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Arch:
    """The sizes of one decoder with a vision-stub frontend."""

    name: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    tied: bool
    patches: int
    frontend_dim: int
    rope_theta: float
    eps: float

    @property
    def v_pad(self) -> int:
        """Rows of the embedding table: the vocab padded to 256."""
        return -(-self.vocab // 256) * 256

    @property
    def linear_params(self) -> int:
        """Matrix parameters of the layer stack a token passes through."""
        d, hd = self.d, self.head_dim
        attn = d * self.heads * hd * 2 + d * self.kv_heads * hd * 2
        return self.layers * (attn + 3 * d * self.d_ff)


def arch(model: Dict) -> Arch:
    """Sizes from a tier's ``model`` entry (published key names)."""
    d = int(model["hidden_size"])
    heads = int(model["num_attention_heads"])
    vis = model.get("vision_config") or {}
    return Arch(
        name=model["name"], layers=int(model["num_hidden_layers"]), d=d,
        heads=heads, kv_heads=int(model["num_key_value_heads"]),
        head_dim=int(model.get("head_dim") or d // heads),
        d_ff=int(model["intermediate_size"]),
        vocab=int(model["vocab_size"]),
        tied=bool(model.get("tie_word_embeddings", False)),
        patches=int(vis.get("num_patches", 0)),
        frontend_dim=int(vis.get("frontend_dim", 0)),
        rope_theta=float(model["rope_theta"]),
        eps=float(model["rms_norm_eps"]))


def model_config(a: Arch, dtype: str):
    """The serving program's ``ModelConfig`` for ``a``."""
    from repro_torch.config import ModelConfig

    return ModelConfig(
        name=a.name, family="vlm", num_layers=a.layers, d_model=a.d,
        num_heads=a.heads, num_kv_heads=a.kv_heads, head_dim=a.head_dim,
        d_ff=a.d_ff, vocab_size=a.vocab, activation="swiglu",
        frontend="vision_stub" if a.patches else "none",
        num_patches=a.patches, frontend_dim=a.frontend_dim,
        rope_theta=a.rope_theta, norm_eps=a.eps, tie_embeddings=a.tied,
        dtype=dtype)


def layout(a: Arch) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf. Matrices are normal with std
    1/sqrt(fan in); norm scales are 1 + normal(0.1), so that a norm
    applied wrong shows; the embedding is normal(0.02)."""
    L, d, hd = a.layers, a.d, a.head_dim
    h, k, ff = a.heads, a.kv_heads, a.d_ff
    out = [(("embed",), (a.v_pad, d), 0.02), (("ln_f",), (d,), 0.1)]
    if a.patches:
        out.append((("proj_in",), (a.frontend_dim, d), a.frontend_dim ** -0.5))
    if not a.tied:
        out.append((("unembed",), (a.v_pad, d), d ** -0.5))
    blk = [("ln1", (L, d), 0.1), ("wq", (L, d, h * hd), d ** -0.5),
           ("wk", (L, d, k * hd), d ** -0.5),
           ("wv", (L, d, k * hd), d ** -0.5),
           ("wo", (L, h * hd, d), (h * hd) ** -0.5), ("ln2", (L, d), 0.1)]
    out += [(("blocks", n), s, std) for n, s, std in blk]
    out += [(("blocks", "mlp", "wi"), (L, d, 2 * ff), d ** -0.5),
            (("blocks", "mlp", "wo"), (L, ff, d), ff ** -0.5)]
    return out


def make_weights(a: Arch, seed: int, tier: int, dtype: str,
                 device) -> Dict:
    """The weight tree of tier number ``tier`` for run ``seed``."""
    specs = layout(a)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + tier) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, dtype=DTYPES[dtype],
                       device=device)
    tree: Dict = {}
    at = 0
    for (path, shape, std), n in zip(specs, sizes):
        leaf = flat[at:at + n].view(shape).mul_(std)
        at += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaves(tree: Dict, prefix: Tuple[str, ...] = ()):
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            yield from leaves(v, prefix + (key,))
        else:
            yield prefix + (key,), v
