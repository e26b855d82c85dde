"""Decoder-only LM for the ``dense`` and ``vlm`` families. Counterpart of
``repro/models/transformer.py::DecoderLM``.

Parameters travel as a nested dict with the JAX tree's names and
layer-stacked shapes (``blocks/wq`` is ``(L, d, H*hd)``), so one model
object serves several engines and a JAX parameter tree converts by copy
(``repro_torch.convert``). The cache tree keeps the JAX leaf names and row
shapes: ``blocks/{k,v}`` ``(L, B, T, K, hd)``, ``pos`` ``(B, T)``,
``index`` ``(B,)``, plus ``pages`` ``(B, n_pt)`` when the engine pages the
KV leaves into ``(L, P, page, K, hd)`` pools.

Unlike the JAX package, decode updates the cache IN PLACE: ``decode_step``
writes ``pos`` / ``index`` and each layer's new K/V row into the tensors it
was given (before attention reads them) and returns the same dict.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_rope, embed, pad_vocab,
                                       rms_norm, rope_freqs, unembed)
from repro_torch.models.mlp import mlp_forward, mlp_specs
from repro_torch.models.spec import ParamSpec, init_tree

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device a caller asked for; raises if it is CUDA and no card is
    present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available; pass device='cpu' to run on the "
                           f"CPU")
    return dev


def attn_specs(cfg: ModelConfig, prefix_axes=(), include_mlp=True) -> dict:
    ps = tuple(n for n, _ in prefix_axes)
    pa = tuple(a for _, a in prefix_axes)
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s = {
        "ln1": ParamSpec(ps + (d,), pa + ("embed",), "zeros"),
        "wq": ParamSpec(ps + (d, h * hd), pa + ("embed", "heads"), "scaled"),
        "wk": ParamSpec(ps + (d, k * hd), pa + ("embed", "kv_heads"), "scaled"),
        "wv": ParamSpec(ps + (d, k * hd), pa + ("embed", "kv_heads"), "scaled"),
        "wo": ParamSpec(ps + (h * hd, d), pa + ("heads", "embed"), "scaled"),
        "ln2": ParamSpec(ps + (d,), pa + ("embed",), "zeros"),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec(ps + (hd,), pa + (None,), "zeros")
        s["k_norm"] = ParamSpec(ps + (hd,), pa + (None,), "zeros")
    if include_mlp:
        s["mlp"] = mlp_specs(d, cfg.d_ff, cfg.activation, prefix_axes)
    return s


def _layer(tree: Dict[str, Any], l: int) -> Dict[str, Any]:
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


class DecoderLM(nn.Module):
    """Decoder LM over an explicit parameter dict (see the module doc)."""

    def __init__(self, cfg: ModelConfig, attn_impl: str = "auto",
                 param_dtype: str = "", decode_impl: str = "auto",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.family not in ("dense", "vlm"):
            raise NotImplementedError(
                f"family {cfg.family!r}: only dense and vlm are ported "
                f"(ROADMAP queue 1, item 11: remaining families)")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.decode_impl = decode_impl
        self.v_pad = pad_vocab(cfg.vocab_size)
        self.dtype = DTYPES[param_dtype or cfg.dtype]
        self.device = resolve_device(device)
        # f32 copy of the unembedding table, made once per table: the
        # logits are an f32 product on every step (as in the JAX package)
        self._f32_table: Optional[Tuple[tuple, torch.Tensor]] = None

    # ------------------------------------------------------------------
    # specs / init
    # ------------------------------------------------------------------

    def specs(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        s: Dict[str, Any] = {
            "embed": ParamSpec((self.v_pad, d), ("vocab", "embed"), "normal"),
            "ln_f": ParamSpec((d,), ("embed",), "zeros"),
        }
        if cfg.frontend == "vision_stub":
            s["proj_in"] = ParamSpec((cfg.frontend_dim, d),
                                     ("frontend", "embed"), "scaled")
        if not cfg.tie_embeddings:
            s["unembed"] = ParamSpec((self.v_pad, d), ("vocab", "embed"),
                                     "scaled")
        s["blocks"] = attn_specs(cfg, ((cfg.num_layers, "layers"),))
        return s

    def init(self, seed: Union[int, torch.Generator] = 0) -> dict:
        """Random parameters from ``seed`` on this model's device."""
        return init_tree(self.specs(), seed, self.dtype, self.device)

    # ------------------------------------------------------------------
    # cache
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        z = lambda: torch.zeros(shape, dtype=self.dtype, device=self.device)
        return {"blocks": {"k": z(), "v": z()},
                "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                                  device=self.device),
                "index": torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)}

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------

    def _attn_block(self, lp, x, cos, sin, pos_q, pos_kv, mode, window,
                    lcache, idx, layer: Optional[int] = None,
                    ctx: Optional[int] = None,
                    pages: Optional[torch.Tensor] = None):
        cfg = self.cfg
        b, s, _ = x.shape
        h_, k_, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        hh = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = torch.matmul(hh, lp["wq"]).reshape(b, s, h_, hd)
        k = torch.matmul(hh, lp["wk"]).reshape(b, s, k_, hd)
        v = torch.matmul(hh, lp["wv"]).reshape(b, s, k_, hd)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
            k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        new_kv = None
        if mode == "decode" and pages is not None:
            # paged decode: KV rows live in a shared physical pool
            # (L, P, page, K, hd); the slot's page table maps logical page
            # -> physical page (0 = null page). Write one row THROUGH the
            # table, then attend page by page; unwritten entries are masked
            # via pos (null-page garbage contributes nothing to live rows)
            kc, vc = lcache["k"], lcache["v"]
            page = kc.shape[-3]
            bi = torch.arange(b, device=x.device)
            pg = pages[bi, (idx // page).long()].long()
            off = (idx % page).long()
            kc[layer, pg, off] = k[:, 0].to(kc.dtype)
            vc[layer, pg, off] = v[:, 0].to(vc.dtype)
            cap = pos_kv.shape[1]
            ctx_eff = ctx if (ctx is not None and ctx < cap) else cap
            npg = -(-ctx_eff // page)
            out = attn_mod.decode_attention_paged(
                q, kc[layer], vc[layer], pages[:, :npg], pos_q[:, 0],
                pos_kv[:, :ctx_eff], window=window, impl=self.decode_impl)
        elif mode == "decode":
            kc, vc = lcache["k"], lcache["v"]
            bi = torch.arange(b, device=x.device)
            il = idx.long()
            kc[layer, bi, il] = k[:, 0].to(kc.dtype)
            vc[layer, bi, il] = v[:, 0].to(vc.dtype)
            kr, vr, pr = kc[layer], vc[layer], pos_kv
            if ctx is not None and ctx < kr.shape[1]:
                # context hint: attend only the leading ctx entries (views,
                # no copy; the kernel takes the strides)
                kr, vr, pr = kr[:, :ctx], vr[:, :ctx], pos_kv[:, :ctx]
            out = attn_mod.decode_attention(q, kr, vr, pos_q[:, 0], pr,
                                            window=window,
                                            impl=self.decode_impl)
        else:
            out = attn_mod.attention(q, k, v, pos_q, pos_q, causal=True,
                                     window=window, impl=self.attn_impl)
            if mode == "prefill":
                new_kv = (k, v)
        out = out.reshape(b, s, h_ * hd)
        x = x + torch.matmul(out, lp["wo"]).to(x.dtype)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_forward(lp["mlp"], h2, cfg.activation).to(x.dtype)
        return x, new_kv

    # ------------------------------------------------------------------
    # the stack
    # ------------------------------------------------------------------

    def _stack(self, params, x, positions, mode, cache, ctx=None,
               idx=None):
        cfg = self.cfg
        cos, sin = rope_freqs(positions, cfg.resolved_head_dim, cfg.rope_theta)
        pos_kv = cache["pos"] if cache is not None else None
        pages = cache.get("pages") if cache is not None else None
        lcache = cache["blocks"] if cache is not None else None
        ks, vs = [], []
        for l in range(cfg.num_layers):
            lp = _layer(params["blocks"], l)
            x, kv = self._attn_block(lp, x, cos, sin, positions, pos_kv, mode,
                                     None, lcache, idx, layer=l, ctx=ctx,
                                     pages=pages)
            if kv is not None:
                ks.append(kv[0])
                vs.append(kv[1])
        layer_caches = ({"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}
                        if ks else {})
        return x, layer_caches

    # ------------------------------------------------------------------
    # modes
    # ------------------------------------------------------------------

    def _embed_inputs(self, params, batch, mode):
        cfg = self.cfg
        x = embed(batch["tokens"], params["embed"]).to(self.dtype)
        prefix = 0
        if (cfg.frontend == "vision_stub" and mode != "decode"
                and "patches" in batch):
            px = torch.matmul(batch["patches"].to(self.dtype),
                              params["proj_in"])
            x = torch.cat([px, x], dim=1)
            prefix = px.shape[1]
        return x, prefix

    def forward(self, params, batch, mode="prefill", cache=None, ctx=None,
                idx=None):
        """Backbone -> final hidden states (B, S_total, D)."""
        x, prefix = self._embed_inputs(params, batch, mode)
        b, s, _ = x.shape
        if mode == "decode":
            positions = batch["positions"][:, None]
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
        x, layer_caches = self._stack(params, x, positions, mode, cache, ctx,
                                      idx)
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return x, layer_caches, prefix

    def unembed_table_f32(self, params) -> torch.Tensor:
        """The unembedding table sliced to the true vocab, in float32. A
        low-precision table is upcast once and kept (keyed by storage)."""
        table = params["embed"] if self.cfg.tie_embeddings else params["unembed"]
        table = table[:self.cfg.vocab_size]
        if table.dtype == torch.float32:
            return table
        key = (table.data_ptr(), tuple(table.shape), table.dtype, table.device)
        if self._f32_table is None or self._f32_table[0] != key:
            self._f32_table = (key, table.float())
        return self._f32_table[1]

    def _logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return unembed(hidden.float(), self.unembed_table_f32(params))

    def prefill(self, params, batch, capacity: int):
        """Run the prompt, return (last-token logits (B, V), cache).

        With right-padded (length-bucketed) batches, ``batch["lengths"]``
        (B,) gives each row's true token count; logits come from each row's
        true last token. Pad rows sit after all real tokens, so causal
        attention leaves real-token activations untouched; their stale
        cache entries are masked by the caller via ``pos``."""
        hidden, layer_caches, prefix = self.forward(params, batch, "prefill")
        b, s, _ = hidden.shape
        if "lengths" in batch:
            last = prefix + batch["lengths"].long() - 1
            hl = hidden[torch.arange(b, device=hidden.device), last][:, None]
        else:
            hl = hidden[:, -1:]
        logits = self._logits(params, hl)[:, 0]
        cache = self._assemble_prefill_cache(layer_caches, b, s, capacity)
        return logits, cache

    def _assemble_prefill_cache(self, layer_caches, b, s, capacity):
        """Pad per-layer prefill KV into capacity-sized decode caches."""
        dev = self.device

        def pad_full(kv):  # (L,B,S,K,hd) -> (L,B,T,K,hd)
            if s >= capacity:
                return kv[:, :, s - capacity:]
            out = kv.new_zeros(kv.shape[:2] + (capacity,) + kv.shape[3:])
            out[:, :, :s] = kv
            return out

        cache: Dict[str, Any] = {
            "blocks": {k: pad_full(v)
                       for k, v in layer_caches["blocks"].items()}}
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        if s >= capacity:
            pos = pos[:, s - capacity:].contiguous()
        else:
            pos = torch.cat([pos, torch.full((b, capacity - s), -1,
                                             dtype=torch.int32, device=dev)],
                            dim=1)
        cache["pos"] = pos
        cache["index"] = torch.full((b,), min(s, capacity) % max(capacity, 1),
                                    dtype=torch.int32, device=dev)
        return cache

    def decode_step(self, params, cache, batch, ctx=None):
        """One token. batch: tokens (B,1), positions (B,). Returns
        (logits (B, V), cache), the cache updated in place.

        ``ctx`` hints that every live cache entry, this token's write
        included, sits at an index below ``ctx``: attention then reads only
        the leading ``ctx`` entries. Bookkeeping stays full width."""
        idx = cache["index"].clone()  # (B,) this token's write index
        bi = torch.arange(idx.shape[0], device=idx.device)
        cache["pos"][bi, idx.long()] = batch["positions"].to(torch.int32)
        cap = cache["pos"].shape[1]
        cache["index"] = (idx + 1) % cap
        hidden, _, _ = self.forward(params, batch, "decode", cache, ctx, idx)
        return self._logits(params, hidden)[:, 0], cache
