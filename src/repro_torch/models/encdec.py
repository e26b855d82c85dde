"""Encoder-decoder LM (the Whisper-small family). Counterpart of
``repro/models/encdec.py``.

Encoder: bidirectional attention over precomputed audio-frame embeddings
(a linear projection stands in for the conv frontend) plus learned frame
positions. Decoder: causal self-attention under RoPE, then cross-attention
into the encoder output. LayerNorm with bias; no attention or MLP biases
(the JAX package's documented deviations).

Attention routing. The encoder's self-attention and the decoder's prefill
self-attention go through ``attention.attention`` under ``attn_impl`` (the
flash kernel under "cuda"; the encoder's is non-causal). The cross-attention
prefill (decoder tokens against the frames, Sq != Skv) takes the
dispatcher's position-aware "auto" choice under "cuda"/"torch": the
self-attention kernel refuses Sq != Skv. Decode reads the self cache and the
cross cache through the dense decode dispatcher; the cross read passes a
query position of 10**9, so every frame is visible.

The cache keeps the JAX leaf names: ``self/{k,v}`` ``(L, B, T, K, hd)``,
``cross/{k,v}`` ``(L, B, F, K, hd)`` over the F encoder frames,
``cross_pos`` ``(B, F)``, ``pos`` ``(B, T)``, ``index`` ``(B,)``. As in
``DecoderLM``, ``decode_step`` updates it in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_rope, embed, layer_norm,
                                       pad_vocab, rope_freqs, unembed)
from repro_torch.models.mlp import mlp_forward, mlp_specs
from repro_torch.models.spec import ParamSpec, init_tree
from repro_torch.models.transformer import (ATTN_IMPLS, DTYPES, _layer,
                                            resolve_device)

#: the query position of a cross-attention decode read: past every frame
CROSS_POS_Q = 10 ** 9


def _ln_specs(d, ps, pa):
    return {"w": ParamSpec(ps + (d,), pa + ("embed",), "ones"),
            "b": ParamSpec(ps + (d,), pa + ("embed",), "zeros")}


def _attn_proj_specs(cfg, ps, pa):
    d, h, k, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    return {
        "wq": ParamSpec(ps + (d, h * hd), pa + ("embed", "heads"), "scaled"),
        "wk": ParamSpec(ps + (d, k * hd), pa + ("embed", "kv_heads"),
                        "scaled"),
        "wv": ParamSpec(ps + (d, k * hd), pa + ("embed", "kv_heads"),
                        "scaled"),
        "wo": ParamSpec(ps + (h * hd, d), pa + ("heads", "embed"), "scaled"),
    }


def _ln(x, p, eps):
    return layer_norm(x, p["w"], p["b"], eps)


class EncDecLM(nn.Module):
    """Encoder-decoder LM over an explicit parameter dict (see the module
    doc)."""

    def __init__(self, cfg: ModelConfig, attn_impl: str = "auto",
                 param_dtype: str = "", decode_impl: str = "auto",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM serves encdec, not {cfg.family!r}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS} "
                             f"(the JAX 'pallas' is 'cuda' here)")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.decode_impl = decode_impl
        self.v_pad = pad_vocab(cfg.vocab_size)
        self.dtype = DTYPES[param_dtype or cfg.dtype]
        self.device = resolve_device(device)
        self._f32_table: Optional[Tuple[tuple, torch.Tensor]] = None

    # ------------------------------------------------------------------
    # specs / init / cache
    # ------------------------------------------------------------------

    def specs(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        el, dl = cfg.encoder_layers, cfg.num_layers
        enc_block = {
            "ln1": _ln_specs(d, (el,), ("layers",)),
            "attn": _attn_proj_specs(cfg, (el,), ("layers",)),
            "ln2": _ln_specs(d, (el,), ("layers",)),
            "mlp": mlp_specs(d, cfg.d_ff, cfg.activation, ((el, "layers"),)),
        }
        dec_block = {
            "ln1": _ln_specs(d, (dl,), ("layers",)),
            "self_attn": _attn_proj_specs(cfg, (dl,), ("layers",)),
            "ln_x": _ln_specs(d, (dl,), ("layers",)),
            "cross_attn": _attn_proj_specs(cfg, (dl,), ("layers",)),
            "ln2": _ln_specs(d, (dl,), ("layers",)),
            "mlp": mlp_specs(d, cfg.d_ff, cfg.activation, ((dl, "layers"),)),
        }
        return {
            "proj_in": ParamSpec((cfg.frontend_dim, d), ("frontend", "embed"),
                                 "scaled"),
            "enc_pos": ParamSpec((cfg.encoder_seq, d), (None, "embed"),
                                 "normal"),
            "enc_blocks": enc_block,
            "enc_ln_f": _ln_specs(d, (), ()),
            "embed": ParamSpec((self.v_pad, d), ("vocab", "embed"), "normal"),
            "dec_blocks": dec_block,
            "dec_ln_f": _ln_specs(d, (), ()),
        }

    def init(self, seed: Union[int, torch.Generator] = 0) -> dict:
        """Random parameters from ``seed`` on this model's device."""
        return init_tree(self.specs(), seed, self.dtype, self.device)

    def cache_axes(self, batch: int, capacity: int) -> dict:
        kv = ("layers", "batch", "seq", "kv_heads", None)
        return {"self": {"k": kv, "v": kv}, "cross": {"k": kv, "v": kv},
                "cross_pos": ("batch", "seq"), "pos": ("batch", "seq"),
                "index": ("batch",)}

    def init_cache(self, batch: int, capacity: int) -> dict:
        """Zero KV (model dtype), ``pos`` -1, ``cross_pos`` 0..F-1."""
        cfg, dev = self.cfg, self.device
        k, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        dl, se = cfg.num_layers, cfg.encoder_seq
        kv = lambda t: {n: torch.zeros((dl, batch, t, k, hd),
                                       dtype=self.dtype, device=dev)
                        for n in ("k", "v")}
        return {
            "self": kv(capacity), "cross": kv(se),
            "cross_pos": torch.arange(se, dtype=torch.int32, device=dev)[
                None].repeat(batch, 1),
            "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                              device=dev),
            "index": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    # ------------------------------------------------------------------
    # attention
    # ------------------------------------------------------------------

    def _mha(self, lp, xq, xkv, pos_q, pos_kv, causal, mode="full",
             lcache=None, idx=None, layer: Optional[int] = None):
        """Attention in the JAX package's modes: "full"/"prefill" over
        ``xkv`` (prefill also returns the (k, v) it made), "decode" (one
        token written into ``lcache`` layer ``layer`` at ``idx``, in place,
        then read), "cross_cached" (one token against the cross cache)."""
        cfg = self.cfg
        b, sq, _ = xq.shape
        h_, k_, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q = torch.matmul(xq, lp["wq"]).reshape(b, sq, h_, hd)
        if mode == "cross_cached":
            k, v = lcache["k"][layer], lcache["v"][layer]
        else:
            skv = xkv.shape[1]
            k = torch.matmul(xkv, lp["wk"]).reshape(b, skv, k_, hd)
            v = torch.matmul(xkv, lp["wv"]).reshape(b, skv, k_, hd)
        if causal and mode != "cross_cached":  # RoPE on decoder self-attn
            cos, sin = rope_freqs(pos_q, hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        new_kv = None
        if mode == "decode":
            kc, vc = lcache["k"], lcache["v"]
            bi = torch.arange(b, device=xq.device)
            il = idx.long()
            kc[layer, bi, il] = k[:, 0].to(kc.dtype)
            vc[layer, bi, il] = v[:, 0].to(vc.dtype)
            out = attn_mod.decode_attention(q, kc[layer], vc[layer],
                                            pos_q[:, 0], pos_kv,
                                            impl=self.decode_impl)
        elif mode == "cross_cached":
            out = attn_mod.decode_attention(
                q, k, v, torch.full((b,), CROSS_POS_Q, dtype=torch.int32,
                                    device=xq.device),
                pos_kv, impl=self.decode_impl)
        else:
            impl = self.attn_impl
            if sq != k.shape[1] and impl in ("cuda", "torch"):
                # cross-attention prefill: the self-attention kernel and
                # its plain version take Sq == Skv only
                impl = "auto"
            out = attn_mod.attention(q, k, v, pos_q, pos_kv, causal=causal,
                                     impl=impl)
            if mode == "prefill":
                new_kv = (k, v)
        o = torch.matmul(out.reshape(b, sq, h_ * hd), lp["wo"])
        return o.to(xq.dtype), new_kv

    # ------------------------------------------------------------------
    # encoder / decoder stacks
    # ------------------------------------------------------------------

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, frontend_dim) -> encoder output (B, F, D)."""
        cfg = self.cfg
        x = torch.matmul(frames.to(self.dtype), params["proj_in"])
        x = x + params["enc_pos"][None].to(self.dtype)
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device)[
            None].expand(b, s)
        for l in range(cfg.encoder_layers):
            lp = _layer(params["enc_blocks"], l)
            h = _ln(x, lp["ln1"], cfg.norm_eps)
            o, _ = self._mha(lp["attn"], h, h, pos, pos, causal=False)
            x = x + o
            h = _ln(x, lp["ln2"], cfg.norm_eps)
            x = x + mlp_forward(lp["mlp"], h, cfg.activation).to(x.dtype)
        return _ln(x, params["enc_ln_f"], cfg.norm_eps)

    def _decode_stack(self, params, x, enc_out, mode, cache=None,
                      positions=None, idx=None):
        """Decoder layers. "full"/"prefill" attend ``enc_out`` (prefill
        returns the stacked self and cross (k, v)); "decode" reads and
        writes ``cache`` in place at write index ``idx``."""
        cfg = self.cfg
        b, s, _ = x.shape
        if mode == "decode":
            pos = positions  # (B, 1)
            pos_kv, cross_pos = cache["pos"], cache["cross_pos"]
        else:
            pos = torch.arange(s, dtype=torch.int32, device=x.device)[
                None].expand(b, s)
            se = enc_out.shape[1]
            enc_pos = torch.arange(se, dtype=torch.int32, device=x.device)[
                None].expand(b, se)
        ys = {"self": ([], []), "cross": ([], [])}
        for l in range(cfg.num_layers):
            lp = _layer(params["dec_blocks"], l)
            h = _ln(x, lp["ln1"], cfg.norm_eps)
            if mode == "decode":
                o, _ = self._mha(lp["self_attn"], h, h, pos, pos_kv, True,
                                 "decode", cache["self"], idx, layer=l)
            else:
                o, kv = self._mha(lp["self_attn"], h, h, pos, pos, True, mode)
                if kv is not None:
                    ys["self"][0].append(kv[0])
                    ys["self"][1].append(kv[1])
            x = x + o
            h = _ln(x, lp["ln_x"], cfg.norm_eps)
            if mode == "decode":
                o, _ = self._mha(lp["cross_attn"], h, None, pos, cross_pos,
                                 False, "cross_cached", cache["cross"],
                                 layer=l)
            else:
                o, kv = self._mha(lp["cross_attn"], h, enc_out, pos, enc_pos,
                                  False, mode)
                if kv is not None:
                    ys["cross"][0].append(kv[0])
                    ys["cross"][1].append(kv[1])
            x = x + o
            h = _ln(x, lp["ln2"], cfg.norm_eps)
            x = x + mlp_forward(lp["mlp"], h, cfg.activation).to(x.dtype)
        x = _ln(x, params["dec_ln_f"], cfg.norm_eps)
        if mode != "prefill":
            return x, None
        return x, {key: {"k": torch.stack(ks), "v": torch.stack(vs)}
                   for key, (ks, vs) in ys.items()}

    # ------------------------------------------------------------------
    # modes
    # ------------------------------------------------------------------

    def unembed_table_f32(self, params) -> torch.Tensor:
        """The tied embedding sliced to the true vocab, in float32 (a
        low-precision table is upcast once and kept, keyed by storage)."""
        table = params["embed"][:self.cfg.vocab_size]
        if table.dtype == torch.float32:
            return table
        key = (table.data_ptr(), tuple(table.shape), table.dtype, table.device)
        if self._f32_table is None or self._f32_table[0] != key:
            self._f32_table = (key, table.float())
        return self._f32_table[1]

    def _logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return unembed(hidden.float(), self.unembed_table_f32(params))

    def forward(self, params, batch, mode="full", cache=None):
        """Decoder hidden states over ``batch`` (tokens, frames), in the
        uniform API's (hidden, aux, caches, prefix) form."""
        enc = self.encode(params, batch["frames"])
        x = embed(batch["tokens"], params["embed"]).to(self.dtype)
        x, _ = self._decode_stack(params, x, enc, "full")
        return x, torch.zeros((), dtype=torch.float32, device=x.device), {}, 0

    def prefill(self, params, batch, capacity: int):
        """Encode ``batch["frames"]`` and run the decoder prompt; return
        (last-token logits (B, V), cache). ``batch["lengths"]`` (B,) gives
        right-padded rows' true token counts."""
        if "frames" not in batch:
            raise ValueError("encdec prefill needs batch['frames'] (B, "
                             f"{self.cfg.encoder_seq}, "
                             f"{self.cfg.frontend_dim})")
        dev = self.device
        enc = self.encode(params, batch["frames"])
        x = embed(batch["tokens"], params["embed"]).to(self.dtype)
        x, ys = self._decode_stack(params, x, enc, "prefill")
        b, s, _ = x.shape
        if "lengths" in batch:
            last = batch["lengths"].long() - 1
            xl = x[torch.arange(b, device=x.device), last][:, None]
        else:
            xl = x[:, -1:]
        logits = self._logits(params, xl)[:, 0]

        def fit(kv):  # (L, B, S, K, hd) -> (L, B, capacity, K, hd)
            if s >= capacity:
                return kv[:, :, s - capacity:].contiguous()
            out = kv.new_zeros(kv.shape[:2] + (capacity,) + kv.shape[3:])
            out[:, :, :s] = kv
            return out

        pos = torch.full((b, capacity), -1, dtype=torch.int32, device=dev)
        n = min(s, capacity)
        pos[:, :n] = torch.arange(s - n, s, dtype=torch.int32, device=dev)
        se = enc.shape[1]
        cache = {
            "self": {n_: fit(v) for n_, v in ys["self"].items()},
            "cross": ys["cross"],
            "cross_pos": torch.arange(se, dtype=torch.int32, device=dev)[
                None].repeat(b, 1),
            "pos": pos,
            "index": torch.full((b,), n % max(capacity, 1),
                                dtype=torch.int32, device=dev),
        }
        return logits, cache

    def decode_step(self, params, cache, batch, ctx=None):
        """One token. batch: tokens (B, 1), positions (B,). Returns
        (logits (B, V), cache), the cache updated in place. ``ctx`` (a
        context-bucket hint) is accepted for ``DecoderLM``'s API and unused:
        the serving engine keeps full-width attention for this family."""
        del ctx
        idx = cache["index"].clone()  # (B,) this token's write index
        bi = torch.arange(idx.shape[0], device=idx.device)
        cache["pos"][bi, idx.long()] = batch["positions"].to(torch.int32)
        cap = cache["pos"].shape[1]
        cache["index"] = (idx + 1) % cap
        x = embed(batch["tokens"], params["embed"]).to(self.dtype)
        x, _ = self._decode_stack(params, x, None, "decode", cache,
                                  batch["positions"][:, None], idx)
        return self._logits(params, x)[:, 0], cache
