"""Decoder-only LM for the ``dense``, ``vlm``, ``moe``, ``ssm`` and
``hybrid`` families. Counterpart of ``repro/models/transformer.py::DecoderLM``.

Parameters travel as a nested dict with the JAX tree's names and
layer-stacked shapes (``blocks/wq`` is ``(L, d, H*hd)``), so one model
object serves several engines and a JAX parameter tree converts by copy
(``repro_torch.convert``). The cache tree keeps the JAX leaf names and row
shapes: ``blocks/{k,v}`` ``(L, B, T, K, hd)``, ``pos`` ``(B, T)``,
``index`` ``(B,)``, plus ``pages`` ``(B, n_pt)`` when the engine pages the
KV leaves into ``(L, P, page, K, hd)`` pools. The ``moe`` family's layers
fall in two groups, ``dense_blocks`` (its first ``first_k_dense`` layers,
a dense MLP) and ``blocks`` (an MoE layer each), with a KV leaf pair each
over the shared ``pos``/``index``. The ``ssm`` cache is
``blocks/{conv,h}`` (Mamba-2 conv window and f32 state per layer, no
``pos``); the ``hybrid`` cache holds ``repeats/rglru/{conv,h}`` ``(R, n_rec,
B, ...)`` (batch at axis 2), ``repeats/attn/{k,v}`` ``(R, B, w, K, hd)``, a
ring of ``w = min(capacity, local_window)`` rows where position p lives at
row p % w, ``extra/{conv,h}`` for layers past the last whole pattern, and
``pos``/``index`` ``(B, w)``/``(B,)`` over the ring.

Unlike the JAX package, decode updates the cache IN PLACE: ``decode_step``
(one token) and ``decode_chunk`` (S tokens against the cache, the suffix
prefill of a warm admission) write ``pos`` / ``index`` and each layer's new
K/V rows into the tensors they were given (before attention reads them) and
return the same dict; so do ``decode_chunk_recurrent`` and the recurrent
families' decode, which overwrite each layer's conv window and state.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_rope, embed, pad_vocab,
                                       rms_norm, rope_freqs, unembed)
from repro_torch.models.mlp import mlp_forward, mlp_specs
from repro_torch.models.spec import ParamSpec, init_tree

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
#: prefill attention impls (``attention.attention``); ``cuda``/``torch`` are
#: the counterpart of the JAX package's ``pallas``
ATTN_IMPLS = ("auto", "dense", "flash", "local", "cuda", "torch")
#: the families ``DecoderLM`` serves (``encdec`` is ``EncDecLM``)
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
#: the families whose cache is full-capacity KV under absolute positions
KV_FAMILIES = ("dense", "vlm", "moe")


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device a caller asked for; raises if it is CUDA and no card is
    present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available; pass device='cpu' to run on the "
                           f"CPU")
    return dev


def attn_specs(cfg: ModelConfig, prefix_axes=(), include_mlp=True,
               moe=False) -> dict:
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
    if moe:
        s["moe"] = moe_mod.moe_specs(cfg, prefix_axes)
    elif include_mlp:
        s["mlp"] = mlp_specs(d, cfg.d_ff, cfg.activation, prefix_axes)
    return s


def rglru_unit_specs(cfg: ModelConfig, prefix_axes=()) -> dict:
    ps = tuple(n for n, _ in prefix_axes)
    pa = tuple(a for _, a in prefix_axes)
    s = rglru_mod.rglru_specs(cfg, prefix_axes)
    s["ln2"] = ParamSpec(ps + (cfg.d_model,), pa + ("embed",), "zeros")
    s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.activation, prefix_axes)
    return s


def _ring_roll(x: torch.Tensor, shift: torch.Tensor, axis: int
               ) -> torch.Tensor:
    """Row b of ``x`` rolled by ``shift[b]`` along ``axis`` (>= 1; batch is
    axis 0): ``jnp.roll`` per row, as one gather, no host sync."""
    w = x.shape[axis]
    src = (torch.arange(w, device=x.device)[None] - shift.long()[:, None]) % w
    idx = src.reshape(src.shape[:1] + (1,) * (axis - 1) + (w,)
                      + (1,) * (x.dim() - axis - 1))
    return torch.gather(x, axis, idx.expand(x.shape))


def _layer(tree: Dict[str, Any], l: int) -> Dict[str, Any]:
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


class DecoderLM(nn.Module):
    """Decoder LM over an explicit parameter dict (see the module doc)."""

    def __init__(self, cfg: ModelConfig, attn_impl: str = "auto",
                 param_dtype: str = "", decode_impl: str = "auto",
                 device: Union[str, torch.device] = "cuda",
                 moe_impl: str = "auto"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"DecoderLM serves {', '.join(FAMILIES)}, not "
                             f"{cfg.family!r}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS} "
                             f"(the JAX 'pallas' is 'cuda' here)")
        if moe_impl not in moe_mod.MOE_IMPLS:
            raise ValueError(f"moe_impl {moe_impl!r} not in "
                             f"{moe_mod.MOE_IMPLS}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.moe_impl = moe_impl
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
        L = cfg.num_layers
        if cfg.family in KV_FAMILIES:
            for key, n, moe in self._kv_groups():
                s[key] = attn_specs(cfg, ((n, "layers"),), moe=moe)
        elif cfg.family == "ssm":
            s["blocks"] = ssm_mod.ssd_specs(cfg, ((L, "layers"),))
        else:  # hybrid
            reps, extra = self._hybrid_counts()
            n_rec = self._n_rec()
            s["repeats"] = {
                "rglru": rglru_unit_specs(cfg, ((reps, "repeats"),
                                                (n_rec, "pattern"))),
                "attn": attn_specs(cfg, ((reps, "repeats"),)),
            }
            if extra:
                s["extra"] = rglru_unit_specs(cfg, ((extra, "layers"),))
        return s

    def _hybrid_counts(self) -> Tuple[int, int]:
        """(full pattern repeats, extra leading-kind units)."""
        pat = len(self.cfg.block_pattern)
        return self.cfg.num_layers // pat, self.cfg.num_layers % pat

    def _n_rec(self) -> int:
        return sum(1 for bk in self.cfg.block_pattern if bk == "rglru")

    def _kv_groups(self) -> Tuple[Tuple[str, int, bool], ...]:
        """(cache/param key, layers, moe) of each layer group of the KV
        families, in stack order."""
        cfg = self.cfg
        if cfg.family != "moe":
            return (("blocks", cfg.num_layers, False),)
        first = (("dense_blocks", cfg.first_k_dense, False),) \
            if cfg.first_k_dense else ()
        return first + (("blocks", cfg.num_layers - cfg.first_k_dense, True),)

    def init(self, seed: Union[int, torch.Generator] = 0) -> dict:
        """Random parameters from ``seed`` on this model's device."""
        return init_tree(self.specs(), seed, self.dtype, self.device)

    # ------------------------------------------------------------------
    # cache
    # ------------------------------------------------------------------

    def cache_axes(self, batch: int, capacity: int) -> dict:
        """Logical axes of each decode-cache leaf (the JAX package's
        ``cache_axes``): the engine slices a slot's rows along "batch" and
        a stored prefix along "seq"."""
        kv = ("layers", "batch", "seq", "kv_heads", None)
        fam = self.cfg.family
        if fam in KV_FAMILIES:
            out = {key: {"k": kv, "v": kv} for key, _, _ in self._kv_groups()}
            return {**out, "pos": ("batch", "seq"), "index": ("batch",)}
        if fam == "ssm":
            return {"blocks": {"conv": ("layers", "batch", None, "heads"),
                               "h": ("layers", "batch", "heads", None,
                                     None)}}
        rg = lambda pre: {"conv": pre + ("batch", None, "heads"),
                          "h": pre + ("batch", "heads")}
        ring = ("repeats", "batch", "seq", "kv_heads", None)
        out = {"repeats": {"rglru": rg(("repeats", "pattern")),
                           "attn": {"k": ring, "v": ring}},
               "pos": ("batch", "seq"), "index": ("batch",)}
        if self._hybrid_counts()[1]:
            out["extra"] = rg(("layers",))
        return out

    def init_cache(self, batch: int, capacity: int) -> dict:
        """Zero caches (``pos`` -1); recurrent states ``h`` in float32, KV
        and conv windows in the model dtype, as the JAX package keeps
        them."""
        cfg, dev = self.cfg, self.device
        z = lambda shape, dt=None: torch.zeros(shape, dtype=dt or self.dtype,
                                               device=dev)
        bk = lambda w: {"pos": torch.full((batch, w), -1, dtype=torch.int32,
                                          device=dev),
                        "index": torch.zeros((batch,), dtype=torch.int32,
                                             device=dev)}
        hd, k = cfg.resolved_head_dim, cfg.num_kv_heads
        if cfg.family in KV_FAMILIES:
            out = {key: {"k": z((n, batch, capacity, k, hd)),
                         "v": z((n, batch, capacity, k, hd))}
                   for key, n, _ in self._kv_groups()}
            return {**out, **bk(capacity)}
        if cfg.family == "ssm":
            cs = ssm_mod.ssd_cache_shape(cfg, batch)
            return {"blocks": {
                "conv": z((cfg.num_layers,) + cs["conv"]),
                "h": z((cfg.num_layers,) + cs["h"], torch.float32)}}
        reps, extra = self._hybrid_counts()
        w = min(capacity, cfg.local_window)
        cs = rglru_mod.rglru_cache_shape(cfg, batch)
        rg = lambda pre: {"conv": z(pre + cs["conv"]),
                          "h": z(pre + cs["h"], torch.float32)}
        ring = (reps, batch, w, k, hd)
        out = {"repeats": {"rglru": rg((reps, self._n_rec())),
                           "attn": {"k": z(ring), "v": z(ring)}},
               **bk(w)}
        if extra:
            out["extra"] = rg((extra,))
        return out

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------

    def _attn_block(self, lp, x, cos, sin, pos_q, pos_kv, mode, window,
                    lcache, idx, layer: Optional[int] = None,
                    ctx: Optional[int] = None,
                    pages: Optional[torch.Tensor] = None, moe: bool = False):
        """One attention block and its MLP (an MoE layer under ``moe``).
        Returns (x, the prefill's (k, v) or None, the router's aux loss or
        None)."""
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
        elif mode == "chunk":
            # S tokens against the cache (suffix prefill): their KV rows land
            # at consecutive indices after each row's write index (linear
            # placement), and attention masks by absolute position, so each
            # new token sees the cached prefix and its causal predecessors
            # in the chunk. The self-attention kernel ("cuda") and its plain
            # version ("torch") take no positions: the dispatcher's
            # position-aware choice stands in for them, as JAX's ringchunk
            # branch does for "pallas".
            kc, vc = lcache["k"], lcache["v"]
            bi = torch.arange(b, device=x.device)[:, None]
            widx = idx.long()[:, None] + torch.arange(s, device=x.device)
            kc[layer, bi, widx] = k.to(kc.dtype)
            vc[layer, bi, widx] = v.to(vc.dtype)
            kr, vr, pr = kc[layer], vc[layer], pos_kv
            if ctx is not None and ctx < kr.shape[1]:
                kr, vr, pr = kr[:, :ctx], vr[:, :ctx], pos_kv[:, :ctx]
            impl = (self.attn_impl if self.attn_impl in ("dense", "flash")
                    else "auto")
            out = attn_mod.attention(q, kr, vr, pos_q, pr, causal=True,
                                     window=window, impl=impl)
        elif mode == "ringchunk":
            # S tokens against a RING-BUFFER window cache (the hybrid
            # family's suffix prefill): each token attends the old ring
            # content plus the suffix's own KV, masked by absolute position.
            # Exact for any S: whatever a per-token decode would have
            # overwritten before token t carries a position <= t - window
            # and is window-masked regardless. The ring is then rewritten
            # from the suffix tail (position p lives at row p % w).
            kc, vc = lcache["k"], lcache["v"]
            w = kc.shape[2]
            kcat = torch.cat([kc[layer].to(k.dtype), k], dim=1)
            vcat = torch.cat([vc[layer].to(v.dtype), v], dim=1)
            pcat = torch.cat([pos_kv, pos_q.to(torch.int32)], dim=1)
            # the self-attention kernel and its plain version take no
            # positions: the position-aware choice stands in for them
            impl = (self.attn_impl if self.attn_impl in ("dense", "flash")
                    else "auto")
            out = attn_mod.attention(q, kcat, vcat, pos_q, pcat, causal=True,
                                     window=window, impl=impl)
            if s < w:
                bi = torch.arange(b, device=x.device)[:, None]
                widx = (idx.long()[:, None]
                        + torch.arange(s, device=x.device)) % w
                kc[layer, bi, widx] = k.to(kc.dtype)
                vc[layer, bi, widx] = v.to(vc.dtype)
            else:
                r0 = pos_q[:, s - w] % w
                kc[layer] = _ring_roll(k[:, s - w:], r0, 1).to(kc.dtype)
                vc[layer] = _ring_roll(v[:, s - w:], r0, 1).to(vc.dtype)
        else:
            out = attn_mod.attention(q, k, v, pos_q, pos_q, causal=True,
                                     window=window, impl=self.attn_impl)
            if mode == "prefill":
                new_kv = (k, v)
        out = out.reshape(b, s, h_ * hd)
        x = x + torch.matmul(out, lp["wo"]).to(x.dtype)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        aux = None
        if moe:
            y, aux = moe_mod.moe_forward(lp["moe"], h2, cfg, self.moe_impl)
        else:
            y = mlp_forward(lp["mlp"], h2, cfg.activation)
        return x + y.to(x.dtype), new_kv, aux

    # ------------------------------------------------------------------
    # the stack
    # ------------------------------------------------------------------

    def _rglru_unit(self, lp, x, mode, lcache):
        """One RG-LRU unit and its MLP. Decode and the suffix pass
        ("ringchunk") start from ``lcache`` and overwrite it in place with
        the new conv window and state; prefill returns them."""
        cfg = self.cfg
        new_cache = None
        if mode == "decode":
            x, nc = rglru_mod.rglru_decode(lp, x, cfg, lcache)
        elif mode == "ringchunk":
            x, nc = rglru_mod.rglru_forward(lp, x, cfg,
                                            conv_state=lcache["conv"],
                                            h_state=lcache["h"])
        else:
            x, new_cache = rglru_mod.rglru_forward(lp, x, cfg)
        if lcache is not None:
            lcache["conv"].copy_(nc["conv"])
            lcache["h"].copy_(nc["h"])
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_forward(lp["mlp"], h2, cfg.activation).to(x.dtype)
        return x, new_cache

    def _rope(self, positions):
        cfg = self.cfg
        if cfg.family == "ssm":
            return None, None
        return rope_freqs(positions, cfg.resolved_head_dim, cfg.rope_theta)

    def _stack(self, params, x, positions, mode, cache, ctx=None,
               idx=None):
        """Returns (x, the MoE layers' summed aux loss, the prefill's layer
        caches)."""
        cfg = self.cfg
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "ssm":
            x, caches = self._ssm_stack(params, x, mode, cache)
            return x, aux_total, caches
        cos, sin = self._rope(positions)
        if cfg.family == "hybrid":
            x, caches = self._hybrid_stack(params, x, positions, cos, sin,
                                           mode, cache, idx)
            return x, aux_total, caches
        pos_kv = cache["pos"] if cache is not None else None
        pages = cache.get("pages") if cache is not None else None
        layer_caches = {}
        for key, n_layers, moe in self._kv_groups():
            lcache = cache[key] if cache is not None else None
            ks, vs = [], []
            for l in range(n_layers):
                lp = _layer(params[key], l)
                x, kv, aux = self._attn_block(
                    lp, x, cos, sin, positions, pos_kv, mode, None, lcache,
                    idx, layer=l, ctx=ctx, pages=pages, moe=moe)
                if aux is not None:
                    aux_total = aux_total + aux
                if kv is not None:
                    ks.append(kv[0])
                    vs.append(kv[1])
            if ks:
                layer_caches[key] = {"k": torch.stack(ks),
                                     "v": torch.stack(vs)}
        return x, aux_total, layer_caches

    def _ssm_stack(self, params, x, mode, cache):
        """Mamba-2 layers. Prefill returns the stacked conv windows and
        states; decode and the suffix pass ("ringchunk") start from the
        cache and overwrite it in place."""
        cfg = self.cfg
        convs, hs = [], []
        for l in range(cfg.num_layers):
            lp = _layer(params["blocks"], l)
            if cache is None:
                x, nc = ssm_mod.ssd_forward(lp, x, cfg)
                convs.append(nc["conv"])
                hs.append(nc["h"])
                continue
            lc = _layer(cache["blocks"], l)
            if mode == "decode":
                x, nc = ssm_mod.ssd_decode(lp, x, cfg, lc)
            else:
                x, nc = ssm_mod.ssd_forward(lp, x, cfg, conv_state=lc["conv"],
                                            h_state=lc["h"])
            lc["conv"].copy_(nc["conv"])
            lc["h"].copy_(nc["h"])
        if convs:
            return x, {"blocks": {"conv": torch.stack(convs),
                                  "h": torch.stack(hs)}}
        return x, {}

    def _hybrid_stack(self, params, x, positions, cos, sin, mode, cache,
                      idx):
        """Repeats of (rglru x n_rec, local attention), then the extra
        rglru units. Attention is over a window of ``local_window``:
        prefill through ``attention`` (the flash kernel under "cuda"),
        decode through the dense decode dispatcher over the ring."""
        cfg = self.cfg
        reps, extra = self._hybrid_counts()
        n_rec = self._n_rec()
        win = cfg.local_window
        pos_kv = cache["pos"] if cache is not None else None
        rep_c = cache["repeats"] if cache is not None else None
        rg, ks, vs = [], [], []
        for r in range(reps):
            lp = _layer(params["repeats"], r)
            units = []
            for i in range(n_rec):
                subc = (None if rep_c is None else
                        {n: rep_c["rglru"][n][r, i] for n in ("conv", "h")})
                x, nc = self._rglru_unit(_layer(lp["rglru"], i), x, mode,
                                         subc)
                units.append(nc)
            x, kv, _ = self._attn_block(
                lp["attn"], x, cos, sin, positions, pos_kv, mode, win,
                None if rep_c is None else rep_c["attn"], idx, layer=r)
            if kv is not None:
                rg.append(units)
                ks.append(kv[0])
                vs.append(kv[1])
        ex = []
        for e in range(extra):
            subc = (None if cache is None else
                    {n: cache["extra"][n][e] for n in ("conv", "h")})
            x, nc = self._rglru_unit(_layer(params["extra"], e), x, mode,
                                     subc)
            ex.append(nc)
        if not ks:
            return x, {}
        stack = lambda units, n: torch.stack([u[n] for u in units])
        out = {"repeats": {
            "rglru": {n: torch.stack([stack(u, n) for u in rg])
                      for n in ("conv", "h")},
            "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}}
        if ex:
            out["extra"] = {n: stack(ex, n) for n in ("conv", "h")}
        return x, out

    # ------------------------------------------------------------------
    # modes
    # ------------------------------------------------------------------

    def _embed_inputs(self, params, batch, mode):
        cfg = self.cfg
        x = embed(batch["tokens"], params["embed"]).to(self.dtype)
        prefix = 0
        if (cfg.frontend == "vision_stub"
                and mode not in ("decode", "chunk", "ringchunk")
                and "patches" in batch):
            px = torch.matmul(batch["patches"].to(self.dtype),
                              params["proj_in"])
            x = torch.cat([px, x], dim=1)
            prefix = px.shape[1]
        return x, prefix

    def forward(self, params, batch, mode="prefill", cache=None, ctx=None,
                idx=None):
        """Backbone -> (final hidden states (B, S_total, D), the MoE aux
        loss, the prefill's layer caches, the vision prefix length)."""
        x, prefix = self._embed_inputs(params, batch, mode)
        b, s, _ = x.shape
        if mode == "decode":
            positions = batch["positions"][:, None]
        elif mode == "chunk":
            positions = batch["positions"]  # (B, S) absolute
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
        x, aux, layer_caches = self._stack(params, x, positions, mode, cache,
                                           ctx, idx)
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return x, aux, layer_caches, prefix

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
        hidden, _, layer_caches, prefix = self.forward(params, batch,
                                                       "prefill")
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
        """Pad per-layer prefill KV into capacity-sized decode caches; the
        hybrid family's into its ring (position p at row p % w)."""
        cfg, dev = self.cfg, self.device
        if cfg.family == "ssm":
            return {"blocks": layer_caches["blocks"]}
        ring = cfg.family == "hybrid"
        w = min(capacity, cfg.local_window) if ring else capacity

        def fit(kv, axis):  # time axis `axis` of length s -> w rows
            if s >= w:
                last = kv.narrow(axis, s - w, w)
                return torch.roll(last, (s - w) % w, dims=axis) if ring \
                    else last.contiguous()
            shape = list(kv.shape)
            shape[axis] = w
            out = torch.full(shape, -1, dtype=kv.dtype, device=dev) \
                if kv.dtype == torch.int32 else kv.new_zeros(shape)
            out.narrow(axis, 0, s).copy_(kv)
            return out

        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        cache: Dict[str, Any] = {"pos": fit(pos, 1)}
        if ring:
            rep = layer_caches["repeats"]
            cache["repeats"] = {"rglru": rep["rglru"],
                                "attn": {n: fit(v, 2)
                                         for n, v in rep["attn"].items()}}
            if "extra" in layer_caches:
                cache["extra"] = layer_caches["extra"]
            cache["index"] = torch.full((b,), s % w, dtype=torch.int32,
                                        device=dev)
        else:
            for key, kv in layer_caches.items():  # (dense_blocks,) blocks
                cache[key] = {n: fit(v, 2) for n, v in kv.items()}
            cache["index"] = torch.full((b,), min(s, w) % max(w, 1),
                                        dtype=torch.int32, device=dev)
        return cache

    def decode_step(self, params, cache, batch, ctx=None):
        """One token. batch: tokens (B,1), positions (B,). Returns
        (logits (B, V), cache), the cache updated in place.

        ``ctx`` hints that every live cache entry, this token's write
        included, sits at an index below ``ctx``: attention then reads only
        the leading ``ctx`` entries. Bookkeeping stays full width (the
        ring's width for the hybrid family; the ssm family keeps none)."""
        idx = None
        if "pos" in cache:
            idx = cache["index"].clone()  # (B,) this token's write index
            bi = torch.arange(idx.shape[0], device=idx.device)
            cache["pos"][bi, idx.long()] = batch["positions"].to(torch.int32)
            cap = cache["pos"].shape[1]
            cache["index"] = (idx + 1) % cap
        hidden, _, _, _ = self.forward(params, batch, "decode", cache, ctx,
                                       idx)
        return self._logits(params, hidden)[:, 0], cache

    def decode_chunk(self, params, cache, batch, ctx=None,
                     all_logits: bool = False):
        """S tokens against the cache: the suffix prefill of a prefix-store
        hit or a resumed session. batch: tokens (B, S), absolute positions
        (B, S), optional lengths (B,) of right-padded rows. Returns
        (logits of each row's last real token (B, V), cache), or with
        ``all_logits`` every position's logits (B, S, V); the cache is
        updated in place.

        The S rows land linearly after each row's write index, which must
        leave them inside the capacity (the engine sizes its padded suffix
        so); ``index`` advances by S modulo the capacity. A padded row's
        tail entries carry positions past its true end: the CALLER re-masks
        them to -1, as after a bucketed prefill. Dense (not paged) caches
        only."""
        cfg = self.cfg
        assert cfg.family in KV_FAMILIES, (
            "decode_chunk needs positionally addressable KV; "
            f"{cfg.family} carries point-in-time recurrent state")
        if "pages" in cache:
            raise ValueError("decode_chunk takes a dense cache, not a paged "
                             "pool")
        b, s = batch["tokens"].shape
        idx = cache["index"].clone()  # (B,) this chunk's write start
        bi = torch.arange(b, device=idx.device)[:, None]
        widx = idx.long()[:, None] + torch.arange(s, device=idx.device)
        # written before the forward: the new tokens must see themselves
        cache["pos"][bi, widx] = batch["positions"].to(torch.int32)
        cap = cache["pos"].shape[1]
        cache["index"] = ((idx + s) % cap).to(torch.int32)
        hidden, _, _, _ = self.forward(params, batch, "chunk", cache, ctx,
                                       idx)
        if all_logits:
            return self._logits(params, hidden), cache
        if "lengths" in batch:
            last = batch["lengths"].long() - 1
            hidden = hidden[bi[:, 0], last][:, None]
        else:
            hidden = hidden[:, -1:]
        return self._logits(params, hidden)[:, 0], cache

    def decode_chunk_recurrent(self, params, cache, batch,
                               all_logits: bool = False):
        """S tokens for the RECURRENT families (ssm, hybrid): the suffix
        prefill of a prefix-store hit or a resumed session, and the verify
        chunk of speculation. batch: tokens (B, S), absolute positions
        (B, S) continuing the cached state (no padding: every token advances
        the recurrence). Returns (last-token logits (B, V), cache), or every
        position's logits (B, S, V) under ``all_logits``; the cache is
        updated in place.

        The cached state (conv window + SSM/LRU state) summarizes the whole
        prefix at a point in time, so the suffix replays in ONE pass:
        ``ssd_forward``/``rglru_forward`` fold the state into their scans.
        The hybrid ring takes the "ringchunk" attention branch (old ring +
        suffix KV under absolute-position window masking, exact for any
        suffix length); ``pos``/``index`` advance after it."""
        cfg = self.cfg
        assert cfg.family in ("ssm", "hybrid"), (
            "decode_chunk_recurrent seeds point-in-time recurrent state; "
            f"use decode_chunk for {cfg.family}")
        x, _ = self._embed_inputs(params, batch, "ringchunk")
        b, s, _ = x.shape
        positions = batch["positions"].to(torch.int32)  # (B, S)
        if cfg.family == "ssm":
            x, _ = self._ssm_stack(params, x, "ringchunk", cache)
        else:
            idx = cache["index"].clone()
            cos, sin = self._rope(positions)
            x, _ = self._hybrid_stack(params, x, positions, cos, sin,
                                      "ringchunk", cache, idx)
            # ring bookkeeping (invariant: position p lives at row p % w)
            w = cache["pos"].shape[1]
            if s < w:
                bi = torch.arange(b, device=x.device)[:, None]
                widx = (idx.long()[:, None]
                        + torch.arange(s, device=x.device)) % w
                cache["pos"][bi, widx] = positions
            else:
                cache["pos"].copy_(_ring_roll(positions[:, s - w:],
                                              positions[:, s - w] % w, 1))
            cache["index"] = ((idx + s) % w).to(torch.int32)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        if all_logits:
            return self._logits(params, x), cache
        return self._logits(params, x[:, -1:])[:, 0], cache
