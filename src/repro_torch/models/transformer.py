"""Decoder-only LM for the ``dense``, ``vlm``, ``moe``, ``ssm`` and
``hybrid`` families. Counterpart of ``repro/models/transformer.py::DecoderLM``.

Parameters travel as a nested dict with the JAX tree's names and
layer-stacked shapes (``blocks/wq`` is ``(L, d, H*hd)``), so one model
object serves several engines and a JAX parameter tree converts by copy
(``repro_torch.convert``). The cache tree keeps the JAX leaf names and row
shapes: ``blocks/{k,v}`` ``(L, B, T, K, hd)``, ``pos`` ``(B, T)``,
``index`` ``(B,)``, plus ``pages`` ``(B, n_pt)`` when the engine pages the
KV leaves into ``(L, P, page, K, hd)`` pools. A decode step's cache dict may
also carry ``lens`` ``(B,)`` int32, the rows each slot attends (0 for a dead
slot): the paged decode reads only those (the engine's fused step passes
it; nothing stores it). The ``moe`` family's layers
fall in two groups, ``dense_blocks`` (its first ``first_k_dense`` layers,
a dense MLP) and ``blocks`` (an MoE layer each), with a KV leaf pair each
over the shared ``pos``/``index``. The ``ssm`` cache is
``blocks/{conv,h}`` (Mamba-2 conv window and f32 state per layer, no
``pos``); the ``hybrid`` cache holds ``repeats/rglru/{conv,h}`` ``(R, n_rec,
B, ...)`` (batch at axis 2), ``repeats/attn/{k,v}`` ``(R, B, w, K, hd)``, a
ring of ``w = min(capacity, local_window)`` rows where position p lives at
row p % w, ``extra/{conv,h}`` for layers past the last whole pattern, and
``pos``/``index`` ``(B, w)``/``(B,)`` over the ring.

Training (``loss``) runs the "train" mode: the full sequence, no cache,
each layer (each pattern repeat for ``hybrid``) under the
``sharding.remat_policy`` rematerialisation, and the cross entropy in
sequence chunks.

Unlike the JAX package, decode updates the cache IN PLACE: ``decode_step``
(one token) and ``decode_chunk`` (S tokens against the cache, the suffix
prefill of a warm admission) write ``pos`` / ``index`` and each layer's new
K/V rows into the tensors they were given (before attention reads them) and
return the same dict; so do ``decode_chunk_recurrent`` and the recurrent
families' decode, which overwrite each layer's conv window and state.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig, ShapeConfig, ShardingConfig
from repro_torch.distributed.sharding import (PartitionSpec, local_block,
                                              logical_constraint,
                                              logical_pspec, mesh_axis_sizes,
                                              new_zeros, to_placements)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_rope, embed, pad_vocab,
                                       rms_norm, rope_freqs, unembed)
from repro_torch.models.mlp import mlp_forward, mlp_specs
from repro_torch.models.spec import ParamSpec, init_tree, shape_tree

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


def mesh_impls(mesh, attn_impl: str, decode_impl: str) -> str:
    """The decode impl a model takes on ``mesh``. The hand kernels take no
    DTensor: under a mesh "auto" runs the plain versions, and "cuda" is
    refused (the JAX package never runs Pallas under a mesh either)."""
    if mesh is None:
        return decode_impl
    if "cuda" in (attn_impl, decode_impl):
        raise ValueError(
            "the CUDA attention kernels take no DTensor: a model on a mesh "
            "runs attn_impl/decode_impl 'auto' (the plain versions); the "
            "kernels under a mesh are not ported yet")
    return "torch" if decode_impl == "auto" else decode_impl


def mesh_context(mesh):
    """The context a model's step runs in: on a mesh, plain tensors made
    inside the step (positions, masks, rope tables, zeros) count as
    replicated DTensors (``implicit_replication``); else nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if DTensor._op_dispatcher._allow_implicit_replication:
        # already inside one: the context resets the flag when it exits
        return contextlib.nullcontext()
    return implicit_replication()


def on_mesh(fn):
    """Run method ``fn`` under its model's :func:`mesh_context`."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with mesh_context(self.mesh):
            return fn(self, *args, **kwargs)
    return run


def split_heads(mesh, t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n*hd) -> (B, S, n, hd). On a mesh the flat projection is first
    laid out so that the split is legal: its last dim over "model" only if
    the head count divides it (the rules may shard n*hd where n does not
    divide, e.g. 8 KV heads on 16 ranks)."""
    b, s = t.shape[:2]
    if mesh is not None:
        ps = logical_pspec(("batch", None, "heads", None), (b, s, n, hd),
                           mesh)
        want = to_placements(PartitionSpec(*ps[:3]), mesh)
        if tuple(t.placements) != want and any(
                pl.is_shard(2) for pl in t.placements):
            t = t.redistribute(mesh, tuple(
                want[i] if pl.is_shard(2) else pl
                for i, pl in enumerate(t.placements)))
    return t.reshape(b, s, n, hd)


def attend(mesh, fn, q, k, v, pos_q, pos_kv, **kw):
    """``fn(q, k, v, pos_q, pos_kv, **kw)``, an attention function, on a
    mesh: each rank runs ``fn`` on its block, the batch over the batch axes
    and the query heads over "model" where the rules shard them. Attention
    mixes neither batch rows nor KV head groups, so a rank needs only the
    KV heads its query heads read: all of them sharded alike when the KV
    head count divides "model" too, else the KV heads replicated and each
    rank slicing out its own (their gradient then a partial sum over
    "model"). The output is that block of the global result; DTensor never
    sees the attention's products. Without a mesh, ``fn`` as it is."""
    if mesh is None:
        return fn(q, k, v, pos_q, pos_kv, **kw)
    from torch.distributed.tensor import DTensor, Partial

    h, kh = q.shape[2], k.shape[2]
    qs = logical_pspec(("batch", None, "heads", None), tuple(q.shape), mesh)
    ks = logical_pspec(("batch", None, "kv_heads", None), tuple(k.shape),
                       mesh)
    heads, kv_slice = qs[2], None
    if heads is not None and ks[2] != heads:
        n = mesh_axis_sizes(mesh)[heads]
        per, g = h // n, h // kh
        if per % g == 0 or g % per == 0:  # no rank's heads straddle groups
            r = mesh.get_local_rank(heads)
            kv_slice = slice(r * per // g, ((r + 1) * per - 1) // g + 1)
        else:
            heads = None
    q_spec = PartitionSpec(qs[0], None, heads, None)
    kv_spec = q_spec if kv_slice is None else PartitionSpec(qs[0], None,
                                                            None, None)
    row = PartitionSpec(qs[0], None)

    def local(x, ps, grad=None):
        if x is None:
            return None
        return local_block(x, mesh, to_placements(
            PartitionSpec(*ps[:x.dim()]), mesh), grad)

    if kv_slice is None:
        kl, vl = local(k, kv_spec), local(v, kv_spec)
    else:
        part = tuple(Partial() if n == heads else p for n, p in zip(
            mesh.mesh_dim_names, to_placements(kv_spec, mesh)))
        kl = local(k, kv_spec, part)[:, :, kv_slice]
        vl = local(v, kv_spec, part)[:, :, kv_slice]
    out = fn(local(q, q_spec), kl, vl, local(pos_q, row),
             local(pos_kv, row), **kw)
    # the global shape and stride follow from the (even) contiguous block:
    # an attention output that is a transposed view would otherwise carry
    # a global stride its local block lacks, and a later view would fail
    return DTensor.from_local(out.contiguous(), mesh,
                              to_placements(q_spec, mesh), run_check=False)


#: the products whose outputs the "dots" policy keeps (``dots_saveable``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under the JAX package's remat policy: "none" keeps every
    activation for the backward pass, "full" keeps only ``fn``'s inputs and
    recomputes the rest (``nothing_saveable``), "dots" keeps the matmul
    outputs and recomputes the rest (``dots_saveable``)."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"remat policy {policy!r} not in none, dots, full")


def check_trainable(attn_impl: str) -> None:
    """Refuse a loss under the attention kernel or its stand-in: the kernel
    has no backward (its wrapper returns a tensor with no ``grad_fn``, so
    every q/k/v projection would get no gradient), nor has the JAX
    package's Pallas kernel. "torch" stands in for "cuda" on the CPU, so it
    is refused too: it would train where the card cannot."""
    if attn_impl in ("cuda", "torch"):
        raise NotImplementedError(
            f"attn_impl {attn_impl!r} cannot train: the flash-attention "
            f"kernel has no backward kernel (its output carries no "
            f"gradient); build the model with attn_impl='auto' to train")


def _ce_chunk(h, table, labels, mask, true_vocab=None, constrain=None):
    logits = unembed(h.float(), table)
    if true_vocab is None:  # the table holds the true vocab
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        # the padded table (its vocab dim sharded on a mesh): the tail
        # masked, as the JAX package's ``unembed``, and the gold logit
        # picked by a masked sum over the vocab (no gather across shards)
        cols = torch.arange(table.shape[0], device=h.device)
        logits = constrain(torch.where(cols < true_vocab, logits, -1e30))
        gold = torch.where(cols == labels.long()[..., None], logits,
                           0.0).sum(-1)
    logz = torch.logsumexp(logits, dim=-1)
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_ce(hidden: torch.Tensor, table: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor,
               true_vocab: Optional[int] = None, constrain=None
               ) -> torch.Tensor:
    """Masked mean cross entropy over (B, S) positions, the logits made and
    kept one sequence chunk at a time (the JAX package's ``_chunked_ce``):
    the first of 8, 4, 2, 1 chunks that divides S and leaves >= 128 rows,
    each chunk recomputed in the backward pass. ``table``: (V, D) float32,
    the true vocab, or the padded table with ``true_vocab`` rows real (its
    tail masked; on a mesh, so that the vocab stays sharded); ``mask``:
    float32; ``constrain`` lays out each chunk's logits."""
    b, s, _ = hidden.shape
    nc = next((c for c in (8, 4, 2, 1) if s % c == 0 and s // c >= 128), 1)
    c = s // nc
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for j in range(nc):
        sl = slice(j * c, (j + 1) * c)
        t, n = checkpoint(_ce_chunk, hidden[:, sl], table, labels[:, sl],
                          mask[:, sl], true_vocab, constrain,
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


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


def _write_rows(leaf: torch.Tensor, layer: Optional[int], idx: torch.Tensor,
                rows: torch.Tensor) -> None:
    """``leaf[layer, b, idx[b]] = rows[b]`` for every batch row b, in place
    (``leaf[b, idx[b]]`` when ``layer`` is None). A DTensor leaf (a cache on
    a mesh) takes a select-and-copy of the layer instead of the scatter,
    which DTensor cannot place on a sharded batch dim."""
    rows = rows.to(leaf.dtype)
    if not hasattr(leaf, "placements"):
        bi = torch.arange(idx.shape[0], device=idx.device)
        if layer is None:
            leaf[bi, idx.long()] = rows
        else:
            leaf[layer, bi, idx.long()] = rows
        return
    cur = leaf if layer is None else leaf[layer]
    hit = (torch.arange(cur.shape[1], device=idx.device)[None]
           == idx.long()[:, None])  # (B, T)
    hit = hit.reshape(hit.shape + (1,) * (cur.dim() - 2))
    rows = rows.reshape(rows.shape[:1] + (1,) + rows.shape[1:])
    cur.copy_(torch.where(hit, rows, cur))


def page_slots(pages: torch.Tensor, page: int, s: int,
               capacity: int) -> Dict[str, Any]:
    """Where a prefill of ``s`` positions lands in a paged pool viewed as
    flat rows ``(P * page, ...)``: row b's logical page j is physical page
    ``pages[b, j]`` (int64), for j < ``pages.shape[1]``. Those pages hold
    what the capacity-wide cache of the prefill would: the prompt's rows
    from ``lo`` (its last ``capacity`` rows when longer), ``m`` of them, at
    the flat rows ``dst``; zeros at the flat rows ``tail``."""
    lo = max(0, s - capacity)
    n = pages.shape[1] * page
    m = min(s - lo, n)
    t = torch.arange(n, device=pages.device)
    flat = pages[:, t // page] * page + t % page
    return {"lo": lo, "m": m, "dst": flat[:, :m].reshape(-1),
            "tail": flat[:, m:].reshape(-1)}


def write_pages(pool: torch.Tensor, at: Dict[str, Any],
                rows: torch.Tensor) -> None:
    """One layer's prefill K or V rows (B, S, ...) into its paged pool
    ``(P, page, ...)``, in place, at the flat rows :func:`page_slots`
    gave."""
    src = rows[:, at["lo"]:at["lo"] + at["m"]]
    pool.view((-1,) + tuple(pool.shape[2:])).index_copy_(
        0, at["dst"], src.reshape((-1,) + tuple(rows.shape[2:])).to(
            pool.dtype))


def _layer(tree: Dict[str, Any], l: int) -> Dict[str, Any]:
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


class DecoderLM(nn.Module):
    """Decoder LM over an explicit parameter dict (see the module doc).

    On a ``mesh`` (a ``DeviceMesh`` with dims named "data", "model" and
    optionally "pod"), parameters and batch leaves are DTensors and the
    model lays out its activations by logical axes at the JAX package's
    sites (``_constrain``): q by heads, the residual stream by batch and
    ``seq`` (``seq_sp``, sharded over "model", under
    ``sharding.sequence_parallel``), the loss's logits by vocab. Plain
    tensors made inside a step count as replicated (``mesh_context``). The
    MoE layers take their expert-parallel paths (``moe_forward``). The
    model's device is the mesh's device type."""

    def __init__(self, cfg: ModelConfig, attn_impl: str = "auto",
                 param_dtype: str = "", decode_impl: str = "auto",
                 device: Union[str, torch.device] = "cuda",
                 moe_impl: str = "auto",
                 sharding: ShardingConfig = ShardingConfig(), mesh=None):
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
        self.mesh = mesh
        self.attn_impl = attn_impl
        self.moe_impl = moe_impl
        self.decode_impl = mesh_impls(mesh, attn_impl, decode_impl)
        # ``remat_policy`` and, on a mesh, ``sequence_parallel`` are read
        self.sharding = sharding
        self._seq = "seq_sp" if sharding.sequence_parallel else "seq"
        self.v_pad = pad_vocab(cfg.vocab_size)
        self.dtype = DTYPES[param_dtype or cfg.dtype]
        self.device = resolve_device(device if mesh is None
                                     else mesh.device_type)
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

    def param_shapes(self) -> dict:
        """The parameter tree as meta tensors (the dry-run's arguments)."""
        return shape_tree(self.specs(), self.dtype)

    def input_specs(self, shape: ShapeConfig) -> Tuple[dict, dict]:
        """(meta-tensor tree, logical-axes tree) of a shape cell's batch:
        the JAX package's ``input_specs`` (the dry-run's data contract)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = lambda shp, dt=torch.int32: torch.empty(shp, dtype=dt,
                                                       device="meta")
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": meta((b, s))}
            axes = {"tokens": ("batch", "seq")}
            if shape.kind == "train":
                specs["labels"] = meta((b, s))
                axes["labels"] = ("batch", "seq")
            if cfg.frontend == "vision_stub":
                specs["patches"] = meta((b, cfg.num_patches,
                                         cfg.frontend_dim), torch.float32)
                axes["patches"] = ("batch", None, "frontend")
        else:  # decode: one token against a seq_len-deep cache
            specs = {"tokens": meta((b, 1)), "positions": meta((b,))}
            axes = {"tokens": ("batch", "seq"), "positions": ("batch",)}
        return specs, axes

    def cache_specs(self, batch: int, capacity: int) -> dict:
        """The decode cache as meta tensors: ``pos``/``index`` int32,
        recurrent ``h`` float32, the rest in the model dtype."""
        return self.init_cache(batch, capacity, device="meta")

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

    def init_cache(self, batch: int, capacity: int, device=None) -> dict:
        """Zero caches (``pos`` -1); recurrent states ``h`` in float32, KV
        and conv windows in the model dtype, as the JAX package keeps
        them. On this model's device unless ``device`` says otherwise."""
        cfg, dev = self.cfg, device or self.device
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
                    pages: Optional[torch.Tensor] = None, moe: bool = False,
                    lens: Optional[torch.Tensor] = None):
        """One attention block and its MLP (an MoE layer under ``moe``).
        Returns (x, the prefill's (k, v) or None, the router's aux loss or
        None)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h_, k_, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        hh = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = split_heads(self.mesh, torch.matmul(hh, lp["wq"]), h_, hd)
        k = split_heads(self.mesh, torch.matmul(hh, lp["wk"]), k_, hd)
        v = split_heads(self.mesh, torch.matmul(hh, lp["wv"]), k_, hd)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
            k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        q = self._constrain(q, ("batch", "seq", "heads", None))

        new_kv = None
        if mode == "decode" and pages is not None:
            # paged decode: KV rows live in a shared physical pool
            # (L, P, page, K, hd); the slot's page table maps logical page
            # -> physical page (0 = null page). Write one row THROUGH the
            # table, then attend page by page; unwritten entries are masked
            # via pos (null-page garbage contributes nothing to live rows);
            # with ``lens`` a slot reads only its leading lens[b] rows
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
            if self.mesh is not None:
                raise NotImplementedError("paged decode runs on one device, "
                                          "not on a mesh")
            out = attn_mod.decode_attention_paged(
                q, kc[layer], vc[layer], pages[:, :npg], pos_q[:, 0],
                pos_kv[:, :ctx_eff], window=window, impl=self.decode_impl,
                lens=lens)
        elif mode == "decode":
            kc, vc = lcache["k"], lcache["v"]
            _write_rows(kc, layer, idx, k[:, 0])
            _write_rows(vc, layer, idx, v[:, 0])
            kr, vr, pr = kc[layer], vc[layer], pos_kv
            if ctx is not None and ctx < kr.shape[1]:
                # context hint: attend only the leading ctx entries (views,
                # no copy; the kernel takes the strides)
                kr, vr, pr = kr[:, :ctx], vr[:, :ctx], pos_kv[:, :ctx]
            out = attend(self.mesh, attn_mod.decode_attention, q, kr, vr,
                         pos_q[:, 0], pr, window=window,
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
            out = attend(self.mesh, attn_mod.attention, q, kr, vr, pos_q, pr,
                         causal=True, window=window, impl=impl)
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
            out = attend(self.mesh, attn_mod.attention, q, kcat, vcat, pos_q,
                         pcat, causal=True, window=window, impl=impl)
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
            out = attend(self.mesh, attn_mod.attention, q, k, v, pos_q, pos_q,
                         causal=True, window=window, impl=self.attn_impl)
            if mode == "prefill":
                new_kv = (k, v)
        out = out.reshape(b, s, h_ * hd)
        x = x + torch.matmul(out, lp["wo"]).to(x.dtype)
        x = self._constrain(x, ("batch", self._seq, "embed"))
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        aux = None
        if moe:
            y, aux = moe_mod.moe_forward(lp["moe"], h2, cfg, self.moe_impl,
                                         mesh=self.mesh)
        else:
            y = mlp_forward(lp["mlp"], h2, cfg.activation)
        x = x + y.to(x.dtype)
        return self._constrain(x, ("batch", self._seq, "embed")), new_kv, aux

    def _constrain(self, x, axes):
        return logical_constraint(x, axes, self.mesh)

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
            if mode == "train":
                new_cache = None
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

    def _remat_layer(self, fn, mode):
        """``fn`` (one layer) under the remat policy in "train" mode."""
        return _remat(fn, self.sharding.remat_policy if mode == "train"
                      else "none")

    def _stack(self, params, x, positions, mode, cache, ctx=None,
               idx=None, kv_sink=None):
        """Returns (x, the MoE layers' summed aux loss, the prefill's layer
        caches). With ``kv_sink``, a prefill hands each layer's (k, v) to
        ``kv_sink(key, layer, k, v)`` as the layer produces them and keeps
        none (the KV families only)."""
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
        lens = (cache.get("lens") if cache is not None and mode == "decode"
                else None)
        layer_caches = {}
        block = self._remat_layer(self._attn_block, mode)
        for key, n_layers, moe in self._kv_groups():
            lcache = cache[key] if cache is not None else None
            ks, vs = [], []
            for l in range(n_layers):
                lp = _layer(params[key], l)
                x, kv, aux = block(
                    lp, x, cos, sin, positions, pos_kv, mode, None, lcache,
                    idx, layer=l, ctx=ctx, pages=pages, moe=moe, lens=lens)
                if aux is not None:
                    aux_total = aux_total + aux
                if kv is not None and kv_sink is not None:
                    kv_sink(key, l, *kv)
                    kv = None  # freed before the next layer runs
                elif kv is not None:
                    ks.append(kv[0])
                    vs.append(kv[1])
            if ks:
                layer_caches[key] = {"k": torch.stack(ks),
                                     "v": torch.stack(vs)}
        return x, aux_total, layer_caches

    def _ssm_stack(self, params, x, mode, cache):
        """Mamba-2 layers. Prefill returns the stacked conv windows and
        states (train returns none); decode and the suffix pass
        ("ringchunk") start from the cache and overwrite it in place."""
        cfg = self.cfg
        convs, hs = [], []
        forward = self._remat_layer(ssm_mod.ssd_forward, mode)
        for l in range(cfg.num_layers):
            lp = _layer(params["blocks"], l)
            if cache is None:
                x, nc = forward(lp, x, cfg)
                if mode != "train":
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
        def repeat(lp, x, r):
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
            return x, units, kv

        repeat = self._remat_layer(repeat, mode)  # per repeat, as in JAX
        rg, ks, vs = [], [], []
        for r in range(reps):
            x, units, kv = repeat(_layer(params["repeats"], r), x, r)
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
        return self._constrain(x, ("batch", self._seq, "embed")), prefix

    @on_mesh
    def forward(self, params, batch, mode="prefill", cache=None, ctx=None,
                idx=None, kv_sink=None):
        """Backbone -> (final hidden states (B, S_total, D), the MoE aux
        loss, the prefill's layer caches, the vision prefix length).
        ``kv_sink``: see :meth:`_stack`."""
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
                                           ctx, idx, kv_sink)
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return x, aux, layer_caches, prefix

    @on_mesh
    def loss(self, params, batch):
        """Mean cross entropy (+ the MoE aux loss times
        ``router_aux_coef``). batch: tokens, labels (B, S), optional
        patches and loss_mask; the vision prefix takes no loss. Returns
        (total, {"ce", "aux"})."""
        check_trainable(self.attn_impl)
        hidden, aux, _, prefix = self.forward(params, batch, "train")
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)
        if prefix:
            b = labels.shape[0]
            labels = torch.cat([labels.new_zeros((b, prefix)), labels], 1)
            mask = torch.cat([mask.new_zeros((b, prefix)), mask], 1)
        # the table under autograd, never ``unembed_table_f32``'s copy: an
        # in-place optimizer step keeps its storage, so the copy would be
        # stale, and it would carry an earlier step's graph
        table = params["embed"] if self.cfg.tie_embeddings \
            else params["unembed"]
        if self.mesh is None:
            ce = chunked_ce(hidden, table[:self.cfg.vocab_size].float(),
                            labels, mask.float())
        else:
            ce = chunked_ce(hidden, table.float(), labels, mask.float(),
                            self.cfg.vocab_size,
                            lambda lg: self._constrain(
                                lg, ("batch", "seq", "vocab")))
        return ce + self.cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

    def unembed_table_f32(self, params) -> torch.Tensor:
        """The unembedding table sliced to the true vocab, in float32. A
        low-precision table is upcast once and kept (keyed by storage)."""
        table = params["embed"] if self.cfg.tie_embeddings else params["unembed"]
        table = table[:self.cfg.vocab_size]
        if table.dtype == torch.float32 or self.mesh is not None:
            return table.float()
        key = (table.data_ptr(), tuple(table.shape), table.dtype, table.device)
        if self._f32_table is None or self._f32_table[0] != key:
            self._f32_table = (key, table.float())
        return self._f32_table[1]

    def _logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return unembed(hidden.float(), self.unembed_table_f32(params))

    @on_mesh
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
        logits = self._last_logits(params, hidden, batch, prefix)
        cache = self._assemble_prefill_cache(layer_caches, b, s, capacity)
        return logits, cache

    def prefill_paged(self, params, batch, pool: Dict[str, Any],
                      pages: torch.Tensor, capacity: int) -> torch.Tensor:
        """Run the prompt and write each layer's K and V straight into a
        paged pool as the layer produces them; returns the last-token
        logits (B, V), as :meth:`prefill` does.

        ``pool`` holds the pool leaves ``(L, P, page, K, hd)`` under the
        stack's keys (the engine's cache); ``pages`` (B, n) is the physical
        page of each row's first n logical pages (0, the null page, past
        what a row reserved). Each of those pages receives what it would
        hold of :meth:`prefill`'s capacity-wide cache: the prompt's rows,
        zeros past its end (the last ``capacity`` rows of a longer
        prompt). No K/V beyond the layer in flight is held. The caller
        writes ``pos``, ``index`` and the page tables."""
        if self.cfg.family not in KV_FAMILIES:
            raise ValueError(f"a paged prefill needs positional KV pages; "
                             f"{self.cfg.family} keeps recurrent state")
        if self.mesh is not None:
            raise NotImplementedError("a paged prefill runs on one device, "
                                      "not on a mesh")
        pages = pages.long()
        at: Dict[str, Any] = {}  # set at the first layer, which knows S

        def sink(key, layer, k, v):
            leaves = (pool[key]["k"], pool[key]["v"])
            if not at:
                at.update(page_slots(pages, leaves[0].shape[2], k.shape[1],
                                     capacity))
            if layer == 0 and at["tail"].numel():
                for leaf in leaves:  # every layer's rows past the prompt
                    leaf.view(leaf.shape[:1] + (-1,)
                              + tuple(leaf.shape[3:]))[:, at["tail"]] = 0
            write_pages(leaves[0][layer], at, k)
            write_pages(leaves[1][layer], at, v)
        hidden, _, _, prefix = self.forward(params, batch, "prefill",
                                            kv_sink=sink)
        return self._last_logits(params, hidden, batch, prefix)

    def _last_logits(self, params, hidden, batch, prefix) -> torch.Tensor:
        """Logits (B, V) at each row's true last token (``lengths`` of a
        right-padded batch; else the last row)."""
        if "lengths" in batch:
            b = hidden.shape[0]
            last = prefix + batch["lengths"].long() - 1
            hl = hidden[torch.arange(b, device=hidden.device), last][:, None]
        else:
            hl = hidden[:, -1:]
        return self._logits(params, hl)[:, 0]

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
                if kv.dtype == torch.int32 else new_zeros(kv, shape)
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

    @on_mesh
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
            _write_rows(cache["pos"], None, idx,
                        batch["positions"].to(torch.int32))
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
