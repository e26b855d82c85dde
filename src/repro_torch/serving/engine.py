"""Live continuous-batching serving engine (runs real models). Counterpart
of ``repro/serving/engine.py::TierEngine`` for every family of the zoo.

One engine per tier. Fixed-slot design: ``max_batch`` decode slots share a
KV cache (per-slot write indices); finished slots are freed and refilled
(continuous batching). The cache is either dense, one ``(L, B, T, K, hd)``
row per slot, or paged: a shared ``(L, P, page, K, hd)`` pool with a page
table per slot (``ServingConfig(paged=True)``, the launcher default).

* **Fused decode**: ``fused_steps`` decode steps per host call. Greedy or
  temperature sampling, the per-slot alive flags (EOS, token budget,
  capacity) and the freeze of dead slots' bookkeeping all stay on the
  device; the KV writes land in place in the preallocated cache. The host
  receives one ``(B, fused_steps)`` token block, one sync per K tokens.
  Attention reads a context-bucket view (``_context_bucket``) just covering
  the longest live context. The families whose cache writes by absolute
  position run each step in place over static block state; on the card
  that step is one CUDA graph per context bucket, replayed K times.
* **Bucketed prefill**: waiting prompts are right-padded to power-of-two
  length buckets; all same-bucket requests prefill in ONE batched call and
  scatter into their slots (through the page tables on a paged engine).
  Families whose cache embeds recurrent or ring state (ssm, hybrid) batch
  exact same-length groups instead, keep dense per-slot state on a paged
  engine (charged a flat number of pages a slot), freeze a dead slot's
  whole row inside the fused block, park and store only whole processed
  sequences, and replay a warm suffix or a speculative commit with
  ``decode_chunk_recurrent``. ``moe`` prefills one request a group (a
  capacity-dropping MoE routes over the flattened batch, so batching would
  couple which tokens drop across requests). ``encdec`` pads buckets like
  ``dense`` (frames travel in ``extras``), keeps its self and cross caches
  dense on a paged engine under the flat page charge, steps a warm suffix
  token by token, and has no speculative decoding (no chunked decode).
* **Warm admission**: a prompt extending a parked session
  (``submit(session=...)``) or a stored prefix (``prefix_cache_mb > 0``)
  reuses the cached rows and prefills only its suffix, in one
  ``decode_chunk`` pass. On a paged engine a prefix-store entry is a list of
  page ids (increfs, no copy), and a hit maps the full pages behind the
  reused frontier copy-on-write into the new slot's table.
* **Migration**: ``extract_slot`` packs one request's cache rows, its
  ``SeqState`` and its sampling key into a :class:`SlotPayload`, whose
  versioned wire format (``to_bytes``/``from_bytes``) is byte-compatible
  with the JAX package's; ``inject_slot`` resumes it in a free slot of a
  compatible engine, paged or dense, without a prefill.

* **Speculative decoding**: ``spec_*`` is the target's verify protocol
  (one ``decode_chunk`` over a drafted block, then a rewind to the
  committed frontier) and the draft's shadow slot, co-driven by the
  cluster runtime; the committed stream is the target-only stream.

``ServingConfig(fused_steps=1)`` keeps the per-token path (one sync per
token, one prefill per request) for parity testing.

Sampling at temperature > 0 draws each slot's token from that slot's key
alone: Gumbel-max with noise from a counter-based hash of (key, rid,
absolute position, vocab index). The draw needs no state that advances, so
the fused and per-token paths, and a request before and after a
migration, draw the same tokens. It is not the JAX package's threefry
stream.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import re
import struct
import time
import weakref
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.config import ModelConfig, ServingConfig
from repro_torch.kernels import ops
from repro_torch.serving.paged import PagePool, pages_needed
from repro_torch.serving.prefix import (ParkedSession, PrefixStore,
                                        SessionStore, extension_suffix,
                                        extras_fingerprint, prefix_buckets)


# Families whose decode cache is a full-capacity absolute-position buffer:
# right-padded bucket prefill is exact for them (pad entries are masked via
# the ``pos`` leaf). ssm/hybrid carry recurrent/ring state that pads would
# shift: they batch exact same-length groups instead. moe prefills per
# request: a capacity-dropping MoE impl routes over the flattened batch, so
# ANY cross-request batching (padded or not) would couple which tokens drop
# across requests.
_PADDED_FAMILIES = ("dense", "vlm", "encdec")


#: device memory a prefill group's budget leaves free for everything else
#: on the card: captured decode graphs, library workspaces, fragmentation
PREFILL_RESERVE = 4 << 30


def prefill_bytes_per_position(cfg: ModelConfig) -> int:
    """Bytes a prefill holds for one position (row x length) of its group,
    counted high: the residual stream, the attention's and the MLP's live
    tensors in the model dtype, the f32 norm and RoPE temporaries, the
    layer's K/V and its page-padded copy, and the f32 vision patches."""
    elt = 4 if cfg.dtype == "float32" else 2
    d, ff = cfg.d_model, cfg.d_ff
    q = cfg.num_heads * cfg.resolved_head_dim
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    patches = 4 * cfg.frontend_dim if cfg.frontend == "vision_stub" else 0
    return elt * (4 * d + 4 * ff + 2 * q + 4 * kv) + 16 * d + 12 * q + patches


def _next_bucket(n: int, lo: int = 16) -> int:
    """Smallest power-of-two >= n (floored at ``lo`` to bound trace count)."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class SeqState:
    rid: int
    prompt_len: int
    generated: List[int] = field(default_factory=list)
    max_new: int = 32
    done: bool = False
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    # multi-turn session id: when set, the slot's state is parked into the
    # engine's session store at finish so the next turn resumes it
    session: Optional[str] = None


# ---------------------------------------------------------------------------
# cross-tier KV migration: per-slot cache wire format
# ---------------------------------------------------------------------------

#: bump when the on-wire layout changes; injectors reject other versions
#: v2: CRC32 on the header blob and on every raw buffer (key + each leaf)
#: so byte corruption anywhere on the wire deterministically raises
#: MigrationError instead of silently injecting garbage KV
MIGRATION_WIRE_VERSION = 2
_WIRE_MAGIC = b"MOAKV"
_WIRE_HDR = struct.Struct("<HII")  # (version, header len, header crc32)

#: numpy's (and the JAX package's) spelling of each cache dtype: the wire
#: tags and the engine's row specs use it, never ``str(torch.dtype)``
_DTYPE_TAGS = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.int32: "int32"}


class MigrationError(RuntimeError):
    """A slot payload cannot be extracted or injected: unknown wire version,
    wrong model/family, mismatched cache geometry, or no free slot. Raised
    BEFORE any engine state is mutated, so a failed injection leaves the
    target engine untouched (callers fall back to a fresh prefill)."""


def dtype_tag(x) -> str:
    """The numpy spelling of a leaf's dtype (a tensor or an array)."""
    if isinstance(x, torch.Tensor):
        return _DTYPE_TAGS.get(x.dtype) or str(x.dtype)
    return str(x.dtype)


def _leaf_bytes(x) -> bytes:
    """A leaf's raw bytes in C order; bf16 travels as its 2-byte pattern."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _np_dtype(name: str) -> np.dtype:
    """Resolve a numpy dtype tag. An unknown tag (corrupt header, sender
    with newer dtypes) raises MigrationError so callers keep their
    re-prefill fallback."""
    try:
        return np.dtype(name)
    except TypeError as e:
        raise MigrationError(
            f"unknown dtype tag {name!r} in slot payload") from e


def _as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A row as a tensor of ``dtype`` on ``device``; may share memory with
    ``x``."""
    return torch.as_tensor(x).to(device=device, dtype=dtype)


@dataclass
class SlotPayload:
    """One request's migratable state: its per-slot cache rows (every leaf
    sliced along that leaf's logical batch axis), its ``SeqState``, the
    absolute next position, and the per-slot sampling key. ``to_bytes``/
    ``from_bytes`` are the versioned, dtype/shape-tagged wire format the
    live backend ships across tiers, byte for byte the JAX package's.

    Extracted rows are tensors on the donor's device until ``to_bytes``;
    parsed rows are CPU tensors (bf16 included: no ``ml_dtypes``)."""

    version: int
    model: str
    family: str
    max_seq: int
    seq: SeqState
    position: int
    key: np.ndarray  # per-slot sampling key, uint32[2]
    leaves: Dict[str, Any]  # keystr(cache path) -> per-slot row
    # prompt token ids (session park/resume needs to know exactly which
    # tokens the cache rows cover); absent on wires from older senders
    prompt_tokens: Optional[np.ndarray] = None
    # fingerprint of the prefill extras (vision patches) occupying cache
    # positions — a resume must present identical extras to reuse the rows
    extras_fp: bytes = b""
    _wire: Optional[bytes] = field(default=None, repr=False, compare=False)

    @property
    def nbytes(self) -> int:
        """Exact on-wire size (serialized lazily, cached)."""
        return len(self.to_bytes())

    def to_bytes(self) -> bytes:
        if self._wire is not None:
            return self._wire
        seq = self.seq
        names = sorted(self.leaves)
        key_bytes = np.ascontiguousarray(self.key).tobytes()
        leaf_bytes = [_leaf_bytes(self.leaves[n]) for n in names]
        head = {
            "version": self.version,
            "model": self.model,
            "family": self.family,
            "max_seq": self.max_seq,
            "position": self.position,
            "seq": {
                "rid": seq.rid, "prompt_len": seq.prompt_len,
                "generated": list(seq.generated), "max_new": seq.max_new,
                "done": seq.done, "t_submit": seq.t_submit,
                "t_first_token": seq.t_first_token, "t_done": seq.t_done,
                "session": seq.session,
            },
            "prompt_tokens": (None if self.prompt_tokens is None
                              else [int(t) for t in self.prompt_tokens]),
            "extras_fp": self.extras_fp.hex(),
            "key": {"dtype": str(self.key.dtype),
                    "shape": list(self.key.shape),
                    "crc": zlib.crc32(key_bytes)},
            "leaves": [{"name": n, "dtype": dtype_tag(self.leaves[n]),
                        "shape": list(self.leaves[n].shape),
                        "crc": zlib.crc32(raw)}
                       for n, raw in zip(names, leaf_bytes)],
        }
        blob = json.dumps(head).encode("utf-8")
        parts = [_WIRE_MAGIC,
                 _WIRE_HDR.pack(self.version, len(blob), zlib.crc32(blob)),
                 blob, key_bytes]
        parts += leaf_bytes
        self._wire = b"".join(parts)
        return self._wire

    @classmethod
    def from_bytes(cls, wire: bytes) -> "SlotPayload":
        m = len(_WIRE_MAGIC)
        if wire[:m] != _WIRE_MAGIC:
            raise MigrationError("not a slot payload (bad magic)")
        if len(wire) < m + _WIRE_HDR.size:
            raise MigrationError("truncated slot payload")
        version, hlen, hcrc = _WIRE_HDR.unpack_from(wire, m)
        if version != MIGRATION_WIRE_VERSION:
            raise MigrationError(
                f"wire format version {version} != supported "
                f"{MIGRATION_WIRE_VERSION}")
        off = m + _WIRE_HDR.size
        if off + hlen > len(wire):
            raise MigrationError("truncated slot payload header")
        blob = wire[off:off + hlen]
        # the header checksum gates json parsing: corrupt bytes raise here,
        # deterministically, before anything is interpreted
        if zlib.crc32(blob) != hcrc:
            raise MigrationError("slot payload header checksum mismatch")

        def pull(dtype_s: str, shape, crc) -> np.ndarray:
            nonlocal off
            # bf16 arrives as its bit pattern, read as int16
            dt = _np_dtype("int16" if dtype_s == "bfloat16" else dtype_s)
            if any(int(d) < 0 for d in shape):
                raise MigrationError(f"corrupt leaf shape {shape}")
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            end = off + n * dt.itemsize
            if end > len(wire):
                raise MigrationError("truncated slot payload")
            raw = wire[off:end]
            if crc is not None and zlib.crc32(raw) != crc:
                raise MigrationError("slot payload buffer checksum mismatch")
            arr = np.frombuffer(raw, dtype=dt).reshape(shape).copy()
            off = end
            return arr

        def leaf(d) -> torch.Tensor:
            t = torch.from_numpy(pull(d["dtype"], d["shape"], d.get("crc")))
            return t.view(torch.bfloat16) if d["dtype"] == "bfloat16" else t

        # any malformation beyond this point (bad json, missing header
        # fields, bogus shapes) is a corrupt wire, never a crash: callers
        # rely on MigrationError to fall back to a fresh prefill
        try:
            head = json.loads(blob.decode("utf-8"))
            off += hlen
            key = pull(head["key"]["dtype"], head["key"]["shape"],
                       head["key"].get("crc"))
            leaves = {d["name"]: leaf(d) for d in head["leaves"]}
            s = head["seq"]
            seq = SeqState(rid=s["rid"], prompt_len=s["prompt_len"],
                           generated=list(s["generated"]),
                           max_new=s["max_new"], done=s["done"],
                           t_submit=s["t_submit"],
                           t_first_token=s["t_first_token"],
                           t_done=s["t_done"],
                           session=s.get("session"))
            pt = head.get("prompt_tokens")
            return cls(version=version, model=head["model"],
                       family=head["family"], max_seq=head["max_seq"],
                       seq=seq, position=head["position"], key=key,
                       leaves=leaves,
                       prompt_tokens=(None if pt is None
                                      else np.asarray(pt, np.int32)),
                       extras_fp=bytes.fromhex(head.get("extras_fp", "")),
                       _wire=bytes(wire))
        except MigrationError:
            raise
        except (KeyError, ValueError, TypeError, OverflowError,
                RuntimeError) as e:
            raise MigrationError(f"corrupt slot payload: {e!r}") from e


# bookkeeping leaves: per slot, never paged, never stored as prefix rows
_BOOKKEEPING = ("['pos']", "['index']")


def _named_leaves(tree: Dict[str, Any], prefix: str = ""):
    """(keystr, leaf) pairs in the JAX package's flattening order (sorted
    keys), named as ``jax.tree_util.keystr`` names them."""
    for k in sorted(tree):
        name = f"{prefix}['{k}']"
        if isinstance(tree[k], dict):
            yield from _named_leaves(tree[k], name)
        else:
            yield name, tree[k]


def _path(name: str) -> List[str]:
    return re.findall(r"\['([^']*)'\]", name)


def _get(tree: Dict[str, Any], name: str):
    for k in _path(name):
        tree = tree[k]
    return tree


def _put(tree: Dict[str, Any], name: str, value) -> None:
    *head, last = _path(name)
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _at(bax: int, index) -> tuple:
    """Index tuple selecting ``index`` along axis ``bax``."""
    return (slice(None),) * bax + (index,)


def _tree_map(fn: Callable, tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


# -- per-slot keyed sampling -------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32), in halves so no
    product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply, two rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keyed_sample(logits: torch.Tensor, keys: torch.Tensor,
                 rids: torch.Tensor, positions: torch.Tensor,
                 temp: float) -> torch.Tensor:
    """One token per row of ``logits`` (B, V) at temperature ``temp``:
    Gumbel-max, the noise a hash of (the row's key (B, 2), its request id,
    the absolute position of the token whose logits these are, the vocab
    index). Integer arithmetic in int64, so the noise is the same on every
    device. Returns (B,) int64."""
    dev = logits.device
    keys = keys.to(device=dev, dtype=torch.int64)
    row = _mix32(positions.to(device=dev, dtype=torch.int64) & _M32)
    row = _mix32(row ^ (rids.to(device=dev, dtype=torch.int64) & _M32))
    row = _mix32(row ^ keys[:, 1])
    row = _mix32(row ^ keys[:, 0])
    vocab = _mix32(torch.arange(logits.shape[-1], device=dev,
                                dtype=torch.int64) + 0x9E3779B9 & _M32)
    h = _mix32(row[:, None] ^ vocab[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temp + gumbel, dim=-1)


def _slot_keys(seed: int, n: int) -> np.ndarray:
    """``n`` per-slot sampling keys, uint32[2] each (the shape and dtype of
    the JAX package's ``jax.random`` key data)."""
    return np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, 2), dtype=np.uint32)


def _weak_hook(method: Callable) -> Callable:
    """``method`` (a bound method) called through a weak reference to its
    object: whatever holds the hook does not keep the object alive. A
    call after the object is gone does nothing."""
    ref = weakref.WeakMethod(method)

    def hook(*args):
        fn = ref()
        if fn is not None:
            fn(*args)
    return hook


class _BlockState:
    """A fused block's inputs and loop state on the device, made once an
    engine and outside any graph pool: a captured step reads and writes
    these addresses. The inputs arrive from host staging (pinned on the
    card) in one copy each: ``vec`` holds the rows token, position and
    budget (int32), ``key_vec`` (at temperature > 0) the columns of a
    slot's key pair and its request id (int64). ``lens`` is each step's
    attended extent a slot (0 for a dead one), which a paged pool's decode
    reads."""

    def __init__(self, b: int, device: torch.device, keyed: bool):
        pin = device.type == "cuda"
        self.host = torch.empty((3, b), dtype=torch.int32, pin_memory=pin)
        self.host_np = self.host.numpy()
        self.vec = torch.empty((3, b), dtype=torch.int32, device=device)
        self.tok, self.pos, self.budget = self.vec.unbind(0)
        self.alive = torch.empty((b,), dtype=torch.bool, device=device)
        self.produced = torch.empty((b,), dtype=torch.int32, device=device)
        self.lens = torch.zeros((b,), dtype=torch.int32, device=device)
        self.bi = torch.arange(b, device=device)
        if keyed:
            self.key_host = torch.empty((b, 3), dtype=torch.int64,
                                        pin_memory=pin)
            self.key_host_np = self.key_host.numpy()
            self.key_vec = torch.empty((b, 3), dtype=torch.int64,
                                       device=device)
            self.keys, self.rids = self.key_vec[:, :2], self.key_vec[:, 2]


#: the side stream of each device on which every engine captures its
#: graphs and runs a bucket's eager first step. One a device: each stream
#: that runs a cuBLAS call keeps a workspace of its own for the process's
#: life
_CAPTURE_STREAMS: Dict[int, Any] = {}


def _capture_stream(device: torch.device):
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


@contextlib.contextmanager
def _on_stream(stream):
    """Work issued inside runs on ``stream``, after what the current
    stream issued before and before what it issues after."""
    prev = torch.cuda.current_stream(stream.device)
    stream.wait_stream(prev)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        prev.wait_stream(stream)


class TierEngine:
    def __init__(self, model, params, serving: ServingConfig = ServingConfig(),
                 eos_id: int = 2, sample_temp: float = 0.0, seed: int = 0):
        # shallow copy: the engine sets per-engine decode flags below and
        # must not leak them into a model object shared with other engines
        model = copy.copy(model)
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.device: torch.device = model.device
        self.params = params
        self.serving = serving
        self.eos_id = eos_id
        self.temp = sample_temp
        # the tier this engine serves, as its server names it (on spans)
        self.tier = ""
        self.fused_steps = max(1, serving.fused_steps)
        if serving.decode_impl != "auto":
            model.decode_impl = serving.decode_impl

        b, t = serving.max_batch, serving.max_seq
        # prefixes of admitted prompts are positionally addressable
        # (sliceable at any boundary) only for the full-capacity
        # absolute-position families; ssm/hybrid state is a point-in-time
        # snapshot, so only whole processed sequences park
        self._sliceable = self.cfg.family in ("dense", "vlm", "moe")
        # on a paged engine of those families the pool below replaces the
        # dense K/V: its dense cache is shapes only, never allocated
        kv_pages = serving.paged and self._sliceable
        self.cache = model.init_cache(b, t,
                                      device="meta" if kv_pages else None)
        self.slots: List[Optional[SeqState]] = [None] * b
        self.positions = np.zeros((b,), np.int64)  # absolute next position
        self.waiting: List[Dict[str, Any]] = []
        self.finished: List[SeqState] = []
        self.journal: List[tuple] = []  # (op, payload) event journal
        self.healthy = True
        # chaos knob: a slow-node fault window sets this > 1 and each step
        # sleeps (throttle-1)x its own duration, capped per step
        self.throttle = 1.0
        self.throttle_sleep_cap_s = 0.5
        self.last_heartbeat = time.monotonic()
        self.steps = 0
        # perf counters (read by the launcher and the runtime)
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.encode_tokens = 0
        # prefix & session KV reuse counters: tokens whose prefill was
        # SKIPPED because their cache rows came from the prefix store / a
        # parked session (prefill_tokens counts only suffixes)
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.resumed_sessions = 0
        self.resumed_tokens = 0
        self.parks = 0
        # speculation counters
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.spec_rounds = 0
        # cluster-runtime hooks: admission + per-token streaming callbacks
        # (rid, t) and (rid, token, t); warm admission (rid, kind, cached,
        # suffix) with kind in {"prefix", "resume"}; session park (rid, sid)
        self.on_admit: Optional[Callable[[int, float], None]] = None
        self.on_token: Optional[Callable[[int, int, float], None]] = None
        self.on_warm: Optional[Callable[[int, str, int, int], None]] = None
        self.on_park: Optional[Callable[[int, str], None]] = None
        # per-slot sampling keys (host; they travel with a migrated slot)
        self._keys = _slot_keys(seed, b)

        # per-leaf (batch axis, seq axis or -1), by the JAX package's names
        axes = dict(_named_leaves(model.cache_axes(b, t)))
        self._axis_by_name = {
            name: (ax.index("batch"), ax.index("seq") if "seq" in ax else -1)
            for name, ax in axes.items()}
        # dense per-slot row geometry (name -> (shape, dtype tag)) for
        # payload validation, and the dense leaf specs warm admission builds
        # its batch-1 cache from: paged and dense engines share both, so
        # they speak the same migration wire format
        self._dense_specs: Dict[str, tuple] = {}
        self._row_specs: Dict[str, tuple] = {}
        for name, leaf in _named_leaves(self.cache):
            bax = self._axis_by_name[name][0]
            shape = tuple(leaf.shape)
            self._dense_specs[name] = (shape, leaf.dtype)
            self._row_specs[name] = (shape[:bax] + shape[bax + 1:],
                                     dtype_tag(leaf))
        self.prefix_store = PrefixStore(serving.prefix_cache_mb * 1e6,
                                        min_prefix=serving.prefix_min_tokens)
        self.sessions = SessionStore(serving.session_cache_mb * 1e6)
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * b
        self._slot_extras_fp: List[bytes] = [b""] * b

        # -- paged KV pool: the big KV leaves move into a shared physical
        # pool ((L, P, page, K, hd) + an int32 page table per slot), with
        # copy-free CoW prefix sharing; the recurrent families keep
        # exact-length dense state but share the pool ACCOUNTING, so
        # cross-family tiers report comparable headroom
        self.pool: Optional[PagePool] = None
        self._paged_names: tuple = ()
        self._pt: Optional[np.ndarray] = None  # host page tables (B, n_pt)
        self._slot_pages: List[List[int]] = [[] for _ in range(b)]
        self._page_pressure = False  # set when admission starved for pages
        # admissions that waited at the head of the queue for free pages,
        # and the seconds they waited
        self.page_waits = 0
        self.page_wait_s = 0.0
        # positions (rows x length) a prefill group may carry: None = read
        # from the device's free memory at the first group, 0 = unbounded
        self.prefill_positions: Optional[int] = None
        self._slot_page_charge = 1  # accounting charge (recurrent families)
        self._n_pt = 0
        self._slots_hw = 0  # dense-mode occupied-slot high-water (gauges)
        if serving.paged and not self._sliceable:
            # per-slot state is point-in-time (no positional pages): charge
            # each slot the pages its largest time-axis leaf would occupy,
            # so admission answers to the same pool
            max_rows = 0
            slot_bytes = 0.0
            for name, leaf, bax in self._leaf_rows():
                slot_bytes += leaf.nbytes / leaf.shape[bax]
                sax = self._axis_by_name[name][1]
                if sax >= 0 and name not in _BOOKKEEPING:
                    max_rows = max(max_rows, leaf.shape[sax])
            self._slot_page_charge = max(
                1, pages_needed(max_rows, serving.kv_page_size, t))
            self.pool = PagePool(serving.pool_pages, serving.kv_page_size,
                                 page_bytes=slot_bytes / self._slot_page_charge)
        elif serving.paged:
            ps = serving.kv_page_size
            self._n_pt = serving.pages_per_slot
            npages = serving.pool_pages + 1  # + pinned null page 0
            page_bytes = 0.0
            paged = []
            for name, leaf in _named_leaves(self.cache):
                bax, sax = self._axis_by_name[name]
                if (name not in _BOOKKEEPING and sax == bax + 1
                        and leaf.shape[sax] == t):
                    paged.append(name)
                    page_bytes += (leaf.numel() // (leaf.shape[bax] * t)
                                   * leaf.element_size()) * ps
                    shape = (tuple(leaf.shape[:bax]) + (npages, ps)
                             + tuple(leaf.shape[bax + 2:]))
                    _put(self.cache, name, torch.zeros(
                        shape, dtype=leaf.dtype, device=self.device))
                else:  # pos (-1: an empty entry) and the write index
                    _put(self.cache, name, torch.full(
                        tuple(leaf.shape), -1 if name == "['pos']" else 0,
                        dtype=leaf.dtype, device=self.device))
            self._paged_names = tuple(sorted(paged))
            self.cache["pages"] = torch.zeros((b, self._n_pt),
                                              dtype=torch.int32,
                                              device=self.device)
            self._pt = np.zeros((b, self._n_pt), np.int32)
            self.pool = PagePool(serving.pool_pages, ps, page_bytes=page_bytes)
            # dropping a store reference and freeing its physical pages must
            # never diverge: EVERY store removal (LRU eviction, overwrite,
            # explicit pop) decrefs through this hook
            # through a weak reference: the store must not keep its engine
            # (weights, caches) alive in a reference cycle
            self.prefix_store.lru.on_evict = _weak_hook(self._on_prefix_evict)
        # a recurrent family's warm suffix and speculative commits replay in
        # one decode_chunk_recurrent pass (else token by token)
        self._warm_chunk_recurrent = (serving.chunked_recurrent_suffix
                                      and self.cfg.family in ("ssm", "hybrid"))
        # context buckets need linear cache placement (pos == write index),
        # which holds for the full-capacity-pos families only: ring windows
        # (hybrid) and recurrent state (ssm) keep full-width attention
        self._ctx_buckets = (serving.context_buckets
                             and self.cfg.family in ("dense", "vlm", "moe"))
        # the fused block's steps as CUDA graphs (``_fused_static``) on the
        # card; the recurrent families' block stays eager
        self._graph_ok = self.device.type == "cuda"
        self._g: Optional[_BlockState] = None
        self._graphs: Dict[Optional[int], tuple] = {}  # ctx -> (graph,
        # the launches a replay makes)
        self._graph_seen: set = set()  # buckets whose first step ran eagerly
        self._graph_key: Optional[tuple] = None  # storage the graphs read
        self._graph_pool = None
        self.decode_graph_steps = 0  # fused steps replayed from a graph
        self.decode_eager_steps = 0  # fused steps issued op by op
        self.decode_graph_captures = 0
        # the fused blocks' attended rows: the live slots' (position + 1 a
        # step) and the grid's (B x the context bucket a step)
        self.decode_rows_live = 0
        self.decode_rows_grid = 0

    # ------------------------------------------------------------------
    # hot-path blocks
    # ------------------------------------------------------------------

    def _fused(self, tokens: np.ndarray, positions: np.ndarray,
               budgets: np.ndarray, teff: int, k_steps: int,
               rids: np.ndarray) -> np.ndarray:
        """``k_steps`` decode steps: decode -> on-device sample -> per-slot
        EOS/budget/cap masking, the cache updated in place. Returns the
        (B, k_steps) token block; the only host sync is its copy.

        ``teff`` is the context bucket: attention reads only the leading
        ``teff`` cache entries (a view; writes and bookkeeping stay full
        width). Valid because placement is linear, every admit rewrites a
        slot's full row (entries past a prompt carry pos=-1), and the
        engine picks ``teff`` above the longest position the block
        reaches."""
        sp = tracing.begin("engine.decode_block", tier=self.tier)
        if sp:
            slots = [(int(rids[i]), int(positions[i]), int(budgets[i]))
                     for i in np.flatnonzero(np.asarray(budgets) > 0)]
            pool = ({} if self.pool is None else
                    {"pages_used": self.pool.pages_used,
                     "pool_pages": self.pool.num_pages})
        issue = tracing.begin("engine.decode.issue", tier=self.tier)
        ctx = teff if teff < int(self.serving.max_seq) else None
        if self.cfg.family in ("ssm", "hybrid"):
            block = self._fused_recurrent(tokens, positions, budgets, ctx,
                                          k_steps, rids)
            graphed = 0
        else:
            block, graphed = self._fused_static(tokens, positions, budgets,
                                                ctx, k_steps, rids)
        tracing.end(issue)
        sync = tracing.begin("engine.decode.sync", tier=self.tier)
        block = block.cpu().numpy()
        tracing.end(sync)
        rows_live = self._rows_live(positions, budgets, k_steps, block)
        rows_grid = len(positions) * teff * k_steps
        self.decode_rows_live += rows_live
        self.decode_rows_grid += rows_grid
        if sp:
            tracing.end(sp, k=k_steps, teff=teff, slots=slots,
                        graph=graphed == k_steps, rows_live=rows_live,
                        rows_grid=rows_grid, **pool)
        return block

    def _rows_live(self, positions: np.ndarray, budgets: np.ndarray,
                   k_steps: int, block: np.ndarray) -> int:
        """The rows a fused block's live slots attend: position + 1 at each
        step a slot lives (its budget, the capacity, an EOS token in the
        block end it, as the step's stop rules do)."""
        p = np.asarray(positions, np.int64)
        live = np.asarray(budgets, np.int64)
        n = np.minimum(np.minimum(live, k_steps),
                       int(self.serving.max_seq) - 1 - p)
        eos = block == self.eos_id
        first_eos = np.where(eos.any(axis=1), eos.argmax(axis=1) + 1, k_steps)
        n = np.where(live > 0, np.maximum(np.minimum(n, first_eos), 1), 0)
        return int((n * (p + 1) + n * (n - 1) // 2).sum())

    def _fused_recurrent(self, tokens, positions, budgets, ctx, k_steps,
                         rids) -> torch.Tensor:
        """The fused block of the ssm/hybrid families, eager. They carry
        recurrent state (and a ring whose write index wraps onto LIVE
        entries): a dead slot's decode would keep mutating it, corrupting
        the rows session parking extracts at finish, so each step restores
        a dead slot's whole row from a copy taken before it."""
        model, params, cache = self.model, self.params, self.cache
        max_seq = int(self.serving.max_seq)
        dev = self.device
        tok = torch.as_tensor(tokens, device=dev)
        pos = torch.as_tensor(positions, device=dev)
        budgets_d = torch.as_tensor(budgets, device=dev)
        if self.temp > 0:
            keys_d = torch.as_tensor(self._keys.astype(np.int64), device=dev)
            rids_d = torch.as_tensor(rids, device=dev)
        alive = budgets_d > 0
        produced = torch.zeros_like(budgets_d)
        out = []
        for _ in range(k_steps):
            before = [(name, leaf.clone())
                      for name, leaf in _named_leaves(cache)]
            logits, cache = model.decode_step(
                params, cache, {"tokens": tok[:, None], "positions": pos},
                ctx=ctx)
            if self.temp > 0:
                sampled = keyed_sample(logits, keys_d, rids_d, pos, self.temp)
            else:
                sampled = torch.argmax(logits, dim=-1)
            sampled = sampled.to(torch.int32)
            produced = produced + alive.to(torch.int32)
            pos2 = torch.where(alive, pos + 1, pos)
            # same stop rules the host applies per appended token
            alive2 = (alive & (sampled != self.eos_id) & (produced < budgets_d)
                      & (pos2 + 1 < max_seq))
            tok2 = torch.where(alive, sampled, tok)
            for name, old in before:
                leaf = _get(cache, name)  # index is a new tensor
                shape = [1] * leaf.dim()
                shape[self._axis_by_name[name][0]] = alive.shape[0]
                torch.where(alive.reshape(shape), leaf, old, out=leaf)
            tok, pos, alive = tok2, pos2, alive2
            out.append(tok2)
        self.cache = cache
        self.decode_eager_steps += k_steps
        return torch.stack(out, dim=1)

    def _fused_static(self, tokens, positions, budgets, ctx, k_steps,
                      rids) -> tuple:
        """The fused block of the families whose cache writes by absolute
        position: the block's inputs go once into the engine's static state
        (:class:`_BlockState`), then ``k_steps`` times :meth:`_static_step`,
        each step's token copied into column j of the block. On the card a
        step is a CUDA graph per context bucket, captured at the bucket's
        second use (the first runs eagerly, as the capture's warm-up) and
        dropped whenever the storage the step reads changes
        (:meth:`_graph_storage`). Returns the (B, k_steps) device block and
        the number of steps replayed."""
        g = self._block_state()
        g.host_np[0] = tokens
        g.host_np[1] = positions
        g.host_np[2] = budgets
        g.vec.copy_(g.host, non_blocking=True)
        if self.temp > 0:
            g.key_host_np[:, :2] = self._keys
            g.key_host_np[:, 2] = rids
            g.key_vec.copy_(g.key_host, non_blocking=True)
        torch.gt(g.budget, 0, out=g.alive)
        g.produced.zero_()
        if self._graph_ok:
            storage = self._graph_storage()
            if storage != self._graph_key:
                self._graphs.clear()
                self._graph_seen.clear()
                self._graph_pool = None
                self._graph_key = storage
        out = torch.empty((g.tok.shape[0], k_steps), dtype=torch.int32,
                          device=self.device)
        graphed = 0
        for j in range(k_steps):
            if not self._graph_ok:
                self._static_step(ctx)
            else:
                graph = self._graphs.get(ctx)
                if graph is None and ctx in self._graph_seen:
                    graph = self._graphs[ctx] = self._capture(ctx)
                if graph is None:
                    with self._side_stream():
                        self._static_step(ctx)
                    self._graph_seen.add(ctx)
                else:
                    graph[0].replay()
                    ops.add_launches(graph[1])
                    graphed += 1
            out[:, j].copy_(g.tok)
        self.decode_graph_steps += graphed
        self.decode_eager_steps += k_steps - graphed
        return out, graphed

    def _block_state(self) -> "_BlockState":
        if self._g is None:
            self._g = _BlockState(len(self.slots), self.device, self.temp > 0)
        return self._g

    def _static_step(self, ctx: Optional[int]) -> None:
        """One decode step over the static block state and the engine's
        cache, every result written in place (the step a graph captures):
        decode -> on-device sample -> the per-slot EOS/budget/cap masking
        and the freeze of dead slots' write bookkeeping (their KV writes
        land on an entry whose pos stays -1, which reads mask out, instead
        of marching the write index over live-looking entries)."""
        g, cache = self._g, self.cache
        max_seq = int(self.serving.max_seq)
        idx0 = cache["index"].clone()
        old_pos = cache["pos"][g.bi, idx0.long()]
        # decode_step rebinds "index" in the dict it is given: a shallow
        # copy keeps self.cache on the engine's own tensor
        step_cache = dict(cache)
        if "pages" in cache:
            # a paged pool's decode reads only the rows each slot attends: a
            # live slot its rows up to this token's (linear placement), a
            # dead one none
            torch.mul(idx0 + 1, g.alive, out=g.lens)
            if ctx is not None:
                g.lens.clamp_(max=ctx)
            step_cache["lens"] = g.lens
        logits, stepped = self.model.decode_step(
            self.params, step_cache,
            {"tokens": g.tok[:, None], "positions": g.pos}, ctx=ctx)
        if self.temp > 0:
            sampled = keyed_sample(logits, g.keys, g.rids, g.pos, self.temp)
        else:
            sampled = torch.argmax(logits, dim=-1)
        sampled = sampled.to(torch.int32)
        alive = g.alive
        produced = g.produced + alive.to(torch.int32)
        pos2 = torch.where(alive, g.pos + 1, g.pos)
        # same stop rules the host applies per appended token
        alive2 = (alive & (sampled != self.eos_id) & (produced < g.budget)
                  & (pos2 + 1 < max_seq))
        tok2 = torch.where(alive, sampled, g.tok)
        new_pos = cache["pos"][g.bi, idx0.long()]
        cache["pos"][g.bi, idx0.long()] = torch.where(alive, new_pos, old_pos)
        cache["index"].copy_(torch.where(alive, stepped["index"], idx0))
        g.tok.copy_(tok2)
        g.pos.copy_(pos2)
        g.alive.copy_(alive2)
        g.produced.copy_(produced)

    def _graph_storage(self) -> tuple:
        """The storage a captured step reads by address: every cache leaf,
        every parameter and the f32 unembedding table, each with its
        layout. ``restore()`` or a new parameter tree changes it."""
        leaves = [t for _, t in _named_leaves(self.cache)]
        leaves += [t for _, t in _named_leaves(self.params)]
        leaves.append(self.model.unembed_table_f32(self.params))
        return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                     for t in leaves)

    def _side_stream(self):
        """A context on the device's capture stream, ordered after the
        current stream's work and before what the current stream does
        next. A bucket's eager first step runs there too, so the libraries'
        per-stream workspaces exist before the capture."""
        return _on_stream(_capture_stream(self.device))

    def _capture(self, ctx: Optional[int]) -> tuple:
        """(a CUDA graph of one :meth:`_static_step` at ``ctx``, the kernel
        launches a replay makes). The engine's graphs share one pool: each
        replay writes its results into the static state and the cache, and
        no graph reads what another left in the pool."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with self._side_stream():
            graph.capture_begin(pool=self._graph_pool,
                                capture_error_mode="thread_local")
            try:
                self._static_step(ctx)
            finally:
                graph.capture_end()
        self.decode_graph_captures += 1
        return graph, ops.take_launches_since(before)

    def _prefill_insert(self, batch: Dict[str, torch.Tensor],
                        slots: np.ndarray, total: np.ndarray,
                        pt_rows: Optional[np.ndarray] = None,
                        npg: int = 0) -> torch.Tensor:
        """Batched prefill + multi-row scatter into the slot pool.

        ``slots`` (R,) are the destination slot ids (duplicates only for pad
        rows carrying identical values); ``total`` (R,) is each row's true
        sequence length INCLUDING any vision prefix. A paged engine passes
        ``pt_rows`` (R, n_pt): each layer's K/V goes THROUGH the tables
        into the pool as the layer computes it (``DecoderLM.prefill_paged``;
        only the leading ``npg`` pages, the group's reserved high-water; a
        row's unreserved tail maps to the null page, whose garbage is
        masked via ``pos``). The dense pool and the families without
        positional pages (ssm, hybrid, encdec) scatter the capacity-wide
        cache ``prefill`` builds."""
        dev = self.device
        slots_d = torch.as_tensor(slots, device=dev).long()
        if pt_rows is not None:
            return self._prefill_pages(batch, slots_d, total, pt_rows, npg)
        logits, cache1 = self.model.prefill(self.params, batch,
                                            self.serving.max_seq)
        if self.cfg.family in _PADDED_FAMILIES:
            total_d = torch.as_tensor(total, device=dev)
            cap = cache1["pos"].shape[1]
            # pad entries carry absolute positions >= the row's true length
            # -> mark empty; the next write lands at the true end
            cache1["pos"] = torch.where(cache1["pos"] < total_d[:, None],
                                        cache1["pos"], -1)
            cache1["index"] = (torch.clamp(total_d, max=cap) % cap).to(
                torch.int32)
        c = self.cache
        for name, one in _named_leaves(cache1):
            pool = _get(c, name)
            pool[_at(self._axis_by_name[name][0], slots_d)] = one.to(
                pool.dtype)
        return logits

    def _prefill_pages(self, batch: Dict[str, torch.Tensor],
                       slots_d: torch.Tensor, total: np.ndarray,
                       pt_rows: np.ndarray, npg: int) -> torch.Tensor:
        """The paged pool's prefill: K/V written layer by layer through the
        tables, then each row's ``pos`` (absolute positions below its true
        length, -1 after), write index and device page table, as the
        capacity-wide scatter leaves them."""
        dev, c = self.device, self.cache
        cap = int(self.serving.max_seq)
        pt_d = torch.as_tensor(pt_rows, device=dev)
        logits = self.model.prefill_paged(self.params, batch, c,
                                          pt_d[:, :npg], cap)
        s = int(batch["tokens"].shape[1]) + self._prompt_prefix(batch)
        total_d = torch.as_tensor(total, device=dev)
        # a prompt longer than the capacity keeps its last ``cap`` rows
        p = torch.arange(cap, dtype=torch.int32, device=dev) + max(0, s - cap)
        c["pos"][slots_d] = torch.where(p[None] < total_d[:, None], p[None],
                                        -1)
        c["index"][slots_d] = (torch.clamp(total_d, max=cap) % cap).to(
            torch.int32)
        c["pages"][slots_d] = pt_d
        return logits

    def _insert_cache(self, cache1: Dict[str, Any], slot: int) -> None:
        """Copy a batch-1 cache into slot ``slot`` (through the page table
        on paged engines: CoW-shared pages receive the very bytes that were
        gathered out of them, unreserved tail entries land on the null
        page)."""
        c = self.cache
        pt = (None if self._pt is None
              else torch.as_tensor(self._pt[slot], device=self.device))
        for name, one in _named_leaves(cache1):
            bax = self._axis_by_name[name][0]
            leaf = _get(c, name)
            row = one[_at(bax, 0)]
            if name in self._paged_names:
                page = self.serving.kv_page_size
                row = row.reshape(row.shape[:bax] + (self._n_pt, page)
                                  + row.shape[bax + 1:])
                leaf[_at(bax, pt.long())] = row.to(leaf.dtype)
            else:
                leaf[_at(bax, slot)] = row.to(leaf.dtype)
        if pt is not None:
            c["pages"][slot] = pt

    def _context_bucket(self, needed: int) -> int:
        """Smallest {2^n, 1.5*2^n} ladder value covering ``needed``
        positions."""
        teff = 32
        while teff < needed:
            teff = teff * 3 // 2 if teff & (teff - 1) == 0 else teff * 4 // 3
        return min(teff, self.serving.max_seq)

    # ------------------------------------------------------------------

    def submit(self, rid: int, tokens: np.ndarray, max_new: int = 32,
               extras: Optional[Dict[str, np.ndarray]] = None,
               deadline: Optional[float] = None,
               session: Optional[str] = None) -> None:
        """Queue a prompt. ``deadline`` (monotonic seconds) enables
        EDF-ordered admission: the waiting queue is drained
        earliest-deadline-first instead of FIFO. ``session`` names a
        multi-turn session: the finished turn's slot state is parked so a
        later turn whose prompt extends this conversation resumes it
        (prefilling only the new tokens)."""
        self.journal.append(("submit", {"rid": rid, "tokens": tokens,
                                        "max_new": max_new,
                                        "extras": extras,
                                        "deadline": deadline,
                                        "session": session}))
        self.waiting.append({"rid": rid, "tokens": np.asarray(tokens),
                             "max_new": max_new, "extras": extras or {},
                             "deadline": deadline, "session": session,
                             "t": time.monotonic()})

    def cancel(self, rid: int) -> bool:
        """Abort a request wherever it is (waiting or mid-decode); the freed
        slot is refilled at the next admission."""
        for i, j in enumerate(self.waiting):
            if j["rid"] == rid:
                del self.waiting[i]
                self.journal.append(("cancel", {"rid": rid}))
                return True
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                self.slots[i] = None  # KV rows are overwritten on next admit
                self._release_pages(i)
                self.journal.append(("cancel", {"rid": rid}))
                return True
        return False

    # -- cross-tier KV migration -------------------------------------------

    def _leaf_rows(self):
        """``(name, leaf, batch_axis)`` per cache leaf of a DENSE engine."""
        for name, leaf in _named_leaves(self.cache):
            yield name, leaf, self._axis_by_name[name][0]

    def _slot_payload(self, slot: int) -> SlotPayload:
        """Slot ``slot``'s full migratable state (cache rows, SeqState,
        position, sampling key, prompt tokens). The rows are copies on this
        engine's device; ``to_bytes`` moves them to the host, so a payload
        parked and resumed on the same tier never leaves the device."""
        if self._pt is not None:
            leaves = self._gather_slot_rows(slot)
        else:
            leaves = {name: leaf[_at(bax, slot)].clone()
                      for name, leaf, bax in self._leaf_rows()}
        return SlotPayload(
            version=MIGRATION_WIRE_VERSION, model=self.cfg.name,
            family=self.cfg.family, max_seq=self.serving.max_seq,
            seq=self._copy_seq(self.slots[slot]),
            position=int(self.positions[slot]),
            key=self._keys[slot].copy(), leaves=leaves,
            prompt_tokens=self._slot_prompt[slot],
            extras_fp=self._slot_extras_fp[slot])

    def extract_slot(self, rid: int, *, remove: bool = False) -> SlotPayload:
        """Serialize one request's migratable state (see ``SlotPayload``).
        ``remove=True`` frees the slot (preemption / re-homing); the default
        keeps the donor decoding (hedged clone races the original)."""
        slot = next((i for i, s in enumerate(self.slots)
                     if s is not None and s.rid == rid), None)
        if slot is None:
            raise MigrationError(
                f"rid {rid} holds no decode slot on this engine")
        payload = self._slot_payload(slot)
        if remove:
            self.slots[slot] = None  # KV rows overwritten on the next admit
            self._release_pages(slot)
        self.journal.append(("extract", {"rid": rid, "removed": remove}))
        return payload

    def inject_slot(self, payload: SlotPayload) -> int:
        """Install a migrated request into a free slot and resume its decode
        exactly where the donor left off (no prefill: ``prefill_tokens``
        does not move). Validates the wire version, model spec, every
        leaf's shape/dtype, the key and (paged) the page reservation BEFORE
        touching the cache; any mismatch raises :class:`MigrationError` and
        leaves this engine unchanged."""
        if payload.version != MIGRATION_WIRE_VERSION:
            raise MigrationError(
                f"wire format version {payload.version} != supported "
                f"{MIGRATION_WIRE_VERSION}")
        if payload.model != self.cfg.name or payload.family != self.cfg.family:
            raise MigrationError(
                f"payload from {payload.model!r} ({payload.family}) cannot be "
                f"injected into {self.cfg.name!r} ({self.cfg.family}): KV "
                f"caches are model-specific")
        if any(s is not None and s.rid == payload.seq.rid for s in self.slots):
            raise MigrationError(
                f"rid {payload.seq.rid} already occupies a slot here")
        slot = self._free_slot()
        if slot is None:
            raise MigrationError("no free decode slot to inject into")
        rows = dict(payload.leaves)
        if set(self._row_specs) != set(rows):
            raise MigrationError(
                f"cache leaf mismatch: payload has {sorted(rows)}, engine "
                f"expects {sorted(self._row_specs)}")
        for name, (want, dtype) in self._row_specs.items():
            row = rows[name]
            if tuple(row.shape) != tuple(want):
                raise MigrationError(
                    f"leaf {name}: payload row shape {tuple(row.shape)} != "
                    f"engine row shape {tuple(want)} (max_seq "
                    f"{payload.max_seq} vs {self.serving.max_seq}?)")
            if dtype_tag(row) != dtype:
                raise MigrationError(
                    f"leaf {name}: payload dtype {dtype_tag(row)} != engine "
                    f"dtype {dtype}")
        key = np.asarray(payload.key)
        if key.shape != (2,) or key.dtype != np.uint32:
            raise MigrationError(
                f"sampling key {key.dtype}{list(key.shape)} is not uint32[2]")
        if self.pool is not None:
            seq = payload.seq
            total = min(payload.position
                        + max(int(seq.max_new) - len(seq.generated), 0) + 1,
                        self.serving.max_seq)
            pages = self._reserve_pages(self._page_need(total))
            if pages is None:
                raise MigrationError(
                    "no free KV pages to inject into (pool exhausted)")
            self._assign_pages(slot, pages)
        self._install_rows(slot, rows)
        self.slots[slot] = self._copy_seq(payload.seq)
        self.positions[slot] = payload.position
        self._keys[slot] = key
        self._slot_prompt[slot] = (None if payload.prompt_tokens is None
                                   else np.asarray(payload.prompt_tokens))
        self._slot_extras_fp[slot] = payload.extras_fp
        self.journal.append(("inject", {"rid": payload.seq.rid, "slot": slot}))
        return slot

    # -- prefix & session KV reuse -----------------------------------------

    def _job_fp(self, job: Dict[str, Any]) -> bytes:
        """Extras fingerprint of a waiting job, computed once and cached."""
        fp = job.get("_fp")
        if fp is None:
            fp = extras_fingerprint(job["extras"])
            job["_fp"] = fp
        return fp

    def _rows_compatible(self, rows: Dict[str, Any]) -> bool:
        """True when ``rows`` (keystr -> per-slot row) matches this engine's
        DENSE per-slot row geometry exactly (same leaves, shapes, dtypes).
        Paged and dense engines share the geometry."""
        if set(rows) != set(self._row_specs):
            return False
        for name, (shape, dtype) in self._row_specs.items():
            row = rows[name]
            if tuple(row.shape) != tuple(shape) or dtype_tag(row) != dtype:
                return False
        return True

    def _payload_resumable(self, p: SlotPayload) -> bool:
        return (p.version == MIGRATION_WIRE_VERSION
                and p.model == self.cfg.name
                and p.family == self.cfg.family
                and p.max_seq == self.serving.max_seq
                and self._rows_compatible(p.leaves))

    @staticmethod
    def _payload_tokens(p: SlotPayload) -> Optional[np.ndarray]:
        """The tokens a payload's cache rows cover: the prompt plus every
        generated token except the last (sampled but never fed)."""
        if p.prompt_tokens is None:
            return None
        prompt = np.asarray(p.prompt_tokens, np.int32)
        gen = np.asarray(p.seq.generated[:-1], np.int32)
        return np.concatenate([prompt, gen]) if gen.size else prompt

    def park_session(self, rid: int, sid: Optional[str] = None) -> bool:
        """Mark a queued or in-flight request so its slot state parks under
        ``sid`` when it finishes (``submit(session=...)`` does this up
        front). Returns False when the rid is unknown or no sid is set."""
        for j in self.waiting:
            if j["rid"] == rid:
                j["session"] = sid or j.get("session")
                return j["session"] is not None
        for s in self.slots:
            if s is not None and s.rid == rid:
                s.session = sid or s.session
                return s.session is not None
        return False

    def resume_session(self, sid: str) -> Optional[ParkedSession]:
        """Pop a parked session (the caller consumes its rows). Admission
        does this internally; it is public for cross-tier moves."""
        return self.sessions.resume(sid)

    def adopt_session(self, sid: str, payload: SlotPayload) -> bool:
        """Install a session payload parked on ANOTHER engine (the sticky
        router moved it here). Incompatible payloads are refused: the next
        turn then falls back to a cold prefill."""
        if not self._payload_resumable(payload):
            return False
        tokens = self._payload_tokens(payload)
        if tokens is None:
            return False
        nbytes = sum(v.nbytes for v in payload.leaves.values())
        ok = self.sessions.park(sid, ParkedSession(
            tokens=tokens, extras_fp=payload.extras_fp,
            nbytes=float(nbytes), data=payload))
        if ok:
            self.journal.append(("adopt", {"sid": sid}))
        return ok

    def _park(self, slot: int, st: SeqState) -> None:
        """Park a finishing slot's state under its session id (called from
        ``_finish_slot`` while the cache rows are still intact)."""
        if not st.session or not self.sessions.enabled:
            return
        if self._slot_prompt[slot] is None:
            return  # injected without prompt tokens: nothing to match later
        payload = self._slot_payload(slot)
        tokens = self._payload_tokens(payload)
        nbytes = sum(v.nbytes for v in payload.leaves.values())
        ok = self.sessions.park(st.session, ParkedSession(
            tokens=tokens, extras_fp=self._slot_extras_fp[slot],
            nbytes=float(nbytes), data=payload))
        if ok:
            self.parks += 1
            self.journal.append(("park", {"rid": st.rid, "sid": st.session}))
            if self.on_park is not None:
                self.on_park(st.rid, st.session)

    def _warm_plan(self, job: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Reuse plan for a waiting job: a parked session its prompt
        extends, else a stored prefix it extends; None means cold prefill.
        ``rows``/``start`` describe the cache state to re-inject;
        ``time_len`` is set when ``rows`` are seq-sliced pieces that must be
        pasted into zeroed full-capacity rows."""
        tokens = np.asarray(job["tokens"])
        cap = self.serving.max_seq
        sid = job.get("session")
        if sid and self.sessions.enabled:
            parked = self.sessions.peek(sid)
            if parked is not None and parked.extras_fp == self._job_fp(job):
                suffix = extension_suffix(parked.tokens, tokens)
                p = parked.data
                if (suffix is not None and isinstance(p, SlotPayload)
                        and self._payload_resumable(p)
                        and p.position + len(suffix) + 1 < cap):
                    # the parked rows are popped at COMMIT time (in
                    # _admit_warm_hits): page reservation may still defer
                    # this admission. cached counts the cache POSITIONS
                    # reused (vision prefix included)
                    return {"kind": "resume", "rows": p.leaves,
                            "start": p.position, "time_len": None,
                            "suffix": suffix, "cached": p.position,
                            "sid": sid}
        if self.prefix_store.enabled:
            e = self.prefix_store.lookup(tokens, self._job_fp(job))
            if e is None:
                return None
            suffix = np.asarray(tokens[len(e.tokens):])
            if e.sliceable:
                vis = self._prompt_prefix(job["extras"])
                start = vis + len(e.tokens)
                if start + len(suffix) + 1 < cap:
                    plan = {"kind": "prefix", "rows": e.data, "start": start,
                            "time_len": start, "suffix": suffix,
                            "cached": start}
                    if self._pt is not None:
                        # paged entry: {"pages", "t_len"}; rows are
                        # gathered (and full pages CoW-shared) at admit
                        plan["rows"] = None
                        plan["pages_entry"] = e.data
                    return plan
            else:
                # a whole processed sequence's point-in-time state
                start = int(e.data["position"])
                rows = e.data["rows"]
                if (self._rows_compatible(rows)
                        and start + len(suffix) + 1 < cap):
                    return {"kind": "prefix", "rows": rows, "start": start,
                            "time_len": None, "suffix": suffix,
                            "cached": start}
        return None

    def _admit_warm_hits(self) -> None:
        i = 0
        while i < len(self.waiting):
            slot = self._free_slot()
            if slot is None:
                return
            job = self.waiting[i]
            plan = self._warm_plan(job)
            if plan is None:
                i += 1
                continue
            if self.pool is not None and not self._reserve_warm(job, plan):
                # starved for pages: stop admitting (FIFO within warm hits)
                # and let the fused block split at the pressure boundary
                self._page_starved(job)
                return
            self._page_granted(job)
            if plan.get("sid"):
                self.sessions.resume(plan["sid"])  # rows consumed this turn
            del self.waiting[i]
            self._admit_warm(job, slot, plan)

    def _reserve_warm(self, job: Dict[str, Any],
                      plan: Dict[str, Any]) -> bool:
        """Reserve ``job``'s full page budget for a warm admission. FULL
        pages strictly behind the reused frontier are CoW-shared from the
        store entry (incref, no copy); the boundary page and the growth tail
        come from fresh pages. All-or-nothing: on failure every reference
        taken here is dropped."""
        start = int(plan["start"])
        total = min(start + len(plan["suffix"]) + int(job["max_new"]),
                    self.serving.max_seq)
        need = self._page_need(total)
        ent = plan.get("pages_entry")
        shared: List[int] = []
        if ent is not None:
            ps = self.serving.kv_page_size
            shared = [int(p) for p in ent["pages"][:int(ent["t_len"]) // ps]]
            # pin BEFORE allocating: _reserve_pages may evict this very
            # store entry under pressure, and its pages must survive
            self.pool.incref(shared)
        fresh = self._reserve_pages(need - len(shared))
        if fresh is None:
            if shared:
                self.pool.decref(shared)
            return False
        plan["_pages"] = shared + fresh
        return True

    def _admit_warm(self, job: Dict[str, Any], slot: int,
                    plan: Dict[str, Any]) -> None:
        """Copy reused cache rows into a batch-1 cache, prefill ONLY the
        suffix in one ``decode_chunk`` pass, and scatter the result into
        ``slot``. ``prefill_tokens`` moves by the suffix length alone."""
        cap = self.serving.max_seq
        dev = self.device
        pages = plan.pop("_pages", None)
        if pages is not None:
            self._assign_pages(slot, pages)
        rows = plan["rows"]
        if rows is None and plan.get("pages_entry") is not None:
            # copy-free hit: the shared pages are already mapped into the
            # slot's table; gather them once into seq-sliced dense pieces
            # for the batch-1 suffix prefill below
            rows = self._gather_prefix_rows(plan["pages_entry"])
        t_len = plan["time_len"]
        start = int(plan["start"])
        suffix = np.asarray(plan["suffix"], np.int32)

        cache1: Dict[str, Any] = {}
        for name, (full, dtype) in self._dense_specs.items():
            bax, sax = self._axis_by_name[name]
            shape = full[:bax] + full[bax + 1:]
            row = rows.get(name)
            if row is not None and tuple(row.shape) == tuple(shape):
                # a COPY: decode_chunk writes in place, and a parked or
                # stored row must survive its admission
                out = _as_tensor(row, dtype, dev).clone()
            elif row is not None:  # seq-sliced piece -> paste into zeros
                rsax = sax - (1 if sax > bax else 0)
                out = torch.zeros(shape, dtype=dtype, device=dev)
                out.narrow(rsax, 0, row.shape[rsax]).copy_(
                    _as_tensor(row, dtype, dev))
            elif name == "['pos']":  # synthesized: linear placement
                out = torch.full(shape, -1, dtype=dtype, device=dev)
                out[:t_len] = torch.arange(t_len, dtype=dtype, device=dev)
            elif name == "['index']":
                out = torch.tensor(t_len % cap, dtype=dtype, device=dev)
            else:  # unreachable for known caches; keep the walk total
                out = torch.zeros(shape, dtype=dtype, device=dev)
            _put(cache1, name, out.unsqueeze(bax))
        n = len(suffix)
        total = start + n
        np_ = n
        if self._sliceable:
            # pad to the power-of-two ladder (like bucketed prefill); pad
            # writes land past the true end and are re-masked below
            np_ = min(_next_bucket(n, lo=8), cap - start)
        toks = np.full((np_,), suffix[-1], np.int32)
        toks[:n] = suffix
        positions = start + np.arange(np_, dtype=np.int32)
        teff = (self._context_bucket(start + np_ + 1) if self._ctx_buckets
                else cap)
        batch = {"tokens": torch.as_tensor(toks[None], device=dev),
                 "positions": torch.as_tensor(positions[None], device=dev)}
        if np_ > n:
            batch["lengths"] = torch.as_tensor([n], dtype=torch.int32,
                                               device=dev)
        if self._sliceable:
            # ONE multi-token pass over the suffix: decode_chunk writes the
            # new KV rows and attends the reused prefix by position
            logits1, cache1 = self.model.decode_chunk(
                self.params, cache1, batch,
                ctx=(teff if teff < cap else None))
        elif self._warm_chunk_recurrent:
            # ONE pass seeding the ssd / rglru scans from the cached state
            # (exact length: recurrent state admits no padding)
            logits1, cache1 = self.model.decode_chunk_recurrent(
                self.params, cache1, batch)
        else:
            # point-in-time state stepped token by token over the suffix
            logits1, cache1 = self._step_suffix(cache1, toks, positions)
        first_logits = logits1.float().cpu().numpy()[0]
        if np_ > n:
            cache1["pos"] = torch.where(cache1["pos"] < total, cache1["pos"],
                                        -1)
            cache1["index"] = torch.full_like(cache1["index"], total % cap)
        self._insert_cache(cache1, slot)
        self._start_seq(job, slot, total, first_logits, prefill_count=n,
                        warm=(plan["kind"], int(plan["cached"])))

    def _step_suffix(self, cache1: Dict[str, Any], toks: np.ndarray,
                     positions: np.ndarray):
        """The model's own ``decode_step`` over a suffix, one token at a
        time, on the batch-1 ``cache1`` (in place). Returns the last
        token's logits (1, V) and the cache."""
        for tok, pos in zip(toks, positions):
            logits, cache1 = self.model.decode_step(
                self.params, cache1,
                {"tokens": torch.tensor([[int(tok)]], dtype=torch.int32,
                                        device=self.device),
                 "positions": torch.tensor([int(pos)], dtype=torch.int32,
                                           device=self.device)})
        return logits, cache1

    def _store_prefixes(self, slot: int, job: Dict[str, Any]) -> None:
        """Deposit a just-admitted slot's cache rows into the prefix store
        at bucket-aligned prefix lengths (sliceable families) or the exact
        processed length (ssm/hybrid point-in-time state)."""
        if not self.prefix_store.enabled:
            return
        tokens = np.asarray(job["tokens"])
        vis = self._prompt_prefix(job["extras"])
        if vis + len(tokens) > self.serving.max_seq:
            return  # rolled/truncated cache rows don't map to positions
        fp = self._job_fp(job)
        store = self.prefix_store
        if not self._sliceable:
            if store.contains(tokens, fp):
                return
            rows = {name: leaf[_at(bax, slot)].clone()
                    for name, leaf, bax in self._leaf_rows()}
            nb = float(sum(r.nbytes for r in rows.values()))
            store.insert(tokens, fp, nb,
                         {"rows": rows, "position": int(vis + len(tokens))},
                         sliceable=False)
            return
        need = [L for L in prefix_buckets(len(tokens), store.min_prefix)
                if not store.contains(tokens[:L], fp)]
        if not need:
            return
        if self._pt is not None:
            # copy-free deposit: the entry is a page-id list increfing the
            # slot's own pages, no row duplication. The boundary page is
            # increfed for CONTENT liveness only (warm hits CoW-share just
            # the full pages strictly behind t_len; the depositor keeps
            # writing rows >= t_len on that page, which readers never see
            # because they slice to t_len).
            ps = self.serving.kv_page_size
            for L in need:
                t_len = vis + L
                npg = pages_needed(t_len, ps, self.serving.max_seq)
                pages = [int(p) for p in self._pt[slot][:npg]]
                self.pool.incref(pages)
                ok = store.insert(tokens[:L], fp,
                                  npg * self.pool.page_bytes,
                                  {"pages": pages, "t_len": t_len},
                                  sliceable=True)
                if not ok:
                    self.pool.decref(pages)
            return
        # rows stay on the device: a copy of each bucket's slice
        rows = {name: leaf[_at(bax, slot)]
                for name, leaf, bax in self._leaf_rows()
                if name not in _BOOKKEEPING}
        for L in need:
            t_len = vis + L
            data = {}
            nb = 0.0
            for name, row in rows.items():
                bax, sax = self._axis_by_name[name]
                rsax = sax - (1 if sax > bax else 0)
                piece = row.narrow(rsax, 0, t_len).clone()
                nb += piece.nbytes
                data[name] = piece
            store.insert(tokens[:L], fp, nb, data, sliceable=True)

    def _on_prefix_evict(self, entry) -> None:
        """Store removal hook: decref a paged entry's shared pages."""
        data = getattr(entry, "data", None)
        if isinstance(data, dict) and "pages" in data:
            self.pool.decref(data["pages"])

    def _gather_slot_rows(self, slot: int) -> Dict[str, Any]:
        """Dense-geometry per-slot rows gathered THROUGH the page table:
        the paged engine's side of the (unchanged) migration wire format.
        Rows past the written frontier come from the null page; their
        positions are -1, so they are masked wherever they land."""
        n_pt, page = self._n_pt, self.serving.kv_page_size
        pt = torch.as_tensor(self._pt[slot], device=self.device).long()
        rows = {}
        for name, leaf in _named_leaves(self.cache):
            if name == "['pages']":
                continue
            bax = self._axis_by_name[name][0]
            if name in self._paged_names:
                g = leaf[_at(bax, pt)]  # (..., n_pt, page, ...)
                rows[name] = g.reshape(g.shape[:bax] + (n_pt * page,)
                                       + g.shape[bax + 2:])
            else:
                rows[name] = leaf[_at(bax, slot)].clone()
        return rows

    def _gather_prefix_rows(self, ent: Dict[str, Any]) -> Dict[str, Any]:
        """Materialize a paged prefix-store entry ({"pages", "t_len"}) into
        the seq-sliced dense pieces the warm-admission build step pastes;
        the deposit itself was copy-free (page increfs, no row copies)."""
        page = self.serving.kv_page_size
        t_len = int(ent["t_len"])
        npg = len(ent["pages"])
        pt = torch.as_tensor(ent["pages"], dtype=torch.long,
                             device=self.device)
        rows = {}
        for name in self._paged_names:
            leaf = _get(self.cache, name)
            bax = self._axis_by_name[name][0]
            g = leaf[_at(bax, pt)]
            g = g.reshape(g.shape[:bax] + (npg * page,) + g.shape[bax + 2:])
            rows[name] = g[_at(bax, slice(0, t_len))]
        return rows

    def _install_rows(self, slot: int, rows: Dict[str, Any]) -> None:
        """Scatter dense-geometry per-slot rows into ``slot`` (through the
        page table on paged engines). Inverse of ``_gather_slot_rows``."""
        pt = (None if self._pt is None
              else torch.as_tensor(self._pt[slot], device=self.device))
        for name, (_, dtype) in self._dense_specs.items():
            leaf = _get(self.cache, name)
            bax = self._axis_by_name[name][0]
            row = _as_tensor(rows[name], dtype, self.device)
            if name in self._paged_names:
                page = self.serving.kv_page_size
                row = row.reshape(row.shape[:bax] + (self._n_pt, page)
                                  + row.shape[bax + 1:])
                leaf[_at(bax, pt.long())] = row
            else:
                leaf[_at(bax, slot)] = row
        if pt is not None:
            self.cache["pages"][slot] = pt

    # -- cross-tier speculative decoding (draft-and-verify) -----------------
    #
    # The cluster runtime drives one verify loop per speculated request:
    #
    #   target: submit + _admit (a NORMAL slot)    draft: spec_admit_quiet
    #   target: spec_begin (trim pages to the written frontier)
    #   loop:   draft.spec_draft(k) -> target.spec_verify(block)
    #           -> draft.spec_sync(committed)
    #   target: spec_release (restore the eager full-budget reservation
    #           before the slot returns to the fused step() path)
    #
    # spec_verify feeds [pending, d_1..d_k] through ONE decode_chunk with
    # per-position logits, samples the target's OWN token at every position
    # (the keyed draw at the position the fused path would use), commits the
    # longest prefix on which the draft agreed plus the target's correction
    # token, and rolls the cache back past the first mismatch (pos/index
    # rewind before the batch-1 insert; recurrent: re-feed the committed
    # prefix from the untouched slot rows; paged: decref the speculative
    # tail pages). The committed stream is BY CONSTRUCTION the target-only
    # stream, so speculation changes latency, never output.
    #
    # The model writes its cache in place, so the draft block and the
    # verify chunk run on a batch-1 CLONE of the slot's rows; the slot
    # itself changes only through an explicit ``_insert_cache``.

    def _spec_chunk(self, cache1: Dict[str, Any],
                    batch: Dict[str, torch.Tensor], teff: int):
        """The verify chunk: every position's logits (1, S, V) of ``batch``
        fed through ``cache1`` in one pass (in place)."""
        cap = self.serving.max_seq
        if self._sliceable:
            return self.model.decode_chunk(
                self.params, cache1, batch,
                ctx=(teff if teff < cap else None), all_logits=True)
        self._refuse_unchunked()
        return self.model.decode_chunk_recurrent(self.params, cache1, batch,
                                                 all_logits=True)

    def _refuse_unchunked(self) -> None:
        """Speculation feeds a block of tokens in one chunked pass: the
        encdec family has none (neither has the JAX package's)."""
        if not hasattr(self.model, "decode_chunk_recurrent"):
            raise NotImplementedError(
                f"speculative decoding: the {self.cfg.family} family has no "
                f"chunked decode (decode_chunk / decode_chunk_recurrent)")

    def _spec_cache1(self, slot: int) -> Dict[str, Any]:
        """Batch-1 cache holding COPIES of ``slot``'s rows (gathered
        through the page table on paged engines): the draft block and the
        verify chunk write into it in place, and the slot is untouched
        until an explicit ``_insert_cache``."""
        if self._pt is not None:
            rows = self._gather_slot_rows(slot)
        else:
            rows = {name: leaf[_at(bax, slot)].clone()
                    for name, leaf, bax in self._leaf_rows()}
        cache1: Dict[str, Any] = {}
        for name, (_, dtype) in self._dense_specs.items():
            bax = self._axis_by_name[name][0]
            _put(cache1, name, rows[name].to(dtype).unsqueeze(bax))
        return cache1

    def spec_slot(self, rid: int) -> Optional[int]:
        """Slot currently serving ``rid`` (None: queued/finished/unknown)."""
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                return i
        return None

    def _spec_resize_pages(self, slot: int, rows: int) -> bool:
        """Resize ``slot``'s page reservation to exactly cover ``rows``
        cache rows. The verify loop grows ahead of each chunk and shrinks
        back to the committed frontier afterwards: the decref IS the
        rejected speculative tail's release. Only pages strictly beyond
        the written frontier ever trim, so CoW pages shared with the
        prefix store (always behind the frontier) are never touched.
        Returns False when the pool cannot grow."""
        if self._pt is None:
            return True  # dense engine / recurrent flat charge: no-op
        need = self._page_need(min(int(rows), self.serving.max_seq))
        have = self._slot_pages[slot]
        if need > len(have):
            fresh = self._reserve_pages(need - len(have))
            if fresh is None:
                return False
            have.extend(fresh)
        elif need < len(have):
            tail = have[need:]
            del have[need:]
            self.pool.decref(tail)
        row = np.zeros((self._n_pt,), np.int32)
        row[:len(have)] = have
        self._pt[slot] = row
        self.cache["pages"][slot] = torch.as_tensor(row, device=self.device)
        # allocator invariants: rejected-tail pages really came back, the
        # table matches the reservation, and every pool page is free XOR
        # referenced (refcount leaks fail loudly here, not at eviction)
        assert len(self._slot_pages[slot]) == need, (
            f"slot {slot}: reservation {len(self._slot_pages[slot])} != "
            f"needed {need} pages")
        self.pool.check()
        return True

    def spec_admit_quiet(self, rid: int, tokens: np.ndarray, max_new: int,
                         extras: Optional[Dict[str, Any]] = None
                         ) -> Optional[int]:
        """Admit a DRAFT-side shadow of a speculated request: a normal slot
        (the single-job prefill of ``_admit_legacy``) admitted with the
        streaming hooks muted: the target's hooks are the request's real
        event stream and the runtime must not see admit/token events twice.
        Returns the slot, or None when admission failed (no slot / no pages
        / finished straight out of prefill), in which case no trace
        remains."""
        slot = self._free_slot()
        if slot is None:
            return None
        job = {"rid": int(rid), "tokens": np.asarray(tokens),
               "max_new": int(max_new), "extras": extras or {},
               "deadline": None, "session": None, "t": time.monotonic()}
        if self.pool is not None:
            vis = self._prompt_prefix(job["extras"])
            total = min(vis + len(job["tokens"]) + int(max_new),
                        self.serving.max_seq)
            pages = self._reserve_pages(self._page_need(total))
            if pages is None:
                return None
            self._assign_pages(slot, pages)
        hooks = (self.on_admit, self.on_token, self.on_warm, self.on_park)
        self.on_admit = self.on_token = self.on_warm = self.on_park = None
        try:
            toks = job["tokens"][None]
            batch = self._device_batch(toks, {k: np.asarray(v)[None] for k, v
                                              in job["extras"].items()})
            logits, cache1 = self.model.prefill(self.params, batch,
                                                self.serving.max_seq)
            self._insert_cache(cache1, slot)
            prefix = self._prompt_prefix(job["extras"])
            self._start_seq(job, slot, toks.shape[1] + prefix,
                            logits.float().cpu().numpy()[0])
        finally:
            self.on_admit, self.on_token, self.on_warm, self.on_park = hooks
        st = self.slots[slot]
        if st is None or st.rid != rid:
            # finished straight out of prefill (EOS / budget / cap): a
            # draft shadow has no consumer; drop the finished record
            self.finished = [f for f in self.finished if f.rid != rid]
            return None
        self.journal.append(("spec_admit", {"rid": rid, "slot": slot}))
        return slot

    def spec_set_pending(self, rid: int, token: int) -> None:
        """Overwrite the draft slot's pending (last sampled, not yet in
        cache) token with the TARGET's: after admission and after every
        verify round the draft continues from what the target actually
        committed. Modulo this model's vocabulary, which may be smaller
        than the target's."""
        slot = self.spec_slot(rid)
        if slot is None:
            return
        self.slots[slot].generated[-1] = int(token) % self.cfg.vocab_size

    def spec_begin(self, rid: int) -> bool:
        """Start speculating on a target slot: trim the eager full-budget
        page reservation down to the written frontier so verify rounds can
        grow/shrink page-exactly. Balanced by ``spec_release``."""
        slot = self.spec_slot(rid)
        if slot is None:
            return False
        self._spec_resize_pages(slot, int(self.positions[slot]))
        self.journal.append(("spec_begin", {"rid": rid}))
        return True

    def spec_release(self, rid: int) -> None:
        """Stop speculating: restore the slot's eager full-budget page
        reservation (remaining decode + the pending token's row) so the
        fused ``step()`` path can run it to completion without mid-decode
        page faults: its writes assume the admission-time reservation."""
        slot = self.spec_slot(rid)
        if slot is None:
            return
        st = self.slots[slot]
        total = min(int(self.positions[slot])
                    + max(0, st.max_new - len(st.generated)) + 1,
                    self.serving.max_seq)
        ok = self._spec_resize_pages(slot, total)
        # the verify loop only ever GREW past the frontier with pages it
        # returns before anyone else allocates, so the regrow cannot starve
        assert ok, f"spec_release could not restore rid {rid}'s reservation"
        self.journal.append(("spec_release", {"rid": rid}))

    def _spec_teff(self, needed: int) -> int:
        return (self._context_bucket(needed) if self._ctx_buckets
                else self.serving.max_seq)

    def spec_draft(self, rid: int, k: int) -> Optional[np.ndarray]:
        """Propose ``k`` tokens for ``rid``: ``k`` decode steps on a batch-1
        COPY of the slot's cache, sampled on the device (argmax, or the
        slot's keyed draw) with one host sync for the block. The slot
        itself (rows, position, generated) is not advanced: ``spec_sync``
        does that once the target reports what it committed."""
        slot = self.spec_slot(rid)
        if slot is None:
            return None
        st = self.slots[slot]
        p = int(self.positions[slot])
        k = min(int(k), self.serving.max_seq - 1 - p)
        if k <= 0:
            return None
        cache1 = self._spec_cache1(slot)
        teff = self._spec_teff(p + k + 1)
        ctx = teff if teff < self.serving.max_seq else None
        dev = self.device
        tok = torch.tensor([int(st.generated[-1])], dtype=torch.int32,
                           device=dev)
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        if self.temp > 0:
            key = torch.as_tensor(self._keys[slot:slot + 1].astype(np.int64),
                                  device=dev)
            rid_d = torch.tensor([rid], dtype=torch.int64, device=dev)
        out = []
        for _ in range(k):
            logits, cache1 = self.model.decode_step(
                self.params, cache1, {"tokens": tok[:, None],
                                      "positions": pos}, ctx=ctx)
            if self.temp > 0:
                nxt = keyed_sample(logits, key, rid_d, pos, self.temp)
            else:
                nxt = torch.argmax(logits, dim=-1)
            tok = nxt.to(torch.int32)
            pos = pos + 1
            out.append(tok)
        self.drafted_tokens += k
        self.journal.append(("spec_draft", {"rid": rid, "k": k}))
        return torch.cat(out).cpu().numpy()

    def spec_verify(self, rid: int, draft) -> Optional[Dict[str, Any]]:
        """Verify a draft block against this TARGET slot in one chunked
        forward. Feeds ``[pending, d_1..d_k]`` at positions ``p..p+k``,
        samples the target's own token at every position (row ``i`` draws
        at position ``p + i``, the position of the token its logits
        follow, as the fused path does, so a rejected draft never shifts
        the stream), commits the agreeing prefix + the correction token,
        and rolls back everything past the first mismatch. Returns the
        round's bookkeeping, or None when the slot is gone / nothing can
        verify."""
        slot = self.spec_slot(rid)
        if slot is None:
            return None
        st = self.slots[slot]
        p = int(self.positions[slot])
        draft = [int(x) for x in np.asarray(draft).reshape(-1)]
        k = min(len(draft), self.serving.max_seq - 1 - p)
        if k <= 0:
            return None
        draft = draft[:k]
        s = k + 1
        while s > 1 and not self._spec_resize_pages(slot, p + s):
            k -= 1
            s -= 1
            draft = draft[:k]  # pool-starved: verify a shorter block
        if not self._spec_resize_pages(slot, p + s):
            return None
        dev = self.device
        cache1 = self._spec_cache1(slot)
        toks = np.asarray([int(st.generated[-1])] + draft, np.int32)
        poss = p + np.arange(s, dtype=np.int32)
        batch = {"tokens": torch.as_tensor(toks[None], device=dev),
                 "positions": torch.as_tensor(poss[None], device=dev)}
        teff = self._spec_teff(p + s + 1)
        cap = self.serving.max_seq
        logits_all, cache2 = self._spec_chunk(cache1, batch, teff)
        logits_all = logits_all[0]  # (s, V)
        if self.temp > 0:
            sampled = keyed_sample(
                logits_all, torch.as_tensor(
                    self._keys[slot:slot + 1].astype(np.int64)).expand(s, 2),
                torch.full((s,), rid, dtype=torch.int64),
                torch.as_tensor(poss), self.temp)
        else:
            sampled = torch.argmax(logits_all, dim=-1)
        sampled = sampled.cpu().numpy()  # the round's one host sync
        commits: List[int] = []
        finished = False
        for i in range(s):
            nxt = int(sampled[i])
            commits.append(nxt)
            if (nxt == self.eos_id
                    or len(st.generated) + len(commits) >= st.max_new
                    or p + len(commits) + 1 >= cap):
                finished = True
                break
            if i < k and draft[i] != nxt:
                break  # first mismatch: the tail is dead
        m = len(commits)  # cache rows now valid: [pending] + accepted
        commit_end = p + m
        if self._sliceable:
            # rewind BEFORE the insert, as after a padded warm admission:
            # rejected rows read as holes, the write index resumes at the
            # committed frontier
            cache2["pos"] = torch.where(cache2["pos"] < commit_end,
                                        cache2["pos"], -1)
            cache2["index"] = torch.full_like(cache2["index"],
                                              commit_end % cap)
            self._insert_cache(cache2, slot)
        elif m == s:
            self._insert_cache(cache2, slot)  # nothing to rewind
        else:
            # recurrent state is a point-in-time snapshot: it cannot
            # rewind. Re-feed ONLY the committed prefix from the slot's
            # untouched rows (the verify ran on a copy)
            redo = {"tokens": batch["tokens"][:, :m],
                    "positions": batch["positions"][:, :m]}
            _, redo1 = self._spec_chunk(self._spec_cache1(slot), redo, teff)
            self._insert_cache(redo1, slot)
        self.positions[slot] = commit_end
        self._spec_resize_pages(slot, commit_end)  # decref rejected tail
        self.accepted_tokens += m - 1
        self.spec_rounds += 1
        self.last_heartbeat = time.monotonic()
        self.journal.append(("spec_verify", {"rid": rid, "drafted": k,
                                             "accepted": m - 1,
                                             "rolled_back": s - m}))
        # commit bookkeeping token-by-token with the step() stop rules:
        # committed tokens are real decode output (counters, streaming
        # hooks, finish); the rolled-back tail never counts toward
        # decode_tokens or max_new
        now = time.monotonic()
        for j, tok in enumerate(commits, start=1):
            if self.slots[slot] is not st:
                break  # a callback cancelled/finished the request
            st.generated.append(tok)
            self.decode_tokens += 1
            if self.on_token is not None:
                self.on_token(st.rid, tok, now)
            if (tok == self.eos_id or len(st.generated) >= st.max_new
                    or p + j + 1 >= cap):
                self._finish_slot(slot, now)
                break
        done = finished or self.slots[slot] is not st
        return {"committed": commits, "accepted": m - 1, "drafted": k,
                "rolled_back": s - m, "finished": done}

    def spec_sync(self, rid: int, committed: List[int]) -> bool:
        """Draft-side absorb of one verify round: replay the target's
        committed tokens into the draft cache in one chunk (the old pending
        token + all but the last commit), making the final commit the new
        pending token. The rejected tail was never installed here, so
        nothing rewinds. Returns False when the draft cache is out of room
        (the caller stops speculating)."""
        slot = self.spec_slot(rid)
        if slot is None:
            return False
        st = self.slots[slot]
        committed = [int(t) % self.cfg.vocab_size for t in committed]
        m = len(committed)
        if m == 0:
            return True
        p = int(self.positions[slot])
        if p + m + 1 >= self.serving.max_seq:
            return False
        dev = self.device
        feed = np.asarray([int(st.generated[-1])] + committed[:-1], np.int32)
        poss = p + np.arange(m, dtype=np.int32)
        batch = {"tokens": torch.as_tensor(feed[None], device=dev),
                 "positions": torch.as_tensor(poss[None], device=dev)}
        teff = self._spec_teff(p + m + 1)
        cache1 = self._spec_cache1(slot)
        if self._sliceable:
            _, cache1 = self.model.decode_chunk(
                self.params, cache1, batch,
                ctx=(teff if teff < self.serving.max_seq else None))
        else:
            self._refuse_unchunked()
            _, cache1 = self.model.decode_chunk_recurrent(self.params, cache1,
                                                          batch)
        self._insert_cache(cache1, slot)
        st.generated.extend(committed)
        self.positions[slot] = p + m
        self.journal.append(("spec_sync", {"rid": rid, "tokens": m}))
        return True

    # ------------------------------------------------------------------

    def rids(self) -> List[int]:
        """Every request currently on this engine (queued + in a slot)."""
        out = [j["rid"] for j in self.waiting]
        out.extend(s.rid for s in self.slots if s is not None)
        return out

    def free_slot_count(self) -> int:
        return sum(s is None for s in self.slots)

    def encode_image(self, image: np.ndarray, num_patches: int = 0,
                     frontend_dim: int = 0) -> np.ndarray:
        """Encode-only entry point (executed partial offload): run the
        vision stub on THIS tier's device and return patch embeddings in
        the target ``(num_patches, frontend_dim)`` geometry (defaults to
        this engine's own model). The stub tiles the normalized pixels into
        the patch grid, the same values a fusion-local prefill computes."""
        img = np.asarray(image)
        p = num_patches or self.cfg.num_patches
        fd = frontend_dim or self.cfg.frontend_dim
        need = p * fd
        rep = max(1, int(np.ceil(need / max(img.size, 1))))
        x = torch.as_tensor(img, device=self.device)
        # times the reciprocal, as XLA rewrites the reference's x / 255
        flat = x.reshape(-1).to(torch.float32) * (1.0 / 255.0)
        out = flat.repeat(rep)[:need].reshape(p, fd).cpu().numpy()
        self.encode_tokens += p
        self.journal.append(("encode", {"patches": p}))
        return out

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    # -- paged KV pool ------------------------------------------------------

    def _page_need(self, total_rows: int) -> int:
        """Pages a request occupying ``total_rows`` cache rows reserves.
        Recurrent families charge a fixed per-slot amount (their state has
        no positional pages)."""
        if not self._sliceable:
            return self._slot_page_charge
        return pages_needed(total_rows, self.serving.kv_page_size,
                            self.serving.max_seq)

    def _reserve_pages(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` fresh pages, reclaiming prefix-store LRU entries
        under pressure (store-held pages are spare capacity: a live request
        always beats a cached prefix). None when the pool is truly short."""
        if n <= 0:
            return []
        pool = self.pool
        while not pool.can_alloc(n) and self._pt is not None:
            if self.prefix_store.evict_oldest() is None:
                break
        return pool.alloc(n)

    def _page_starved(self, job: Dict[str, Any]) -> None:
        """``job``, at the head of the queue, found too few free pages:
        admission stops here and the fused block splits at the pressure
        boundary. Its page wait starts now, unless it already waits."""
        self._page_pressure = True
        job.setdefault("_page_wait", time.monotonic_ns())

    def _page_granted(self, job: Dict[str, Any]) -> None:
        """``job`` reserved its pages: a page wait it had ends (counted in
        ``page_waits`` / ``page_wait_s``, recorded as ``engine.page_wait``
        when the tracer is on)."""
        t0 = job.pop("_page_wait", None)
        if t0 is not None:
            self.page_waits += 1
            self.page_wait_s += (time.monotonic_ns() - t0) / 1e9
            tracing.record("engine.page_wait", t0, rid=job["rid"],
                           tier=self.tier)

    def _assign_pages(self, slot: int, pages: List[int]) -> None:
        """Record ``slot``'s page list and host page table. The DEVICE page
        table row is written by the insert path that follows."""
        self._slot_pages[slot] = list(pages)
        if self._pt is not None:
            row = np.zeros((self._n_pt,), np.int32)
            row[:len(pages)] = pages
            self._pt[slot] = row

    def _release_pages(self, slot: int) -> None:
        """Drop ``slot``'s page references (pages whose last reader this was
        rejoin the free list) and retarget its DEVICE page table at the null
        page: a freed slot keeps stepping inside the fused block, and its
        dead writes must never land on a page that may be re-allocated."""
        if self.pool is None:
            return
        if self._slot_pages[slot]:
            self.pool.decref(self._slot_pages[slot])
            self._slot_pages[slot] = []
        if self._pt is not None:
            self._pt[slot] = 0
            self.cache["pages"][slot] = 0

    def kv_gauges(self) -> Dict[str, float]:
        """KV occupancy gauges the scheduler observes: pages_total / free /
        shared + high-water. Dense engines synthesize slot-granular numbers
        so both pool designs report comparable headroom."""
        if self.pool is not None:
            return self.pool.gauges()
        npp = max(1, -(-self.serving.max_seq // self.serving.kv_page_size))
        used = sum(1 for s in self.slots if s is not None)
        self._slots_hw = max(self._slots_hw, used)
        return {"pages_total": len(self.slots) * npp,
                "pages_free": (len(self.slots) - used) * npp,
                "pages_shared": 0,
                "pages_high_water": self._slots_hw * npp,
                "page_bytes": 0.0}

    def kv_headroom(self) -> float:
        """Free fraction of the KV pool in [0, 1]."""
        g = self.kv_gauges()
        return g["pages_free"] / max(1, g["pages_total"])

    def _start_seq(self, job: Dict[str, Any], slot: int, prompt_len: int,
                   first_logits: np.ndarray,
                   prefill_count: Optional[int] = None,
                   warm: Optional[tuple] = None) -> None:
        """Shared admit bookkeeping: first token, done-check, journal.
        ``prefill_count`` overrides the prefill-token charge (a warm admit
        prefilled only its suffix); ``warm`` = (kind, cached_tokens) tags
        prefix-hit / resumed-session admissions."""
        st = SeqState(rid=job["rid"], prompt_len=prompt_len,
                      max_new=job["max_new"], t_submit=job["t"],
                      session=job.get("session"))
        self._slot_prompt[slot] = np.asarray(job["tokens"], np.int32)
        self._slot_extras_fp[slot] = (
            self._job_fp(job)
            if (st.session and self.sessions.enabled)
            or self.prefix_store.enabled else b"")
        first = self._sample(first_logits, slot, st.rid, prompt_len - 1)
        st.generated.append(int(first))
        st.t_first_token = time.monotonic()
        self.slots[slot] = st
        self.positions[slot] = prompt_len
        charged = prompt_len if prefill_count is None else prefill_count
        self.prefill_tokens += charged
        self.decode_tokens += 1
        if warm is not None:
            kind, cached = warm
            if kind == "resume":
                self.resumed_sessions += 1
                self.resumed_tokens += cached
            else:
                self.prefix_hits += 1
                self.prefix_hit_tokens += cached
            self.journal.append(("warm", {"rid": st.rid, "kind": kind,
                                          "cached": cached,
                                          "suffix": charged}))
            if self.on_warm is not None:
                self.on_warm(st.rid, kind, cached, charged)
        self.journal.append(("admit", {"rid": st.rid, "slot": slot}))
        if self.on_admit is not None:
            self.on_admit(st.rid, st.t_first_token)
        if self.on_token is not None:
            self.on_token(st.rid, int(first), st.t_first_token)
        self._store_prefixes(slot, job)
        # a request may be complete straight out of prefill (EOS first
        # token, max_new == 1, or a prompt already at capacity)
        if (first == self.eos_id or len(st.generated) >= st.max_new
                or prompt_len + 1 >= self.serving.max_seq):
            self._finish_slot(slot, time.monotonic())

    def _finish_slot(self, slot: int, now: float) -> None:
        st = self.slots[slot]
        st.done = True
        st.t_done = now
        self._park(slot, st)  # while the slot's cache rows are intact
        self.finished.append(st)
        self.journal.append(("finish", {"rid": st.rid}))
        self.slots[slot] = None
        self._release_pages(slot)

    def _prompt_prefix(self, extras: Dict[str, Any]) -> int:
        if self.cfg.frontend == "vision_stub" and "patches" in extras:
            return self.cfg.num_patches
        return 0

    def _device_batch(self, toks: np.ndarray, extras: Dict[str, Any]
                      ) -> Dict[str, torch.Tensor]:
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                           device=self.device)}
        for k, v in extras.items():
            batch[k] = torch.as_tensor(np.asarray(v), device=self.device)
        return batch

    # -- admission ----------------------------------------------------------

    def _admit(self) -> None:
        # page pressure is re-evaluated every admission pass: pages freed by
        # finished slots (or store eviction) clear it, a starved reservation
        # below re-raises it and the next fused block splits early
        self._page_pressure = False
        if any(j.get("deadline") is not None for j in self.waiting):
            # EDF admission: earliest deadline first, FIFO among ties /
            # deadline-free requests (stable sort keeps submit order)
            self.waiting.sort(key=lambda j: (
                j["deadline"] if j.get("deadline") is not None
                else float("inf"), j["t"]))
        # warm admissions first (EDF order within them): a prompt extending
        # a parked session or a stored prefix reuses the cached rows and
        # prefills only its suffix; everything else falls through cold
        if self.waiting and (self.sessions.enabled
                             or self.prefix_store.enabled):
            self._admit_warm_hits()
        if self.fused_steps <= 1 or not self.serving.bucket_prefill:
            self._admit_legacy()
        else:
            self._admit_bucketed()

    def _admit_legacy(self) -> None:
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                return
            job = self.waiting[0]  # peek: only admitted once pages reserve
            if self.pool is not None:
                vis = self._prompt_prefix(job["extras"])
                total = min(vis + len(job["tokens"]) + int(job["max_new"]),
                            self.serving.max_seq)
                pages = self._reserve_pages(self._page_need(total))
                if pages is None:
                    self._page_starved(job)
                    return
                self._page_granted(job)
                self._assign_pages(slot, pages)
            job = self.waiting.pop(0)
            toks = np.asarray(job["tokens"])[None]  # (1, S)
            batch = self._device_batch(toks, {k: np.asarray(v)[None] for k, v
                                              in job["extras"].items()})
            prefix = self._prompt_prefix(batch)
            if self._pt is not None:
                logits = self._prefill_insert(
                    batch, np.asarray([slot]),
                    np.asarray([toks.shape[1] + prefix]), self._pt[[slot]],
                    len(self._slot_pages[slot]))
            else:
                logits, cache1 = self.model.prefill(self.params, batch,
                                                    self.serving.max_seq)
                self._insert_cache(cache1, slot)
            self._start_seq(job, slot, toks.shape[1] + prefix,
                            logits.float().cpu().numpy()[0])

    def _admit_bucketed(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.waiting:
            return
        jobs = self.waiting[:len(free)]
        if self.pool is not None:
            # eager reservation: each job reserves its FULL page budget
            # (prompt + max_new, capped) up front, so an admitted request
            # can always run to completion. Starved jobs stay queued; the
            # fused block splits at the pressure boundary.
            admitted = []
            for job in jobs:
                vis = self._prompt_prefix(job["extras"])
                total = min(vis + len(job["tokens"]) + int(job["max_new"]),
                            self.serving.max_seq)
                pages = self._reserve_pages(self._page_need(total))
                if pages is None:
                    self._page_starved(job)
                    break
                self._page_granted(job)
                job["_pages"] = pages
                admitted.append(job)
            jobs = admitted
            if not jobs:
                return
        del self.waiting[:len(jobs)]
        pad_ok = self.cfg.family in _PADDED_FAMILIES
        groups: Dict[tuple, List[dict]] = {}
        for j, job in enumerate(jobs):
            n = len(job["tokens"])
            prefix = self._prompt_prefix(job["extras"])
            if pad_ok:
                bucket = min(_next_bucket(n),
                             max(n, self.serving.max_seq - prefix))
            else:
                bucket = n  # exact-length groups (ssm / hybrid)
            sig = (bucket, tuple(sorted(
                (k, np.asarray(v).shape, str(np.asarray(v).dtype))
                for k, v in job["extras"].items())))
            if self.cfg.family == "moe":
                sig += (j,)  # one group per request (see _PADDED_FAMILIES)
            groups.setdefault(sig, []).append(job)
        for sig, grp in groups.items():
            most = self._group_rows(self._prompt_prefix(grp[0]["extras"])
                                    + sig[0])
            for at in range(0, len(grp), most):
                part = grp[at:at + most]
                slots = [free.pop(0) for _ in part]
                self._admit_group(part, slots, sig[0])

    def _group_rows(self, length: int) -> int:
        """Most rows a prefill group of ``length`` positions (vision prefix
        + bucket) carries: the largest power of two whose rows x length
        stay within the engine's prefill budget (every slot when it has
        none, or when the budget holds them all)."""
        budget = self._prefill_budget()
        rows = 1
        while rows < len(self.slots) and 2 * rows * length <= budget:
            rows *= 2
        return len(self.slots) if rows >= len(self.slots) else rows

    def _prefill_budget(self) -> float:
        """Positions (rows x length) one prefill group may carry. Unless set
        (``prefill_positions``), it is read on the card at the first group,
        once every engine on the device holds its weights and pool: the
        device memory still free (``torch.cuda.mem_get_info`` and the
        allocator's cached, unused blocks) less ``PREFILL_RESERVE``, over
        the activation bytes a prefill holds a position
        (:func:`prefill_bytes_per_position`). Unbounded on the host."""
        if self.prefill_positions is None:
            if self.device.type != "cuda":
                self.prefill_positions = 0
            else:
                free, _ = torch.cuda.mem_get_info(self.device)
                cached = (torch.cuda.memory_reserved(self.device)
                          - torch.cuda.memory_allocated(self.device))
                left = free + cached - PREFILL_RESERVE
                self.prefill_positions = max(
                    1, int(left // prefill_bytes_per_position(self.cfg)))
        return float(self.prefill_positions or "inf")

    def _admit_group(self, jobs: List[dict], slots: List[int],
                     bucket: int) -> None:
        sp = tracing.begin("engine.prefill_group", tier=self.tier)
        stage = tracing.begin("engine.prefill.stage", tier=self.tier)
        r = len(jobs)
        # pad the row count to a power of two as well; pad rows replicate
        # row 0 and scatter to the same slot, so the duplicate writes are
        # identical
        rp = _next_bucket(r, lo=1)
        toks = np.zeros((rp, bucket), np.int32)
        lengths = np.zeros((rp,), np.int32)
        for i in range(rp):
            job = jobs[i] if i < r else jobs[0]
            n = len(job["tokens"])
            toks[i, :n] = job["tokens"]
            lengths[i] = n
        extras = {k: np.stack([np.asarray((jobs[i] if i < r else jobs[0])
                                          ["extras"][k]) for i in range(rp)])
                  for k in jobs[0]["extras"]}
        batch = self._device_batch(toks, extras)
        if int(lengths.min()) < bucket:  # any row right-padded
            batch["lengths"] = torch.as_tensor(lengths, device=self.device)
        prefix = self._prompt_prefix(jobs[0]["extras"])
        total = lengths + prefix
        for job, slot in zip(jobs, slots):
            pages = job.pop("_pages", None)
            if pages is not None:
                self._assign_pages(slot, pages)
        slots_arr = np.asarray(slots + [slots[0]] * (rp - r), np.int32)
        tracing.end(stage)
        issue = tracing.begin("engine.prefill.issue", tier=self.tier)
        kv_pages = 0
        if self._pt is not None:
            # pad rows replicate row 0's page table too
            pt_rows = self._pt[slots_arr]
            kv_pages = sum(len(self._slot_pages[s]) for s in slots)
            npg = max(1, max(len(self._slot_pages[s]) for s in slots))
            logits = self._prefill_insert(batch, slots_arr, total, pt_rows,
                                          npg)
        else:
            logits = self._prefill_insert(batch, slots_arr, total)
        tracing.end(issue)
        sync = tracing.begin("engine.prefill.sync", tier=self.tier)
        logits = logits.float().cpu().numpy()  # one host sync per group
        tracing.end(sync)
        start = tracing.begin("engine.prefill.start", tier=self.tier)
        for i, (job, slot) in enumerate(zip(jobs, slots)):
            self._start_seq(job, slot, int(total[i]), logits[i])
        tracing.end(start)
        if sp:
            tracing.end(sp, bucket=bucket, rows_padded=rp, rows=[
                (j["rid"], len(j["tokens"]), "patches" in j["extras"],
                 j["t"]) for j in jobs],
                kv_pages=kv_pages)

    # -- sampling / stepping ------------------------------------------------

    def _sample(self, logits: np.ndarray, slot: int, rid: int,
                position: int) -> int:
        """One token from host logits (the first token after a prefill):
        argmax at temperature 0, else the slot's keyed draw at
        ``position``, the position of the token these logits follow."""
        if self.temp <= 0:
            return int(np.argmax(logits))
        return int(keyed_sample(
            torch.as_tensor(logits)[None], torch.as_tensor(
                self._keys[slot:slot + 1].astype(np.int64)),
            torch.tensor([rid]), torch.tensor([position]), self.temp)[0])

    def _throttle_sleep(self, t_in: float) -> None:
        if self.throttle > 1.0:
            time.sleep(min((self.throttle - 1.0)
                           * max(0.0, time.monotonic() - t_in),
                           self.throttle_sleep_cap_s))

    def step(self) -> int:
        """Admit + one decode block for all active slots. Returns #active."""
        sp = tracing.begin("engine.step", tier=self.tier)
        t_in = time.monotonic()
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            tracing.end(sp)
            return 0
        if self.fused_steps <= 1:
            n = self._step_legacy(active)
            self._throttle_sleep(t_in)
            tracing.end(sp)
            return n
        b = len(self.slots)
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        budgets = np.zeros((b,), np.int32)
        rids = np.zeros((b,), np.int64)
        for i in active:
            st = self.slots[i]
            tokens[i] = st.generated[-1]
            positions[i] = self.positions[i]
            budgets[i] = max(0, st.max_new - len(st.generated))
            rids[i] = st.rid
        k = self.fused_steps
        if self.pool is not None and self._page_pressure and self.waiting:
            # continuous admission under page pressure: split the fused
            # block at the earliest point a slot can finish (and free its
            # pages), so starved requests admit mid-block
            rem = min(max(1, self.slots[i].max_new
                          - len(self.slots[i].generated)) for i in active)
            k = max(1, min(k, rem))
        teff = self.serving.max_seq
        if self._ctx_buckets:
            # smallest bucket covering every position the block can write
            teff = self._context_bucket(int(positions.max()) + k + 1)
        block = self._fused(tokens, positions, budgets, teff, k, rids)
        emit = tracing.begin("engine.emit", tier=self.tier)
        now = time.monotonic()
        for i in active:
            st = self.slots[i]
            if st is None:
                continue  # cancelled mid-block by an on_token callback
            for j in range(k):
                nxt = int(block[i, j])
                st.generated.append(nxt)
                self.decode_tokens += 1
                self.positions[i] += 1
                if self.on_token is not None:
                    self.on_token(st.rid, nxt, now)
                hit_cap = self.positions[i] + 1 >= self.serving.max_seq
                if (nxt == self.eos_id or len(st.generated) >= st.max_new
                        or hit_cap):
                    self._finish_slot(i, now)
                    break
        tracing.end(emit)
        self.steps += 1
        self.last_heartbeat = now
        self._throttle_sleep(t_in)
        tracing.end(sp)
        return len(active)

    def _step_legacy(self, active: List[int]) -> int:
        """Per-token path: one decode call + one logits transfer per token."""
        b = len(self.slots)
        tokens = np.zeros((b, 1), np.int32)
        positions = np.zeros((b,), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].generated[-1]
            positions[i] = self.positions[i]
        logits, self.cache = self.model.decode_step(
            self.params, self.cache,
            {"tokens": torch.as_tensor(tokens, device=self.device),
             "positions": torch.as_tensor(positions, device=self.device)})
        logits = logits.float().cpu().numpy()
        now = time.monotonic()
        for i in active:
            st = self.slots[i]
            if st is None:
                continue  # cancelled mid-step
            nxt = self._sample(logits[i], i, st.rid, int(self.positions[i]))
            self.positions[i] += 1
            st.generated.append(nxt)
            self.decode_tokens += 1
            if self.on_token is not None:
                self.on_token(st.rid, nxt, now)
            hit_cap = self.positions[i] + 1 >= self.serving.max_seq
            if (nxt == self.eos_id or len(st.generated) >= st.max_new
                    or hit_cap):
                self._finish_slot(i, now)
        self.steps += 1
        self.last_heartbeat = now
        return len(active)

    def run_until_drained(self, max_steps: int = 100_000) -> List[SeqState]:
        while (self.waiting or any(s is not None for s in self.slots)):
            if self.steps >= max_steps:
                break
            self.step()
        return self.finished

    # -- fault tolerance ----------------------------------------------------

    def heartbeat_ok(self) -> bool:
        dt = time.monotonic() - self.last_heartbeat
        self.healthy = dt <= self.serving.heartbeat_timeout_s or self.steps == 0
        return self.healthy

    @staticmethod
    def _copy_seq(s: Optional[SeqState]) -> Optional[SeqState]:
        # generated must be deep-copied: a shallow replace() would alias the
        # live list, letting post-snapshot tokens leak into the snapshot
        return (dataclasses.replace(s, generated=list(s.generated))
                if s else None)

    def snapshot(self) -> dict:
        """Host copy of the engine state (cache, slots, queue, per-slot
        sampling keys, prompts, page ownership)."""
        out = {
            "cache": _tree_map(lambda t: t.detach().to("cpu", copy=True),
                               self.cache),
            "slots": [self._copy_seq(s) for s in self.slots],
            "positions": self.positions.copy(),
            "waiting": list(self.waiting),
            "steps": self.steps,
            "keys": self._keys.copy(),
            "slot_prompt": [None if p is None else p.copy()
                            for p in self._slot_prompt],
            "slot_fp": list(self._slot_extras_fp),
        }
        if self.pool is not None:
            out["paged"] = {
                "pt": None if self._pt is None else self._pt.copy(),
                "slot_pages": [list(p) for p in self._slot_pages],
                "high_water": self.pool.high_water,
            }
        return out

    def restore(self, snap: dict) -> None:
        self.cache = _tree_map(lambda t: t.to(self.device, copy=True),
                               snap["cache"])
        self.slots = [self._copy_seq(s) for s in snap["slots"]]
        self.positions = snap["positions"].copy()
        self.waiting = list(snap["waiting"])
        self.steps = snap["steps"]
        if "keys" in snap:
            self._keys = np.asarray(snap["keys"], np.uint32).copy()
        b = len(self.slots)
        self._slot_prompt = [None if p is None else p.copy()
                             for p in snap.get("slot_prompt", [None] * b)]
        self._slot_extras_fp = list(snap.get("slot_fp", [b""] * b))
        if self.pool is not None:
            # prefix-store entries hold page refs into the PRE-failure pool;
            # drain them first (decrefs fire against the old pool), then
            # derive a fresh allocator from the snapshot's ownership lists
            while self.prefix_store.evict_oldest() is not None:
                pass
            pv = snap.get("paged") or {}
            self._slot_pages = [list(p) for p in
                                pv.get("slot_pages",
                                       [[] for _ in self.slots])]
            old = self.pool
            self.pool = PagePool(self.serving.pool_pages,
                                 self.serving.kv_page_size,
                                 page_bytes=old.page_bytes)
            self.pool.reown([p for sp in self._slot_pages for p in sp])
            self.pool.high_water = max(self.pool.high_water,
                                       int(pv.get("high_water", 0)))
            if self._pt is not None:
                self._pt = (np.zeros_like(self._pt) if pv.get("pt") is None
                            else np.asarray(pv["pt"], np.int32).copy())
        self.healthy = True
        self.last_heartbeat = time.monotonic()
