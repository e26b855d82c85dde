"""Live continuous-batching serving engine (runs real models). Counterpart
of ``repro/serving/engine.py::TierEngine``, cold serving only.

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
  the longest live context.
* **Bucketed prefill**: waiting prompts are right-padded to power-of-two
  length buckets; all same-bucket requests prefill in ONE batched call and
  scatter into their slots (through the page tables on a paged engine).

``ServingConfig(fused_steps=1)`` keeps the per-token path (host-side numpy
sampling, one sync per token, one prefill per request) for parity testing.

Not in this port yet, each raising ``NotImplementedError`` that names its
ROADMAP item: cross-tier migration (``extract_slot`` / ``inject_slot``),
session park/resume/adopt, warm admission from the prefix store
(``prefix_cache_mb > 0``) and speculative decoding (``spec_*``).

At temperature > 0 the fused path samples from one ``torch.Generator`` per
engine; it does not reproduce the JAX package's per-slot key stream.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, ServingConfig
from repro_torch.serving.paged import PagePool, pages_needed
from repro_torch.serving.prefix import PrefixStore, SessionStore


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


class MigrationError(RuntimeError):
    """A slot payload cannot be extracted or injected: unknown wire version,
    wrong model/family, mismatched cache geometry, or no free slot. Raised
    BEFORE any engine state is mutated, so a failed injection leaves the
    target engine untouched (callers fall back to a fresh prefill)."""


def _np_dtype(name: str) -> np.dtype:
    """Resolve a dtype tag, including the ml_dtypes extras jax uses. An
    unknown tag (corrupt header, sender with newer dtypes) raises
    MigrationError so callers keep their re-prefill fallback."""
    try:
        return np.dtype(name)
    except TypeError:
        try:
            import ml_dtypes  # ships with jax

            return np.dtype(getattr(ml_dtypes, name))
        except (AttributeError, TypeError) as e:
            raise MigrationError(
                f"unknown dtype tag {name!r} in slot payload") from e


@dataclass
class SlotPayload:
    """One request's migratable state: its per-slot cache rows (every leaf
    sliced along that leaf's logical batch axis — dense/vlm/moe KV, ssm
    conv+state, hybrid ring/rglru leaves), its ``SeqState``, the absolute
    next position, and the per-slot sampling key. ``to_bytes``/``from_bytes``
    are the versioned, dtype/shape-tagged wire format the live backend
    actually ships across tiers."""

    version: int
    model: str
    family: str
    max_seq: int
    seq: SeqState
    position: int
    key: np.ndarray  # per-slot jax.random key data
    leaves: Dict[str, np.ndarray]  # keystr(cache path) -> per-slot row
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
        leaf_bytes = [np.ascontiguousarray(self.leaves[n]).tobytes()
                      for n in names]
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
            "leaves": [{"name": n, "dtype": str(self.leaves[n].dtype),
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
            dt = _np_dtype(dtype_s)
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

        # any malformation beyond this point (bad json, missing header
        # fields, bogus shapes) is a corrupt wire, never a crash: callers
        # rely on MigrationError to fall back to a fresh prefill
        try:
            head = json.loads(blob.decode("utf-8"))
            off += hlen
            key = pull(head["key"]["dtype"], head["key"]["shape"],
                       head["key"].get("crc"))
            leaves = {d["name"]: pull(d["dtype"], d["shape"], d.get("crc"))
                      for d in head["leaves"]}
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
        except (KeyError, ValueError, TypeError, OverflowError) as e:
            raise MigrationError(f"corrupt slot payload: {e!r}") from e


_WARM_ITEM = "ROADMAP queue 1, item 8 (warm paths and migration)"
_SPEC_ITEM = "ROADMAP queue 1, item 9 (speculative decoding)"

# cache leaves the paged engine moves into the shared physical pool
_PAGED_LEAVES = ("k", "v")


def _tree_map(fn: Callable, tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


class TierEngine:
    def __init__(self, model, params, serving: ServingConfig = ServingConfig(),
                 eos_id: int = 2, sample_temp: float = 0.0, seed: int = 0):
        if serving.prefix_cache_mb > 0:
            raise NotImplementedError(
                f"warm admission from the prefix store (prefix_cache_mb > 0) "
                f"is not ported yet: {_WARM_ITEM}")
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
        self.rng = np.random.default_rng(seed)
        self.fused_steps = max(1, serving.fused_steps)
        if serving.decode_impl != "auto":
            model.decode_impl = serving.decode_impl

        b, t = serving.max_batch, serving.max_seq
        self.cache = model.init_cache(b, t)
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
        # warm-path and speculation counters: stay 0 in this port
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.resumed_sessions = 0
        self.resumed_tokens = 0
        self.parks = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.spec_rounds = 0
        # cluster-runtime hooks: admission + per-token streaming callbacks
        self.on_admit: Optional[Callable[[int, float], None]] = None
        self.on_token: Optional[Callable[[int, int, float], None]] = None
        self.on_warm: Optional[Callable[[int, str, int, int], None]] = None
        self.on_park: Optional[Callable[[int, str], None]] = None
        # sampling stream of the fused path at temperature > 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # the runtime reads these stores; both stay empty in this port
        self.prefix_store = PrefixStore(0.0,
                                        min_prefix=serving.prefix_min_tokens)
        self.sessions = SessionStore(serving.session_cache_mb * 1e6)

        # -- paged KV pool: the big KV leaves move into a shared physical
        # pool ((L, P, page, K, hd) + an int32 page table per slot)
        self.pool: Optional[PagePool] = None
        self._pt: Optional[np.ndarray] = None  # host page tables (B, n_pt)
        self._slot_pages: List[List[int]] = [[] for _ in range(b)]
        self._page_pressure = False  # set when admission starved for pages
        self._n_pt = 0
        self._slots_hw = 0  # dense-mode occupied-slot high-water (gauges)
        if serving.paged:
            ps = serving.kv_page_size
            self._n_pt = serving.pages_per_slot
            npages = serving.pool_pages + 1  # + pinned null page 0
            page_bytes = 0.0
            blocks = self.cache["blocks"]
            for name in _PAGED_LEAVES:
                leaf = blocks[name]
                n_layers, _, _, kh, hd = leaf.shape
                page_bytes += (n_layers * kh * hd * leaf.element_size()) * ps
                blocks[name] = torch.zeros((n_layers, npages, ps, kh, hd),
                                           dtype=leaf.dtype,
                                           device=self.device)
            self.cache["pages"] = torch.zeros((b, self._n_pt),
                                              dtype=torch.int32,
                                              device=self.device)
            self._pt = np.zeros((b, self._n_pt), np.int32)
            self.pool = PagePool(serving.pool_pages, ps, page_bytes=page_bytes)
        # context buckets need linear cache placement (pos == write index)
        self._ctx_buckets = serving.context_buckets

    # ------------------------------------------------------------------
    # hot-path blocks
    # ------------------------------------------------------------------

    def _fused(self, tokens: np.ndarray, positions: np.ndarray,
               budgets: np.ndarray, teff: int, k_steps: int) -> np.ndarray:
        """``k_steps`` decode steps: decode -> on-device sample -> per-slot
        EOS/budget/cap masking, the cache updated in place. Returns the
        (B, k_steps) token block; the only host sync is its copy.

        ``teff`` is the context bucket: attention reads only the leading
        ``teff`` cache entries (a view; writes and bookkeeping stay full
        width). Valid because placement is linear, every admit rewrites a
        slot's full row (entries past a prompt carry pos=-1), and the
        engine picks ``teff`` above the longest position the block
        reaches."""
        model, params, cache = self.model, self.params, self.cache
        max_seq = int(self.serving.max_seq)
        ctx = teff if teff < max_seq else None
        dev = self.device
        tok = torch.as_tensor(tokens, device=dev)
        pos = torch.as_tensor(positions, device=dev)
        budgets_d = torch.as_tensor(budgets, device=dev)
        alive = budgets_d > 0
        produced = torch.zeros_like(budgets_d)
        bi = torch.arange(tok.shape[0], device=dev)
        out = []
        for _ in range(k_steps):
            idx0 = cache["index"].clone()
            old_pos = cache["pos"][bi, idx0.long()]
            logits, cache = model.decode_step(
                params, cache, {"tokens": tok[:, None], "positions": pos},
                ctx=ctx)
            if self.temp > 0:
                probs = torch.softmax(logits / self.temp, dim=-1)
                sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            else:
                sampled = torch.argmax(logits, dim=-1)
            sampled = sampled.to(torch.int32)
            produced = produced + alive.to(torch.int32)
            pos2 = torch.where(alive, pos + 1, pos)
            # same stop rules the host applies per appended token
            alive2 = (alive & (sampled != self.eos_id) & (produced < budgets_d)
                      & (pos2 + 1 < max_seq))
            tok2 = torch.where(alive, sampled, tok)
            # freeze write bookkeeping of dead slots: their KV writes land
            # on an entry whose pos stays -1 (masked), instead of marching
            # the write index over live-looking entries
            new_pos = cache["pos"][bi, idx0.long()]
            cache["pos"][bi, idx0.long()] = torch.where(alive, new_pos, old_pos)
            cache["index"] = torch.where(alive, cache["index"], idx0)
            tok, pos, alive = tok2, pos2, alive2
            out.append(tok2)
        self.cache = cache
        return torch.stack(out, dim=1).cpu().numpy()

    def _prefill_insert(self, batch: Dict[str, torch.Tensor],
                        slots: np.ndarray, total: np.ndarray,
                        pt_rows: Optional[np.ndarray] = None,
                        npg: int = 0) -> torch.Tensor:
        """Batched prefill + multi-row scatter into the slot pool.

        ``slots`` (R,) are the destination slot ids (duplicates only for pad
        rows carrying identical values); ``total`` (R,) is each row's true
        sequence length INCLUDING any vision prefix. A paged engine passes
        ``pt_rows`` (R, n_pt): the KV leaves scatter THROUGH the tables
        into the pool (only the leading ``npg`` pages, the group's reserved
        high-water; a row's unreserved tail maps to the null page, whose
        garbage is masked via ``pos``)."""
        dev = self.device
        logits, cache1 = self.model.prefill(self.params, batch,
                                            self.serving.max_seq)
        total_d = torch.as_tensor(total, device=dev)
        slots_d = torch.as_tensor(slots, device=dev).long()
        cap = cache1["pos"].shape[1]
        # pad entries carry absolute positions >= the row's true length ->
        # mark empty; the next write lands at the true end
        pos1 = torch.where(cache1["pos"] < total_d[:, None], cache1["pos"], -1)
        idx1 = (torch.clamp(total_d, max=cap) % cap).to(torch.int32)
        c = self.cache
        c["pos"][slots_d] = pos1
        c["index"][slots_d] = idx1
        for name in _PAGED_LEAVES:
            one = cache1["blocks"][name]
            pool = c["blocks"][name]
            if pt_rows is None:
                pool[:, slots_d] = one.to(pool.dtype)
            else:
                n_layers, r, _, kh, hd = one.shape
                page = self.serving.kv_page_size
                one = one.reshape(n_layers, r, self._n_pt, page, kh, hd)
                pt_sl = torch.as_tensor(pt_rows[:, :npg], device=dev).long()
                pool[:, pt_sl] = one[:, :, :npg].to(pool.dtype)
        if pt_rows is not None:
            c["pages"][slots_d] = torch.as_tensor(pt_rows, device=dev)
        return logits

    def _insert_cache(self, cache1: Dict[str, Any], slot: int) -> None:
        """Copy a batch-1 prefill cache into slot ``slot`` (through the page
        table on paged engines; unreserved tail entries land on the null
        page)."""
        c = self.cache
        c["pos"][slot] = cache1["pos"][0]
        c["index"][slot] = cache1["index"][0]
        if self._pt is None:
            for name in _PAGED_LEAVES:
                c["blocks"][name][:, slot] = cache1["blocks"][name][:, 0]
            return
        page = self.serving.kv_page_size
        pt = torch.as_tensor(self._pt[slot], device=self.device)
        for name in _PAGED_LEAVES:
            row = cache1["blocks"][name][:, 0]  # (L, T, K, hd)
            n_layers, _, kh, hd = row.shape
            c["blocks"][name][:, pt.long()] = row.reshape(
                n_layers, self._n_pt, page, kh, hd).to(c["blocks"][name].dtype)
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
        earliest-deadline-first instead of FIFO."""
        if session is not None:
            raise NotImplementedError(
                f"multi-turn sessions are not ported yet: {_WARM_ITEM}")
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

    # -- not ported yet -------------------------------------------------------

    def extract_slot(self, rid: int, *, remove: bool = False) -> SlotPayload:
        raise NotImplementedError(f"KV migration: {_WARM_ITEM}")

    def inject_slot(self, payload: SlotPayload) -> int:
        raise NotImplementedError(f"KV migration: {_WARM_ITEM}")

    def park_session(self, rid: int, sid: Optional[str] = None) -> bool:
        raise NotImplementedError(f"session parking: {_WARM_ITEM}")

    def resume_session(self, sid: str):
        raise NotImplementedError(f"session resume: {_WARM_ITEM}")

    def adopt_session(self, sid: str, payload: SlotPayload) -> bool:
        raise NotImplementedError(f"session adoption: {_WARM_ITEM}")

    def spec_slot(self, rid: int) -> Optional[int]:
        raise NotImplementedError(_SPEC_ITEM)

    def spec_admit_quiet(self, rid: int, tokens: np.ndarray, max_new: int,
                         extras=None) -> Optional[int]:
        raise NotImplementedError(_SPEC_ITEM)

    def spec_set_pending(self, rid: int, token: int) -> None:
        raise NotImplementedError(_SPEC_ITEM)

    def spec_begin(self, rid: int) -> bool:
        raise NotImplementedError(_SPEC_ITEM)

    def spec_release(self, rid: int) -> None:
        raise NotImplementedError(_SPEC_ITEM)

    def spec_draft(self, rid: int, k: int) -> Optional[np.ndarray]:
        raise NotImplementedError(_SPEC_ITEM)

    def spec_verify(self, rid: int, draft) -> Optional[Dict[str, Any]]:
        raise NotImplementedError(_SPEC_ITEM)

    def spec_sync(self, rid: int, committed: List[int]) -> bool:
        raise NotImplementedError(_SPEC_ITEM)

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
        return pages_needed(total_rows, self.serving.kv_page_size,
                            self.serving.max_seq)

    def _reserve_pages(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` fresh pages; None when the pool is short."""
        if n <= 0:
            return []
        return self.pool.alloc(n)

    def _assign_pages(self, slot: int, pages: List[int]) -> None:
        """Record ``slot``'s page list and host page table. The DEVICE page
        table row is written by the insert path that follows."""
        self._slot_pages[slot] = list(pages)
        if self._pt is not None:
            row = np.zeros((self._n_pt,), np.int32)
            row[:len(pages)] = pages
            self._pt[slot] = row

    def _release_pages(self, slot: int) -> None:
        """Drop ``slot``'s page references and retarget its DEVICE page
        table at the null page: a freed slot keeps stepping inside the fused
        block, and its dead writes must never land on a page that may be
        re-allocated."""
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
                   first_logits: np.ndarray) -> None:
        """Shared admit bookkeeping: first token, done-check, journal."""
        st = SeqState(rid=job["rid"], prompt_len=prompt_len,
                      max_new=job["max_new"], t_submit=job["t"],
                      session=job.get("session"))
        first = self._sample(first_logits)
        st.generated.append(int(first))
        st.t_first_token = time.monotonic()
        self.slots[slot] = st
        self.positions[slot] = prompt_len
        self.prefill_tokens += prompt_len
        self.decode_tokens += 1
        self.journal.append(("admit", {"rid": st.rid, "slot": slot}))
        if self.on_admit is not None:
            self.on_admit(st.rid, st.t_first_token)
        if self.on_token is not None:
            self.on_token(st.rid, int(first), st.t_first_token)
        # a request may be complete straight out of prefill (EOS first
        # token, max_new == 1, or a prompt already at capacity)
        if (first == self.eos_id or len(st.generated) >= st.max_new
                or prompt_len + 1 >= self.serving.max_seq):
            self._finish_slot(slot, time.monotonic())

    def _finish_slot(self, slot: int, now: float) -> None:
        st = self.slots[slot]
        st.done = True
        st.t_done = now
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
        # finished slots clear it, a starved reservation below re-raises it
        # and the next fused block splits early
        self._page_pressure = False
        if any(j.get("deadline") is not None for j in self.waiting):
            # EDF admission: earliest deadline first, FIFO among ties /
            # deadline-free requests (stable sort keeps submit order)
            self.waiting.sort(key=lambda j: (
                j["deadline"] if j.get("deadline") is not None
                else float("inf"), j["t"]))
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
                    self._page_pressure = True
                    return
                self._assign_pages(slot, pages)
            job = self.waiting.pop(0)
            toks = np.asarray(job["tokens"])[None]  # (1, S)
            batch = self._device_batch(toks, {k: np.asarray(v)[None] for k, v
                                              in job["extras"].items()})
            logits, cache1 = self.model.prefill(self.params, batch,
                                                self.serving.max_seq)
            self._insert_cache(cache1, slot)
            prefix = self._prompt_prefix(batch)
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
                    self._page_pressure = True
                    break
                job["_pages"] = pages
                admitted.append(job)
            jobs = admitted
            if not jobs:
                return
        del self.waiting[:len(jobs)]
        groups: Dict[tuple, List[dict]] = {}
        for job in jobs:
            n = len(job["tokens"])
            prefix = self._prompt_prefix(job["extras"])
            bucket = min(_next_bucket(n),
                         max(n, self.serving.max_seq - prefix))
            sig = (bucket, tuple(sorted(
                (k, np.asarray(v).shape, str(np.asarray(v).dtype))
                for k, v in job["extras"].items())))
            groups.setdefault(sig, []).append(job)
        for sig, grp in groups.items():
            slots = [free.pop(0) for _ in grp]
            self._admit_group(grp, slots, sig[0])

    def _admit_group(self, jobs: List[dict], slots: List[int],
                     bucket: int) -> None:
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
        if self._pt is not None:
            # pad rows replicate row 0's page table too
            pt_rows = self._pt[slots_arr]
            npg = max(1, max(len(self._slot_pages[s]) for s in slots))
            logits = self._prefill_insert(batch, slots_arr, total, pt_rows,
                                          npg)
        else:
            logits = self._prefill_insert(batch, slots_arr, total)
        logits = logits.float().cpu().numpy()  # one host sync per group
        for i, (job, slot) in enumerate(zip(jobs, slots)):
            self._start_seq(job, slot, int(total[i]), logits[i])

    # -- sampling / stepping ------------------------------------------------

    def _sample(self, logits: np.ndarray) -> int:
        if self.temp <= 0:
            return int(np.argmax(logits))
        z = logits / self.temp
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def _throttle_sleep(self, t_in: float) -> None:
        if self.throttle > 1.0:
            time.sleep(min((self.throttle - 1.0)
                           * max(0.0, time.monotonic() - t_in),
                           self.throttle_sleep_cap_s))

    def step(self) -> int:
        """Admit + one decode block for all active slots. Returns #active."""
        t_in = time.monotonic()
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        if self.fused_steps <= 1:
            n = self._step_legacy(active)
            self._throttle_sleep(t_in)
            return n
        b = len(self.slots)
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        budgets = np.zeros((b,), np.int32)
        for i in active:
            st = self.slots[i]
            tokens[i] = st.generated[-1]
            positions[i] = self.positions[i]
            budgets[i] = max(0, st.max_new - len(st.generated))
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
        block = self._fused(tokens, positions, budgets, teff, k)
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
        self.steps += 1
        self.last_heartbeat = now
        self._throttle_sleep(t_in)
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
            self.positions[i] += 1
            nxt = self._sample(logits[i])
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
        """Host copy of the engine state (cache, slots, queue, sampling
        stream, page ownership)."""
        out = {
            "cache": _tree_map(lambda t: t.detach().to("cpu", copy=True),
                               self.cache),
            "slots": [self._copy_seq(s) for s in self.slots],
            "positions": self.positions.copy(),
            "waiting": list(self.waiting),
            "steps": self.steps,
            "keys": self._gen.get_state(),
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
            self._gen.set_state(snap["keys"])
        if self.pool is not None:
            # derive a fresh allocator from the snapshot's ownership lists
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
