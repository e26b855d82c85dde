"""One-token decode attention: the CUDA kernel ``csrc/decode_attention.cu``
(dense and paged cache) and its plain PyTorch versions.

Replaces ``repro/kernels/decode_attention.py``: ``decode_attention_pallas``
(dense, possibly ring-buffer cache) and ``decode_attention_pallas_paged``
(page-table pool). The plain versions port the XLA paths
``decode_attention_xla`` / ``decode_attention_paged_xla`` of
``repro/models/attention.py`` and define the semantics, masked rows
included: a row whose attended entries are all masked returns the mean of
its value rows (the fill is the finite -1e30).

The paged versions also take ``lens``, a (B,) int32 extent a slot: rows
``t >= min(lens[b], T)`` of slot b are excluded exactly as rows past T are
(weight 0, not in the max, never read by the kernel), so the result equals
slicing the slot's context to its extent; a slot with ``lens[b] == 0``
reads nothing and returns zeros. Without ``lens`` every slot attends its T
rows (and an all-masked one returns the mean of them). The engine's fused
decode step passes the rows each live slot attends and 0 for dead slots,
so the kernel reads only live rows.

Decode attention is bound by the bytes of the KV context it reads. The
kernel splits the context across blocks (flash-decoding): each block reads
its rows once, with 16-byte loads, for all query heads of a KV group, and
a combine kernel merges the splits' partial softmax sums (see the note in
the CUDA source). ``decode_attention_split_plain`` is that split-and-merge
arithmetic in plain PyTorch, for the tests. With extents the kernel's grid
is fixed when the launch is issued (a CUDA graph replays it while the
extents change) and walks a work list of the live rows' splits, whose
length it chooses on the device (:func:`plan_split_rows` is that rule).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import runtime

NEG_INF = -1e30
#: head dims the kernels take natively (every attention config of the zoo)
HEAD_DIMS = (32, 64, 96, 128, 192, 256)
MAX_GROUP = 16  # query heads per KV head the kernel holds
MIN_SPLIT_ROWS, MAX_SPLIT_ROWS = 32, 1024  # context rows per split
MAX_SPLIT_PAGES = 256  # page-table entries a split stages (kMaxSplitPages)
#: with extents: the least rows a split takes (32 and 128 were slower)
PLAN_MIN_ROWS = 64


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos_q: torch.Tensor,
                           pos_cache: torch.Tensor, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k/v_cache: (B, T, K, hd); pos_q: (B,) absolute
    position of the query; pos_cache: (B, T) absolute position per entry
    (-1 = empty). Returns (B, 1, H, hd) in q's dtype.

    Scores and the probability-weighted sum accumulate in f32 over the
    cache's own values (the products of bf16 values are exact in f32)."""
    return _decode_rows(q, k_cache, v_cache, pos_q, pos_cache, window, None)


def _decode_rows(q, k_cache, v_cache, pos_q, pos_cache, window, inside):
    """:func:`decode_attention_plain`; with ``inside`` ((B, T) bool, the
    slots' extents) the rows outside are excluded: -inf scores (weight 0,
    not in the max), and zeros for a slot with no row inside."""
    b, _, h, d = q.shape
    num_kv = k_cache.shape[2]
    qg = q[:, 0].reshape(b, num_kv, h // num_kv, d)
    scale = d ** -0.5
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(k_cache.dtype).float(),
                     k_cache.float()) * scale
    dd = pos_q[:, None] - pos_cache
    ok = (pos_cache >= 0) & (dd >= 0)
    if window is not None:
        ok = ok & (dd < window)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    if inside is not None:
        s = torch.where(inside[:, None, None, :], s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    if inside is not None:  # no row inside: m finite, every p 0
        m = m.clamp(min=NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    w = (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype).float()
    o = torch.einsum("bkgt,btkd->bkgd", w, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def _extent_rows(pos_cache: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(B, T) True where row t lies inside slot b's extent."""
    t = torch.arange(pos_cache.shape[1], device=pos_cache.device)
    return t[None] < lens.to(pos_cache.device).long()[:, None]


def decode_attention_paged_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, pages: torch.Tensor,
                                 pos_q: torch.Tensor, pos_cache: torch.Tensor,
                                 *, window: Optional[int] = None,
                                 lens: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Decode through a page table. k/v_pool: (P, page, K, hd) physical
    pages (page 0 is the engine's null page); pages: (B, NP) int page table
    covering the attended context; pos_cache: (B, T <= NP*page) absolute
    position per logical row; ``lens``: optional (B,) extents (module
    docstring). Gathers each row's context and defers to the dense version
    sliced to T, so paged and dense decode see the same operands."""
    b, np_ = pages.shape
    page = k_pool.shape[1]
    t = pos_cache.shape[1]
    idx = pages.long()
    k_ctx = k_pool[idx].reshape(b, np_ * page, *k_pool.shape[2:])[:, :t]
    v_ctx = v_pool[idx].reshape(b, np_ * page, *v_pool.shape[2:])[:, :t]
    if lens is not None:
        return _decode_rows(q, k_ctx, v_ctx, pos_q, pos_cache, window,
                            _extent_rows(pos_cache, lens))
    return decode_attention_plain(q, k_ctx, v_ctx, pos_q, pos_cache,
                                  window=window)


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos_q: torch.Tensor,
                                 pos_cache: torch.Tensor, *, split_rows: int,
                                 window: Optional[int] = None,
                                 p_dtype: torch.dtype = torch.float32,
                                 lens: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The CUDA kernel's split-context algorithm in plain PyTorch (the
    tests use it; the main path does not). Same arguments and result as
    :func:`decode_attention_plain`.

    The T attended entries are cut into splits of ``split_rows`` rows. Each
    split computes its partial (m, l, acc) over its own rows only, with the
    finite -1e30 fill for masked scores; the partials merge as
    M = max m_s, out = sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s,
    1e-30). The split's unnormalised probabilities P = e^(s - m_s) are
    rounded to ``p_dtype`` before the PV sum (l sums them unrounded): f32
    as in the Pallas body and the kernel's f32 and non-lean bf16 instances,
    bf16 as the lean instances feed P to the tensor cores (see
    :func:`lean_instance`). On a slot whose entries are all masked every
    split has m = -1e30 and weight 1, so the result is the mean of the T
    value rows, as in the unsplit version.

    With ``lens`` (B,), rows of slot b past its extent min(lens[b], T) are
    excluded (weight 0, not in the max), so a split wholly past it has
    l = acc = 0 and adds nothing to the merge, and a slot of extent 0
    returns zeros: the kernel's extent plan, whose splits also start at
    multiples of their length."""
    if split_rows < 1:
        raise ValueError(f"split_rows must be positive, got {split_rows}")
    inside = None if lens is None else _extent_rows(pos_cache, lens)
    b, _, h, d = q.shape
    num_kv = k_cache.shape[2]
    t = pos_cache.shape[1]
    qg = q[:, 0].reshape(b, num_kv, h // num_kv, d).to(k_cache.dtype).float()
    dd = pos_q[:, None] - pos_cache
    ok = (pos_cache >= 0) & (dd >= 0)
    if window is not None:
        ok = ok & (dd < window)
    ms, ls, accs = [], [], []
    for t0 in range(0, t, split_rows):
        t1 = min(t0 + split_rows, t)
        s = torch.einsum("bkgd,btkd->bkgt", qg,
                         k_cache[:, t0:t1].float()) * d ** -0.5
        s = torch.where(ok[:, None, None, t0:t1], s, NEG_INF)
        if inside is not None:
            s = torch.where(inside[:, None, None, t0:t1], s, -torch.inf)
        m = s.amax(dim=-1)
        if inside is not None:  # a split past the extent: m finite, p 0
            m = m.clamp(min=NEG_INF)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p.to(p_dtype).float(),
                                 v_cache[:, t0:t1].float()))
    m = torch.stack(ms)  # (splits, B, K, G)
    w = torch.exp(m - m.amax(dim=0))
    l = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, 1, h, d).to(q.dtype)


def supports(hd: int, group: int) -> bool:
    """True when the kernel takes head dim ``hd`` with ``group`` query heads
    per KV head (dense and paged, float32 and bfloat16); the wrappers raise
    on anything else and never fall back to the plain version."""
    return hd in HEAD_DIMS and 1 <= group <= MAX_GROUP


def lean_instance(hd: int, group: int) -> bool:
    """True where the bf16 kernel runs a "lean" instance (kMaxG * hd/32 >
    32, kMaxG the least of 8 and 16 that holds the group): its PV product
    runs on the tensor cores with the unnormalised P rounded to bf16."""
    max_g = 8 if group <= 8 else MAX_GROUP
    return max_g * (hd // 32) > 32


def split_rows_for(b: int, num_kv: int, t: int, sms: int,
                   page: Optional[int] = None) -> int:
    """Context rows per split for the kernel: the least power of two
    >= MIN_SPLIT_ROWS that gives at most ceil(2 * sms / (b * num_kv))
    splits, so the grid (splits, K, B) holds about two blocks an SM, capped
    at MAX_SPLIT_ROWS (and, paged, at what a split's page-table stage
    holds). A power of two is a multiple or a divisor of any power-of-two
    page, so a split then covers whole pages or lies inside one."""
    want = -(-2 * sms // (b * num_kv))
    cap = MAX_SPLIT_ROWS
    if page is not None:
        cap = min(cap, (MAX_SPLIT_PAGES - 2) * page)
    rows = MIN_SPLIT_ROWS
    while rows * want < t and rows * 2 <= cap:
        rows *= 2
    return rows


def plan_split_rows(extents, num_kv: int, blocks: int, rmin: int,
                    rmax: int) -> int:
    """The kernel's split length with extents (``plan_rows`` in the CUDA
    source, which finds it by doubling and halving): ``rmin`` if its
    (slot, KV head, split) items of the extents (each clamped to T by the
    caller) fit the ``blocks`` of the grid, else the least multiple of 32
    rows above it that fits, else ``rmax``."""
    def fits(r):
        return num_kv * sum(-(-int(e) // r) for e in extents) <= blocks

    if fits(rmin):
        return rmin
    return next((r for r in range(32 * (rmin // 32 + 1), rmax, 32)
                 if fits(r)), rmax)


def plan_blocks(b: int, num_kv: int, t: int, resident: int, rmin: int,
                rmax: int) -> int:
    """The extent launch's grid, one item a block: the ``resident`` blocks
    the card holds at once, but at least the items of splits of ``rmax``
    rows over every slot's T (so the plan always fits) and at most those of
    ``rmin`` rows (the most it can make)."""
    return min(max(resident, b * num_kv * -(-t // rmax)),
               b * num_kv * -(-t // rmin))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_argtypes_set = False
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = runtime.load("decode_attention")
    if not _argtypes_set:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        args = [i] + [p] * 8 + [i] * 9 + [i64] * 8 + [ctypes.c_float, p]
        lib.decode_attention_launch.argtypes = args
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_extent_launch.argtypes = args + [p] + [i] * 2
        lib.decode_attention_extent_launch.restype = ctypes.c_int
        lib.decode_attention_blocks_per_sm.argtypes = [i] * 3
        lib.decode_attention_blocks_per_sm.restype = ctypes.c_int
        _argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def resident_blocks(device_index: int, dtype: torch.dtype, hd: int,
                    group: int) -> int:
    """Blocks of the paged split kernel with extents of (dtype, hd, group)
    the card holds at once: the least grid :func:`plan_blocks` gives."""
    with torch.cuda.device(device_index):
        per_sm = _lib().decode_attention_blocks_per_sm(_DTYPES[dtype], hd,
                                                       group)
    if per_sm <= 0:
        raise RuntimeError(f"decode attention: no occupancy for {dtype} hd "
                           f"{hd} group {group} ({per_sm})")
    return per_sm * _sm_count(device_index)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _rows_aligned(x: torch.Tensor) -> bool:
    """Every row of x (last dim contiguous) starts 16-byte aligned."""
    esz = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        st * esz % 16 == 0 for st, n in zip(x.stride()[:-1], x.shape[:-1])
        if n > 1)


def _check_int(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride on its last dim")


def _check_common(q, k, v, pos_q, pos_cache):
    for name, x in (("q", q), ("k", k), ("v", v), ("pos_q", pos_q),
                    ("pos_cache", pos_cache)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device "
                             f"({q.device}), got {x.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (B, 1, H, hd), got "
                         f"{tuple(q.shape)}")
    b, _, h, hd = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.dim() != 4 or x.shape[3] != hd or x.stride(3) != 1:
            raise ValueError(f"{name} must be (., ., K, {hd}) with unit "
                             f"stride on its last dim, got {tuple(x.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    kh = k.shape[2]
    if h % kh or not supports(hd, h // kh):
        raise ValueError(f"decode attention kernel: head dim {hd} with {h} "
                         f"query heads over {kh} KV heads is not taken (head "
                         f"dims {HEAD_DIMS}, groups of 1-{MAX_GROUP})")
    _check_int("pos_q", pos_q, 1)
    _check_int("pos_cache", pos_cache, 2)
    if pos_q.shape[0] != b or pos_cache.shape[0] != b:
        raise ValueError("pos_q / pos_cache batch differs from q's")
    if pos_cache.shape[1] < 1:
        raise ValueError("empty context")
    return b, h, kh, hd


def _launch(q, k, v, pos_q, pos_cache, pages, window, split_rows, b, h, kh,
            hd, page, lens=None):
    t = pos_cache.shape[1]
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if lens is not None:
        return _launch_extents(q, k, v, pos_q, pos_cache, pages, window,
                               split_rows, b, h, kh, hd, page, lens)
    if split_rows is None:
        split_rows = split_rows_for(b, kh, t, _sm_count(q.device.index),
                                    page if pages is not None else None)
    elif split_rows < 1:
        raise ValueError(f"split_rows must be positive, got {split_rows}")
    if pages is not None and -(-split_rows // page) + 1 > MAX_SPLIT_PAGES:
        raise ValueError(f"a split of {split_rows} rows spans more than "
                         f"{MAX_SPLIT_PAGES} pages of {page}")
    splits = -(-t // split_rows)
    out = torch.empty_like(q)
    ws = (torch.empty(b * h * splits * (hd + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    vec = all(_rows_aligned(x) for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos_q.data_ptr(), pos_cache.data_ptr(),
        pages.data_ptr() if pages is not None else None, out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        b, h, kh, hd, t, page, 0 if window is None else int(window),
        int(split_rows), int(vec),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        pos_cache.stride(0), pages.stride(0) if pages is not None else 0,
        float(hd ** -0.5), stream)
    runtime.check(err, "decode_attention")
    return out


def _launch_extents(q, k, v, pos_q, pos_cache, pages, window, split_rows, b,
                    h, kh, hd, page, lens):
    """The extent launch (paged): a grid of :func:`plan_blocks` blocks;
    splits of PLAN_MIN_ROWS up to the paged cap, or exactly
    ``split_rows``."""
    _check_int("lens", lens, 1)
    if lens.shape[0] != b or lens.device != q.device:
        raise ValueError(f"lens must be ({b},) on {q.device}, got "
                         f"{tuple(lens.shape)} on {lens.device}")
    t = pos_cache.shape[1]
    rmin, rmax = PLAN_MIN_ROWS, MAX_SPLIT_ROWS
    while -(-rmax // page) + 1 > MAX_SPLIT_PAGES:
        rmax //= 2
    if split_rows is not None:
        if split_rows < 1:
            raise ValueError(f"split_rows must be positive, got {split_rows}")
        rmin = rmax = int(split_rows)
        if -(-rmax // page) + 1 > MAX_SPLIT_PAGES:
            raise ValueError(f"a split of {rmax} rows spans more than "
                             f"{MAX_SPLIT_PAGES} pages of {page}")
    rmin = min(rmin, rmax)
    blocks = plan_blocks(b, kh, t, resident_blocks(
        q.device.index, q.dtype, hd, h // kh), rmin, rmax)
    out = torch.empty_like(q)
    ws = torch.empty(blocks * (h // kh) * (hd + 2), dtype=torch.float32,
                     device=q.device)
    vec = all(_rows_aligned(x) for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_extent_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos_q.data_ptr(), pos_cache.data_ptr(), pages.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, h, kh, hd, t, page,
        0 if window is None else int(window), rmax, int(vec),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        pos_cache.stride(0), pages.stride(0), float(hd ** -0.5), stream,
        lens.data_ptr(), rmin, blocks)
    runtime.check(err, "decode_attention")
    return out


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos_q: torch.Tensor,
                          pos_cache: torch.Tensor, *,
                          window: Optional[int] = None,
                          split_rows: Optional[int] = None) -> torch.Tensor:
    """Kernel launch for the dense cache. k/v_cache may be strided views
    (a context-bucket slice or a layer of the stacked cache). ``split_rows``
    forces the context rows per split (None: :func:`split_rows_for`; T or
    more: one split, no combine)."""
    b, h, kh, hd = _check_common(q, k_cache, v_cache, pos_q, pos_cache)
    if k_cache.shape[0] != b or k_cache.shape[1] < pos_cache.shape[1]:
        raise ValueError(f"dense cache {tuple(k_cache.shape)} does not cover "
                         f"pos_cache {tuple(pos_cache.shape)}")
    return _launch(q, k_cache, v_cache, pos_q, pos_cache, None, window,
                   split_rows, b, h, kh, hd, 1)


def decode_attention_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, pages: torch.Tensor,
                                pos_q: torch.Tensor, pos_cache: torch.Tensor,
                                *, window: Optional[int] = None,
                                split_rows: Optional[int] = None,
                                lens: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Kernel launch for the paged pool; rows are found through ``pages``.
    ``split_rows`` as for :func:`decode_attention_cuda`; with ``lens``
    (module docstring) it fixes every split's rows, else the device picks
    them (:func:`plan_split_rows`)."""
    b, h, kh, hd = _check_common(q, k_pool, v_pool, pos_q, pos_cache)
    if pages.device != q.device:
        raise ValueError(f"pages must lie on {q.device}, got {pages.device}")
    _check_int("pages", pages, 2)
    page = k_pool.shape[1]
    if pages.shape[0] != b or pages.shape[1] * page < pos_cache.shape[1]:
        raise ValueError(f"page table {tuple(pages.shape)} x page {page} does "
                         f"not cover pos_cache {tuple(pos_cache.shape)}")
    return _launch(q, k_pool, v_pool, pos_q, pos_cache, pages, window,
                   split_rows, b, h, kh, hd, page, lens)
