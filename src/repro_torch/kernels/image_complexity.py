"""Image-complexity statistics and scores (paper §3.1.1): the CUDA kernel
``csrc/image_stats.cu`` and its plain PyTorch versions.

Replaces ``repro/kernels/image_complexity.py::image_stats_pallas``. One pass
over each image gives the raw statistics the modality-aware module needs:
the Sobel gradient-magnitude sum (edge density, Eq. 2), the Laplacian sum
and sum of squares (sharpness variance, Eq. 4) and the 256-bin gray
histogram (entropy texture, Eq. 3). The TPU kernel built the histogram as a
one-hot matrix product because the TPU has no atomics; the Hopper kernel
counts with shared-memory integer atomics, so its histogram is exact. The
same launch also turns the statistics into the five scores (the epilogue
``ops.image_complexity_from_stats`` computes), in the last block of each
image, so scoring a request is one launch into one allocation.

The kernel splits each image into bands of rows (:func:`image_stats_grid`);
:func:`image_stats_banded_plain` is that arithmetic in PyTorch (the same
bands, a float64 partial per band, the merge in band order, the f32
epilogue with a fixed-tree entropy sum), and :func:`image_stats_plain` the
oracle.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ComplexityConfig
from repro_torch.kernels import runtime

HIST_BINS = 256
#: floats of output an image: stats (4), histogram (256), scores (5)
N_OUT = 4 + HIST_BINS + 5
#: bytes of one band's partial in the workspace: 3 doubles padded to 32
#: bytes, then 256 int bins
SLOT_BYTES = 32 + 4 * HIST_BINS
#: blocks the band height aims at: two blocks of 256 threads (what the
#: kernel's registers let stay resident) for each of an H100's 132 SMs
TARGET_BLOCKS = 2 * 132
#: the fewest pixels a band holds (8 rows at 1024 wide), so that a block's
#: fixed cost (its histogram, its slot, its ticket) stays small beside its
#: loads, and a 64x64 image is one block
MIN_BAND_PIXELS = 8192
#: most images in one launch (the grid's y limit)
MAX_BATCH = 65535
#: rows of ticket counters (one row a CUDA stream) made at once
STREAMS_PER_TABLE = 64
SCORE_KEYS = ("c_res", "c_edge", "c_ent", "c_lap", "c_img")


def image_stats_grid(b: int, h: int, w: int) -> Tuple[int, int]:
    """(rows per band, bands per image) of the kernel's grid (bands, b)."""
    min_rows = -(-MIN_BAND_PIXELS // w)
    bands = max(1, min(-(-TARGET_BLOCKS // b), h // min_rows))
    rows = -(-h // bands)
    return rows, -(-h // rows)


def _pixel_terms(img: torch.Tensor):
    """Per-pixel Sobel magnitude, Laplacian and bin of a (B, H, W) f32
    batch, on an edge-padded copy."""
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gx = (p[:, :-2, 2:] + 2.0 * p[:, 1:-1, 2:] + p[:, 2:, 2:]
          - p[:, :-2, :-2] - 2.0 * p[:, 1:-1, :-2] - p[:, 2:, :-2])
    gy = (p[:, 2:, :-2] + 2.0 * p[:, 2:, 1:-1] + p[:, 2:, 2:]
          - p[:, :-2, :-2] - 2.0 * p[:, :-2, 1:-1] - p[:, :-2, 2:])
    mag = torch.sqrt(gx * gx + gy * gy)
    lap = (p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2]
           + p[:, 1:-1, 2:] - 4.0 * img)
    bins = torch.clamp(torch.floor(img), 0, HIST_BINS - 1).long()
    return mag, lap, bins


def _histogram(bins: torch.Tensor) -> torch.Tensor:
    b = bins.shape[0]
    hist = torch.zeros((b, HIST_BINS), dtype=torch.float32,
                       device=bins.device)
    hist.scatter_add_(1, bins.reshape(b, -1),
                      torch.ones((b, bins[0].numel()), dtype=torch.float32,
                                 device=bins.device))
    return hist


def image_stats_plain(imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Plain PyTorch statistics. imgs: (B, H, W) float in [0, 255].

    Returns {"sobel_sum": (B,), "lap_sum": (B,), "lap_sq_sum": (B,),
    "hist": (B, 256)}, all float32."""
    mag, lap, bins = _pixel_terms(imgs.float())
    return {"sobel_sum": mag.sum(dim=(1, 2)), "lap_sum": lap.sum(dim=(1, 2)),
            "lap_sq_sum": (lap * lap).sum(dim=(1, 2)),
            "hist": _histogram(bins)}


@functools.lru_cache(maxsize=16)
def _consts(cc: ComplexityConfig, h: int, w: int) -> Tuple[float, ...]:
    """The epilogue's constants as ``image_complexity_from_stats`` rounds
    them to f32: edge_p5, edge_p95 - edge_p5 + eps, lap_p5,
    lap_p95 - lap_p5 + eps, c_res, the four weights, log(256)."""
    n = float(h * w)
    vals = (cc.edge_p5, cc.edge_p95 - cc.edge_p5 + cc.eps, cc.lap_p5,
            cc.lap_p95 - cc.lap_p5 + cc.eps,
            min(1.0, n / float(cc.ref_h * cc.ref_w)), cc.w_res, cc.w_edge,
            cc.w_ent, cc.w_lap, math.log(256.0))
    return tuple(float(torch.tensor(v, dtype=torch.float32)) for v in vals)


def _epilogue(stats: Dict[str, torch.Tensor], h: int, w: int,
              cc: ComplexityConfig) -> Dict[str, torch.Tensor]:
    """The kernel's f32 epilogue: the order of operations of
    ``ops.image_complexity_from_stats``, the entropy's 256 bin terms summed
    as the kernel sums them (a butterfly over each 32 bins, then the eight
    sums in order)."""
    (edge_p5, edge_den, lap_p5, lap_den, c_res, w_res, w_edge, w_ent, w_lap,
     log256) = _consts(cc, h, w)
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    n = f32(float(h * w))
    c_edge = torch.clamp((stats["sobel_sum"] / n - edge_p5) / f32(edge_den),
                         0.0, 1.0)
    lap_mean = stats["lap_sum"] / n
    lap_var = stats["lap_sq_sum"] / n - lap_mean * lap_mean
    c_lap = torch.clamp((lap_var - lap_p5) / f32(lap_den), 0.0, 1.0)
    p = stats["hist"] / n
    terms = torch.where(p > 0, p * torch.log(torch.where(p > 0, p, 1.0)),
                        torch.zeros_like(p))
    terms = terms.reshape(*terms.shape[:-1], HIST_BINS // 32, 32)
    while terms.shape[-1] > 1:  # a warp's butterfly, as lane 0 sees it
        half = terms.shape[-1] // 2
        terms = terms[..., :half] + terms[..., half:]
    ent = terms[..., 0, 0]
    for w in range(1, HIST_BINS // 32):  # the warp sums in order
        ent = ent + terms[..., w, 0]
    c_ent = -ent / f32(log256)
    c_res_t = torch.full_like(c_edge, c_res)
    c_img = ((f32(w_res) * c_res_t + f32(w_edge) * c_edge)
             + f32(w_ent) * c_ent) + f32(w_lap) * c_lap
    return {"c_res": c_res_t, "c_edge": c_edge, "c_ent": c_ent,
            "c_lap": c_lap, "c_img": c_img}


def image_stats_banded_plain(imgs: torch.Tensor,
                             band_rows: Optional[int] = None,
                             cc: ComplexityConfig = ComplexityConfig()
                             ) -> Dict[str, torch.Tensor]:
    """The kernel's arithmetic in PyTorch. imgs: (B, H, W) float in
    [0, 255]; ``band_rows`` defaults to :func:`image_stats_grid`'s.

    Per-pixel terms in f32 as :func:`image_stats_plain` computes them, a
    float64 partial sum and an integer histogram per band of rows (the
    kernel's own order within a band, four pixels in f32 then threads in
    double, is not reproduced), the partials merged in band order, the
    totals rounded to f32, then the scores in f32. Returns the raw
    statistics and the five scores."""
    img = imgs.float()
    b, h, w = img.shape
    rows = band_rows or image_stats_grid(b, h, w)[0]
    mag, lap, bins = _pixel_terms(img)
    terms = (mag.double(), lap.double(), (lap * lap).double())
    totals = [torch.zeros(b, dtype=torch.float64, device=img.device)
              for _ in terms]
    hist = torch.zeros((b, HIST_BINS), dtype=torch.int64, device=img.device)
    for r0 in range(0, h, rows):
        for i, term in enumerate(terms):
            totals[i] = totals[i] + term[:, r0:r0 + rows].sum(dim=(1, 2))
        hist += _histogram(bins[:, r0:r0 + rows]).long()
    stats = {"sobel_sum": totals[0].float(), "lap_sum": totals[1].float(),
             "lap_sq_sum": totals[2].float(), "hist": hist.float()}
    return {**stats, **_epilogue(stats, h, w, cc)}


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = runtime.load("image_stats")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.image_stats_launch.argtypes = [p, i, i, i, i, p, p, p, p, p]
        lib.image_stats_launch.restype = ctypes.c_int
        _argtypes_set = True
    return lib


@functools.lru_cache(maxsize=16)
def _consts_arg(cc: ComplexityConfig, h: int, w: int) -> ctypes.Array:
    return (ctypes.c_float * 10)(*_consts(cc, h, w))


# Ticket counters: each CUDA stream that launches the kernel owns a row of
# TARGET_BLOCKS zeroed counters, one an image (image_stats_grid gives a
# launch of more images one band each, which takes no ticket); the kernel
# leaves them zeroed. Rows come from tables of STREAMS_PER_TABLE rows, made
# and zeroed outside any graph capture; a graph keeps the row of the
# stream it was captured on.
_free_rows: Dict[int, list] = {}
_stream_rows: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(dev: torch.device, stream: int) -> int:
    """Address of the counter row of ``stream`` on ``dev``."""
    row = _stream_rows.get((dev.index, stream))
    if row is None:
        free = _free_rows.setdefault(dev.index, [])
        if not free:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "image_stats: a new stream met during a CUDA graph "
                    "capture needs counters zeroed outside it; call the "
                    "kernel once before capturing")
            table = torch.zeros((STREAMS_PER_TABLE, TARGET_BLOCKS),
                                dtype=torch.int32, device=dev)
            torch.cuda.synchronize(dev)  # zeroed before any stream uses it
            free.extend(table.unbind(0))
        row = _stream_rows[(dev.index, stream)] = free.pop()
    return row.data_ptr()


def _launch(imgs: torch.Tensor, cc: ComplexityConfig) -> torch.Tensor:
    """One kernel launch. Returns the flat output: the stats as (4, B)
    (Sobel sum, Laplacian sum, its sum of squares, 0), the histograms as
    (B, 256) and the scores as (5, B), in one buffer that also holds the
    workspace."""
    if imgs.device.type != "cuda":
        raise ValueError(f"image_stats_cuda needs a CUDA tensor, got "
                         f"{imgs.device}")
    if imgs.dtype != torch.float32:
        raise TypeError(f"image_stats_cuda takes float32, got {imgs.dtype}")
    if imgs.dim() != 3 or min(imgs.shape) < 1:
        raise ValueError(f"image_stats_cuda takes (B, H, W), got "
                         f"{tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("image_stats_cuda takes a contiguous batch")
    b, h, w = imgs.shape
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} exceeds the grid's y limit {MAX_BATCH}")
    rows, bands = image_stats_grid(b, h, w)
    out_bytes = -(-4 * b * N_OUT // 16) * 16
    work_bytes = b * bands * SLOT_BYTES if bands > 1 else 0
    dev = imgs.device
    buf = torch.empty((out_bytes + work_bytes) // 4, dtype=torch.float32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = buf.data_ptr()
    counters = _counters(dev, stream) if bands > 1 else 0
    err = _lib().image_stats_launch(
        imgs.data_ptr(), b, h, w, rows, _consts_arg(cc, h, w), counters,
        ptr, ptr + out_bytes, stream)
    runtime.check(err, "image_stats")
    return buf


def _stats(out: torch.Tensor, b: int) -> Dict[str, torch.Tensor]:
    return {"sobel_sum": out[:b], "lap_sum": out[b:2 * b],
            "lap_sq_sum": out[2 * b:3 * b],
            "hist": out[4 * b:(4 + HIST_BINS) * b].view(b, HIST_BINS)}


_DEFAULT_CC = ComplexityConfig()


def image_stats_cuda(imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Launch the CUDA kernel. imgs: (B, H, W) float32, contiguous, on a
    CUDA device. Same outputs as :func:`image_stats_plain`."""
    return _stats(_launch(imgs, _DEFAULT_CC), imgs.shape[0])


def image_complexity_cuda(imgs: torch.Tensor,
                          cc: ComplexityConfig = _DEFAULT_CC
                          ) -> Dict[str, torch.Tensor]:
    """§3.1.1 in one launch: the five scores ``c_res, c_edge, c_ent, c_lap,
    c_img`` (B,) and the raw statistics of :func:`image_stats_cuda`."""
    b = imgs.shape[0]
    out = _launch(imgs, cc)
    base = (4 + HIST_BINS) * b
    scores = {k: out[base + i * b:base + (i + 1) * b]
              for i, k in enumerate(SCORE_KEYS)}
    return {**_stats(out, b), **scores}
