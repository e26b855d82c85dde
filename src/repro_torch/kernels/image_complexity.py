"""Image-complexity statistics (paper §3.1.1): the CUDA kernel
``csrc/image_stats.cu`` and its plain PyTorch version.

Replaces ``repro/kernels/image_complexity.py::image_stats_pallas``. One pass
over each image gives the raw statistics the modality-aware module needs:
the Sobel gradient-magnitude sum (edge density, Eq. 2), the Laplacian sum
and sum of squares (sharpness variance, Eq. 4) and the 256-bin gray
histogram (entropy texture, Eq. 3). The TPU kernel built the histogram as a
one-hot matrix product because the TPU has no atomics; the Hopper kernel
counts with shared-memory integer atomics, so its histogram is exact.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime

HIST_BINS = 256


def image_stats_plain(imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Plain PyTorch statistics. imgs: (B, H, W) float in [0, 255].

    Returns {"sobel_sum": (B,), "lap_sum": (B,), "lap_sq_sum": (B,),
    "hist": (B, 256)}, all float32."""
    img = imgs.float()
    b = img.shape[0]
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gx = (p[:, :-2, 2:] + 2.0 * p[:, 1:-1, 2:] + p[:, 2:, 2:]
          - p[:, :-2, :-2] - 2.0 * p[:, 1:-1, :-2] - p[:, 2:, :-2])
    gy = (p[:, 2:, :-2] + 2.0 * p[:, 2:, 1:-1] + p[:, 2:, 2:]
          - p[:, :-2, :-2] - 2.0 * p[:, :-2, 1:-1] - p[:, :-2, 2:])
    mag = torch.sqrt(gx * gx + gy * gy)
    lap = (p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2]
           + p[:, 1:-1, 2:] - 4.0 * img)
    bins = torch.clamp(torch.floor(img), 0, HIST_BINS - 1).long()
    hist = torch.zeros((b, HIST_BINS), dtype=torch.float32, device=img.device)
    hist.scatter_add_(1, bins.reshape(b, -1),
                      torch.ones((b, bins[0].numel()), dtype=torch.float32,
                                 device=img.device))
    return {"sobel_sum": mag.sum(dim=(1, 2)), "lap_sum": lap.sum(dim=(1, 2)),
            "lap_sq_sum": (lap * lap).sum(dim=(1, 2)), "hist": hist}


_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = runtime.load("image_stats")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.image_stats_launch.argtypes = [p, i, i, i, p, p, p, p, p]
        lib.image_stats_launch.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def image_stats_cuda(imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Launch the CUDA kernel. imgs: (B, H, W) float32, contiguous, on a
    CUDA device. Same outputs as :func:`image_stats_plain`."""
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
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's z limit 65535")
    dev = imgs.device
    acc = torch.empty((b, 3), dtype=torch.float64, device=dev)
    hist_i = torch.empty((b, HIST_BINS), dtype=torch.int32, device=dev)
    stats = torch.empty((b, 4), dtype=torch.float32, device=dev)
    hist = torch.empty((b, HIST_BINS), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().image_stats_launch(
        imgs.data_ptr(), b, h, w, acc.data_ptr(), hist_i.data_ptr(),
        stats.data_ptr(), hist.data_ptr(), stream)
    runtime.check(err, "image_stats")
    return {"sobel_sum": stats[:, 0], "lap_sum": stats[:, 1],
            "lap_sq_sum": stats[:, 2], "hist": hist}
