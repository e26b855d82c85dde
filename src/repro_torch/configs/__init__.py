"""Architecture registry: the 10 assigned archs + the paper's own edge/cloud pair.

``get_config(name)`` returns the full literature config; ``reduced_config(name)``
returns a CPU-smoke-test-sized config of the same family (small layers/width,
few experts, tiny vocab) — the FULL configs are only exercised via the dry-run.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

# assigned archs (module name == arch id with '-' -> '_')
ASSIGNED_ARCHS: List[str] = [
    "nemotron-4-340b",
    "qwen3-0.6b",
    "deepseek-coder-33b",
    "yi-34b",
    "phi-3-vision-4.2b",
    "whisper-small",
    "kimi-k2-1t-a32b",
    "qwen3-moe-235b-a22b",
    "mamba2-2.7b",
    "recurrentgemma-9b",
]

# paper's own testbed models (§4.1): edge = Qwen2-VL-2B, cloud = Qwen2.5-VL-7B
PAPER_ARCHS: List[str] = ["qwen2-vl-2b", "qwen2.5-vl-7b"]

ALL_ARCHS = ASSIGNED_ARCHS + PAPER_ARCHS

_cache: Dict[str, ModelConfig] = {}


def _modname(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    if name in _cache:
        return _cache[name]
    if name == "tiny-dense":  # default smoke model for the trainer
        cfg = ModelConfig(
            name="tiny-dense", family="dense", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=2, d_ff=384, vocab_size=512,
        )
        _cache[name] = cfg
        return cfg
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_modname(name)}")
    cfg = mod.CONFIG
    assert cfg.name == name, (cfg.name, name)
    _cache[name] = cfg
    return cfg


def list_archs() -> List[str]:
    return list(ALL_ARCHS)


def reduced_config(name: str) -> ModelConfig:
    """Shrink a full config to CPU-smoke size, preserving the family shape."""
    cfg = get_config(name)
    kw = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=32,
        d_ff=0 if cfg.family == "ssm" else 256,
        vocab_size=512,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=2, moe_d_ff=64,
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.block_pattern:
        kw.update(block_pattern=cfg.block_pattern, local_window=32, lru_width=0,
                  num_layers=3)  # one full pattern repeat
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=32)
    if cfg.frontend != "none":
        kw.update(num_patches=8, frontend_dim=48)
    # keep per-family kv ratios sane under the reduction
    if cfg.num_kv_heads == cfg.num_heads:  # MHA stays MHA
        kw["num_kv_heads"] = kw["num_heads"]
    return dataclasses.replace(cfg, **kw)


def iter_dryrun_cells():
    """Yield (arch, shape_name, skip_reason|None) for all 40 assigned cells."""
    from repro_torch.config import applicable_shapes

    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape_name, reason in applicable_shapes(cfg).items():
            yield arch, shape_name, reason
