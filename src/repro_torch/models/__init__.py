"""Model zoo entry point. Counterpart of ``repro/models/__init__.py``."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.config import ModelConfig, ShardingConfig


def build_model(cfg: ModelConfig, attn_impl: str = "auto",
                param_dtype: str = "", decode_impl: str = "auto",
                device: Union[str, torch.device] = "cuda",
                moe_impl: str = "auto",
                sharding: ShardingConfig = ShardingConfig(), mesh=None):
    """Construct the family-appropriate model on ``device`` (default
    ``cuda``; raises when no card is present), or on ``mesh`` (a
    ``DeviceMesh``; the model's device is then its device type):
    ``EncDecLM`` for ``encdec``, ``DecoderLM`` for every other family of
    the zoo. Of ``sharding``, ``remat_policy`` is read (by ``loss``) and,
    on a mesh, ``sequence_parallel``."""
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg, attn_impl=attn_impl, param_dtype=param_dtype,
                        decode_impl=decode_impl, device=device,
                        sharding=sharding, mesh=mesh)
    from repro_torch.models.transformer import FAMILIES, DecoderLM

    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not a family of the model zoo "
            f"(encdec, {', '.join(FAMILIES)})")
    return DecoderLM(cfg, attn_impl=attn_impl, param_dtype=param_dtype,
                     decode_impl=decode_impl, device=device,
                     moe_impl=moe_impl, sharding=sharding, mesh=mesh)
