"""Analytic parameter counts (exact: derived from the same spec trees that
drive init/sharding). Used by the cost model and MODEL_FLOPS = 6·N·D."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.spec import count_tree, is_spec


def _specs(cfg: ModelConfig):
    from repro_torch.models import build_model

    # specs allocate nothing; the device only satisfies the constructor
    return build_model(cfg, device="cpu").specs()


def count_params(cfg: ModelConfig) -> int:
    return count_tree(_specs(cfg))


def count_active_params(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top_k + shared experts only)."""
    if not cfg.num_experts:
        return count_params(cfg)
    specs = _specs(cfg)
    total = count_tree(specs)
    moe = specs["blocks"]["moe"]
    expert_tree = {"wi": moe["wi"], "wo": moe["wo"]}
    if "wg" in moe:
        expert_tree["wg"] = moe["wg"]
    per_layer_expert = count_tree(expert_tree)
    n_layers = moe["wi"].shape[0]
    per_expert = per_layer_expert // n_layers // cfg.num_experts
    inactive = (cfg.num_experts - cfg.top_k) * per_expert * n_layers
    return total - inactive


def embedding_params(cfg: ModelConfig) -> int:
    specs = _specs(cfg)
    n = count_tree({"embed": specs["embed"]})
    if "unembed" in specs:
        n += count_tree({"unembed": specs["unembed"]})
    return n
