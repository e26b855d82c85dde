"""Reduced configurations and traffic for the CPU tests: a cell's own
file with every tier cut to a two-layer model of width 128, so that a
whole run (set-up, window, drain, reference) takes seconds on the host.
The vocabulary stays above the traffic's word ids."""
from __future__ import annotations

import copy
from typing import Dict

from moabench import spec

SMALL_MODEL = {"num_hidden_layers": 2, "hidden_size": 128,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "head_dim": 32, "intermediate_size": 256,
               "vocab_size": 32_064,
               "vision_config": {"num_patches": 16, "frontend_dim": 64}}


#: traffic for the CPU tests: few small images, a short warm-up, short
#: answers (so that a closed loop finishes requests within a second), and
#: 8 clients
SMALL_TRAFFIC = {"image": {"pool": 6, "side_min": 40, "side_span": 60,
                           "side_beta": [2.0, 2.0], "content_beta": [1.6, 1.6]},
                 "warm": {"requests": 2, "spread_s": 0.05},
                 "output": {"dist": "uniform", "min": 8, "max": 24},
                 "clients": 8, "drain_s": 5.0}


def small_config(cell_name: str, dtype: str = "float32",
                 max_batch: int = 4) -> Dict:
    cfg = copy.deepcopy(spec.config(spec.cell(cell_name)["config"]))
    cfg["dtype"] = dtype
    cfg["attn_impl"] = "torch"  # the flash kernel's plain version
    cfg["serving"] = dict(cfg["serving"], max_batch=max_batch, max_seq=2048,
                          kv_page_size=64)
    for tier in cfg["tiers"]:
        # untied, so that the small models' logits spread as wide as the
        # full ones' do and a broken path's tokens stand out
        tier["model"] = dict(tier["model"], **SMALL_MODEL,
                             tie_word_embeddings=False)
        tier.pop("serving", None)
    return cfg
