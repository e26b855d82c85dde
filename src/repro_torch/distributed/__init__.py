from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    logical_constraint,
    param_shardings,
    spec_to_pspec,
)
