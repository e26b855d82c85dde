from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
from repro_torch.checkpoint.elastic import elastic_restore_tree  # noqa: F401
