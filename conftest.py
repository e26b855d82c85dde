"""How every test process runs torch: one intra-op thread, f32 matmuls at
"highest" precision (no TF32, the parity contract's f32).

pytest loads this file first in each process, xdist workers included.
The suite's workers share the host's cores, and torch's default of one
intra-op thread per core oversubscribes them: six workers each draining a
reduced qwen2-vl-2b engine took 5.9 s a drain (2.2-9.8 s) on an 8-core
host, against 0.11 s with one thread each and 0.05-0.10 s for one process
alone. The reduced models gain nothing from more threads.

Processes that tests spawn (gloo ranks, process replicas, subprocesses)
do not load this file.
"""
try:
    import torch
except ImportError:
    pass
else:
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
