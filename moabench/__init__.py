"""The serving benchmark of ``repro_torch``, the PyTorch and CUDA port of
MoA-Off: one run of one cell (a configuration under a traffic mix) through
``ClusterServer``, measured on the host clock and, with ``--trace 1``, from
the profiler's device trace.

Every configuration, mix, cell and metric is a file of its own under this
folder, found by its name in ``BENCHMARK.json``; see ``README.md``."""
