"""Command-line launchers (``python -m repro_torch.launch.serve``)."""
