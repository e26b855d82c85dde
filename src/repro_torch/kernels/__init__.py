"""Hand-written Hopper kernels (``csrc/*.cu``), their plain PyTorch
versions and the wrappers that choose between them by tensor device."""
