"""PyTorch/CUDA port of the MoA-Off serving stack.

Mirrors the layout of the JAX package ``repro`` module for module; never
imports ``jax`` or anything under ``repro``. Importing the package builds
nothing: the CUDA kernels under ``csrc/`` compile on first use
(``repro_torch.kernels.runtime``).
"""
