"""MoA-Off control plane: modality scoring, routing policy, system state.

Kept light on purpose: import the submodules you need directly.
"""
