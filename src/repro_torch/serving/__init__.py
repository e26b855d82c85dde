"""Live serving: tier engines, the cluster runtime and its transports.

Kept light on purpose: import the submodules you need directly.
"""
