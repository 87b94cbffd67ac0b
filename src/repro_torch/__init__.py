"""PyTorch/CUDA port of the Arrow serving system for NVIDIA Hopper (H100).

A package of its own beside the JAX reference (``repro``): it imports
``torch`` and never ``jax``, and nothing of the JAX package. Module names
follow the reference's, so each counterpart is easy to find. Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
