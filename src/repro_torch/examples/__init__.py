"""Runnable examples of the PyTorch port, counterparts of the JAX package's
``examples/``: ``python -m repro_torch.examples.<name> [--device cpu]``."""
