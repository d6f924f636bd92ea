"""PyTorch + CUDA port of the ``repro`` package (the JAX package is the
reference and stays beside it). Imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``."""
