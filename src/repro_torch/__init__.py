"""PyTorch/CUDA port of the CORDIC reproduction (``repro`` is the reference).

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Its entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
