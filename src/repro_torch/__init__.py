"""PyTorch/CUDA port of the ``repro`` serving stack.

Mirrors ``repro``'s layout module for module.  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``: what it needs from the
reference's framework-free modules it keeps as its own copies.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
