"""PyTorch + CUDA port of the synthetic graph generator (``repro``).

The JAX package ``repro`` is the reference; this package imports none of
it.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  See ``repro_torch.convert`` for loading a fit and
``repro_torch.core.pipeline`` for generation.
"""
