"""The benchmark's plain reference: stock PyTorch, fp32, no kernel, and
nothing of the program (``colddiff_torch``) or of the JAX package."""

from . import diffusion, models, precision

__all__ = ["diffusion", "models", "precision"]
