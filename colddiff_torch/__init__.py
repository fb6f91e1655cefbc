"""colddiff_torch: Cold Diffusion in PyTorch, with hand-written CUDA kernels for Hopper.

A port of the JAX/Flax package ``colddiff``, which stays the numerical
reference.  Module paths mirror ``colddiff/`` so each counterpart is found by
name.  Public functions keep the JAX package's NHWC image layout; inside the
UNet, tensors are NCHW in ``torch.channels_last`` memory.

Ported so far: the blur, decolor, fade, resolution and fade-generation
degradations, the ConvNeXt UNet, ``ColdDiffusion`` (``q_sample`` and the
deterministic training losses), the ``prepare_start`` / ``sample`` /
``all_sample`` reverse samplers (Family A and Family B) and the
single-device ``Trainer``.  The ConvNeXt block front runs as CUDA kernels
(``colddiff_torch/csrc/convnext_front.cu``) on CUDA tensors and as plain
PyTorch on CPU tensors.

Importing this package imports torch and numpy only: no kernel is compiled
until a CUDA tensor first reaches one.
"""

__version__ = "0.1.0"
