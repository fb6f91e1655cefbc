"""colddiff_torch: Cold Diffusion in PyTorch, with hand-written CUDA kernels for Hopper.

A port of the JAX/Flax package ``colddiff``, which stays the numerical
reference.  Module paths mirror ``colddiff/`` so each counterpart is found by
name.  Public functions keep the JAX package's NHWC image layout; inside the
UNet, tensors are NCHW in ``torch.channels_last`` memory.

Ported so far: the nine degradation operators of ``colddiff.operators``
(blur, noise, mix, decolor, fade, fade_naive, fade_generation, resolution,
snow), both UNet families (``UnetConvNext``, ``UnetResNet``) and
``get_model``, ``ColdDiffusion`` (``q_sample`` and every training routine),
the ``prepare_start`` / ``sample`` / ``all_sample`` / ``sample_multi_step``
reverse samplers (Family A and Family B, models of every training routine),
the ``Trainer`` with all its switches, on one process or several
(``colddiff_torch.parallel``: data parallelism, FSDP, multi-process
start-up, mesh-sharded eval), the datasets of
``colddiff.data`` (``get_dataset``, ``create_data``), the eval surface of
``colddiff.eval`` (the image metrics, FID with its Inception pool3 graph
and fallback extractor, the EM Gaussian mixture and the ``EvalHarness``)
and the command line of ``colddiff.cli`` (``python -m
colddiff_torch.cli.main train|test``, the restart supervisor, the SLURM
launcher).  The ConvNeXt block front runs as CUDA kernels
(``colddiff_torch/csrc/convnext_front.cu``) on CUDA tensors and as plain
PyTorch on CPU tensors; the Mosaic probes of ``scripts/bisect_mosaic.py``
run as ``colddiff_torch/csrc/bisect_mosaic.cu``.  The ResNet family runs
stock torch ops, as its JAX twin runs no Pallas kernel.

Importing this package imports torch and numpy only: no kernel is compiled
until a CUDA tensor first reaches one.
"""

__version__ = "0.1.0"

from .diffusion import ColdDiffusion  # noqa: E402
from .sampling import all_sample, prepare_start, sample, sample_multi_step  # noqa: E402

__all__ = ["ColdDiffusion", "all_sample", "prepare_start", "sample", "sample_multi_step"]
