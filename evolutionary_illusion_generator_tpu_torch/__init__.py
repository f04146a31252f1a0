"""PyTorch/CUDA port of EIGen-TPU for NVIDIA Hopper GPUs.

A second package beside ``evolutionary_illusion_generator_tpu`` (the JAX
reference, which it never imports).  Plain tensor code is PyTorch; the
Pallas kernels of the JAX package (ConvLSTM and the bisection ladder's
rungs) are hand-written CUDA kernels for ``sm_90a`` (``csrc/``, built with
one ``nvcc`` call at first use by :mod:`._build`).  On the CPU every kernel wrapper runs its plain PyTorch
version instead, which is what the tests use.

Subpackages
-----------
- ``neat``       host-side NEAT engine (a copy of the reference's)
- ``models``     CPPN level evaluator and the PredNet predictive coder
- ``ops``        coordinate grids, rendering, optical flow, fitness metrics,
                 the CUDA kernel wrappers
- ``evolution``  the generation evaluator, the ``neat_illusion`` driver and
                 the per-generation artifacts
- ``utils``      PNG I/O without Pillow, image IO and flow overlays,
                 mirroring, misc image helpers, timing and profiling
- ``scripts``    command-line tools: ``kernel_bisect``, the kernel-bisection
                 ladder on the card
- ``cli``        the command line (``python -m
                 evolutionary_illusion_generator_tpu_torch.cli``), with the
                 run presets of ``configs``
"""

__version__ = "0.1.0"

from .structure import StructureType

__all__ = ["StructureType", "__version__"]
