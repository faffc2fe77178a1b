"""PyTorch + CUDA port of ``torch_ekpose_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference. This package mirrors
its layout (``models/``, ``ops/``, ``decode/``, ``runtime/``, ``cli/``)
so each module's counterpart is easy to find, imports ``torch`` and never
``jax``, and keeps the reference's layouts at its public functions:
decode takes ``[B, H, W, 19]`` heatmaps and ``[B, H, W, 38]`` PAFs, the
estimator takes ``[B, H, W, 3]`` uint8 frames. The TPU's Pallas decode
kernels are hand-written CUDA kernels here (``csrc/``, built with nvcc at
first use by ``ops/_build.py``); the convolutions go to cuDNN.

Importing the package loads no CUDA and builds nothing.
"""

__all__ = ["cli", "decode", "models", "ops", "runtime"]
