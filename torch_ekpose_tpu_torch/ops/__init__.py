"""Decode kernels: each module holds one hand-written CUDA kernel's
wrapper and its plain PyTorch twin (the CPU path and the kernel's oracle).
A CPU tensor takes the twin; a CUDA tensor launches the kernel or raises.
``resize`` holds the separable resampling matrices (numpy and torch),
exported here as the JAX package's ``ops`` exports its own."""

from torch_ekpose_tpu_torch.ops.resize import (
    resize_2d,
    resize_image_np,
    resize_image_torch,
    resize_matrix,
)

__all__ = ["resize_2d", "resize_image_np", "resize_image_torch",
           "resize_matrix"]
