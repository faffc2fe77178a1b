"""Decode kernels: each module holds one hand-written CUDA kernel's
wrapper and its plain PyTorch twin (the CPU path and the kernel's oracle).
A CPU tensor takes the twin; a CUDA tensor launches the kernel or raises."""
