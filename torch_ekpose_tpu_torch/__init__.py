"""PyTorch + CUDA port of ``torch_ekpose_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference. This package mirrors
its layout (``models/``, ``ops/``, ``decode/``, ``runtime/``, ``cli/``)
so each module's counterpart is easy to find, imports ``torch`` and never
``jax``, and keeps the reference's layouts at its public functions:
decode takes ``[B, H, W, 19]`` heatmaps and ``[B, H, W, 38]`` PAFs, the
estimator takes ``[B, H, W, 3]`` uint8 frames. The TPU's Pallas decode
kernels are hand-written CUDA kernels here (``csrc/``, built with nvcc at
first use by ``ops/_build.py``); the serving forward's convolutions go to
cuDNN, and the VGG prefix's conv kernels are in ``ops/conv_chain.py``
and ``ops/block1.py``. The port keeps its own copies of the JAX package's
``constants``, ``config``, ``utils/human``, numpy decode
(``decode/oracle.py``) and C++ assembler (``native/``), which decode one
image on the host as the JAX package's ``estimate()`` does, and of its
COCO index (``data/coco.py``) and OKS evaluator
(``evaluate/cocoeval.py``). Images are read and written through cv2,
else Pillow. ``data/`` and ``training/`` train one model on one card
(``cli/train.py``): the numpy/PIL input pipeline is a copy of the JAX
package's, the targets rasterize on the card, and the train step is plain
torch on cuDNN. ``parallel/`` spreads inference over several devices
(batch shards or height stripes) and training over processes (DDP,
ZeRO-1, height stripes).

Importing the package loads no CUDA and builds nothing.
"""

__all__ = ["cli", "config", "constants", "data", "decode", "evaluate",
           "models", "native", "ops", "parallel", "runtime", "training",
           "utils"]
