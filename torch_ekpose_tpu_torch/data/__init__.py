"""COCO-format data (counterpart of the JAX package's ``data/``): so far
only the annotation index, ``coco.py``; the training data pipeline is not
ported yet."""

from torch_ekpose_tpu_torch.data.coco import COCO

__all__ = ["COCO"]
