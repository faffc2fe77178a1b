"""Batched on-device pose decode (counterpart of the JAX package's
``decode/device.py``)."""
