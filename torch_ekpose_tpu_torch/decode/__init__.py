"""Pose decode (counterpart of the JAX package's ``decode/``): the batched
on-device decode (``device.py``), the numpy decode (``oracle.py``) and
one image's decode with a selectable backend (``api.py``), and synthetic
scenes with known people (``synthetic.py``)."""
