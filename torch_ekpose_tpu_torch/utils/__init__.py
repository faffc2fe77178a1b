"""Host-side helpers: the ``Human`` / ``BodyPart`` result types
(``human.py``), the cards' peak-FLOPs tables (``hardware.py``) and the
profiling hooks (``profiling.py``)."""

from torch_ekpose_tpu_torch.utils.human import BodyPart, Human, draw_humans

__all__ = ["BodyPart", "Human", "draw_humans"]
