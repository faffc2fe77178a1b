"""Host-side helpers: the ``Human`` / ``BodyPart`` result types."""

from torch_ekpose_tpu_torch.utils.human import BodyPart, Human, draw_humans

__all__ = ["BodyPart", "Human", "draw_humans"]
