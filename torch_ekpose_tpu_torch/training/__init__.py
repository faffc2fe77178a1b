"""Training (counterpart of the JAX package's ``training/``) on one
device or as one rank of a data-parallel process group: the CPM loss,
the plateau schedule, metrics, the train and eval steps and the
``Trainer``. The JAX package's ``TrainState`` and
``create_train_state`` have no counterpart here: the module and its
``torch.optim.Adam`` hold the state."""

from torch_ekpose_tpu_torch.training.loss import cpm_loss, loss_series_names
from torch_ekpose_tpu_torch.training.metrics import (
    AverageMeter,
    Logger,
    MetricsWriter,
)
from torch_ekpose_tpu_torch.training.schedule import ReduceLROnPlateau
from torch_ekpose_tpu_torch.training.train_step import (
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_learning_rate,
)
from torch_ekpose_tpu_torch.training.trainer import Trainer

__all__ = [
    "AverageMeter",
    "Logger",
    "MetricsWriter",
    "ReduceLROnPlateau",
    "Trainer",
    "cpm_loss",
    "loss_series_names",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "set_learning_rate",
]
