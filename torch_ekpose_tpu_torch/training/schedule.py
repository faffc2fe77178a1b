"""ReduceLROnPlateau (reference train.py:184: factor 0.8, patience 5) as a
small host-side object; the new rate is written into the optimizer via
:func:`~torch_ekpose_tpu_torch.training.train_step.set_learning_rate`.

The port's own copy of the JAX package's ``training/schedule.py``, code
for code (``tests/test_torch_shared.py`` holds the syntax trees equal).
"""

from __future__ import annotations

__all__ = ["ReduceLROnPlateau"]


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        factor: float = 0.8,
        patience: int = 5,
        min_lr: float = 0.0,
        threshold: float = 1e-4,
    ):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        """Record one epoch's validation metric; returns the (possibly
        reduced) learning rate."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, d: dict) -> None:
        self.__dict__.update(d)
