"""Training (counterpart of ``src/repro/training``): optimizers, the train
step and loop, int8 gradient compression, checkpoints in the reference's
on-disk format, and the synthetic data streams."""

from repro_torch.training.optimizer import (OptimizerBundle,  # noqa: F401
                                            adafactor, adamw)
from repro_torch.training.train_loop import (TrainState,  # noqa: F401
                                             make_train_step)
