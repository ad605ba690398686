"""The LM training path (port of ``src/repro/train``)."""
from repro_torch.train.optimizer import adamw_init, adamw_update, Hyper  # noqa: F401
from repro_torch.train.step import make_train_step, TrainState  # noqa: F401
