from .losses import cls_loss, ctc_loss, db_loss
from .trainer import TrainState, init_train_state, make_train_step, warmup_cosine_decay

__all__ = [
    "ctc_loss",
    "db_loss",
    "cls_loss",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "warmup_cosine_decay",
]
