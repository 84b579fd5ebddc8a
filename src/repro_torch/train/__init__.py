"""Training: optimizers, the microbatched train step with Chronos
backup-shard aggregation, and the Trainer loop; counterpart of
`repro.train`."""
from .optimizer import Adafactor, AdamW, make_optimizer
from .train_step import TrainState, cosine_schedule, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["Adafactor", "AdamW", "Trainer", "TrainerConfig", "TrainState",
           "cosine_schedule", "make_optimizer", "make_train_step"]
