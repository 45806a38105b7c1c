from repro_torch.train import checkpoint, optimizer, train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamW, Adafactor, ErrorFeedbackCompressor
from repro_torch.train.train_step import TrainState, default_optimizer, make_train_step

__all__ = [
    "AdamW", "Adafactor", "CheckpointManager", "ErrorFeedbackCompressor",
    "TrainState", "checkpoint", "default_optimizer", "make_train_step",
    "optimizer", "train_step",
]
