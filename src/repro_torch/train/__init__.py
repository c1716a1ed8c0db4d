"""Training (``src/repro/train``): optimizers, checkpoints in the
reference's format and the fault-tolerant trainer, over PyTorch modules."""
from repro_torch.train.optimizer import make_optimizer, Optimizer
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainConfig

__all__ = ["make_optimizer", "Optimizer", "CheckpointManager", "Trainer",
           "TrainConfig"]
