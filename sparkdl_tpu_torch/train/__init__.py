"""Training subsystem — the train step, optax's rules, checkpoint/resume.

A port of ``sparkdl_tpu.train`` on one card: ``Trainer`` runs an eager
train step (forward, float32 loss, ``autograd``, the optimizer's in-place
update, BatchNorm's running statistics) inside the reference's pipelined
loop; ``CheckpointManager`` saves and restores the full state ``{step,
params, opt_state, model_state, rng}`` with ``torch.save``, a sha256
manifest and a fencing token. ``TPURunner`` (gang restarts over several
cards) waits for the distributed slice (ROADMAP Queue 1 item 5).
"""

from sparkdl_tpu_torch.train.checkpoint import CheckpointManager
from sparkdl_tpu_torch.train.metrics import MetricsLogger
from sparkdl_tpu_torch.train.optimizers import make_loss, make_optimizer
from sparkdl_tpu_torch.train.trainer import Trainer, TrainState

__all__ = [
    "CheckpointManager",
    "MetricsLogger",
    "Trainer",
    "TrainState",
    "make_loss",
    "make_optimizer",
]
