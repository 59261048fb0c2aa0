"""TensorBoard event files without TensorFlow."""

from analytics_zoo_tpu_torch.tensorboard.writer import (  # noqa: F401
    SummaryWriter,
    TrainSummary,
    ValidationSummary,
    read_scalar,
)
