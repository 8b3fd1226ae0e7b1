"""Training: the port of ``repro.training`` (AdamW, int8 error-feedback
gradient compression, the synthetic data pipeline, step-atomic
checkpoints and the trainer), on nested dicts of torch tensors.  Its
names are the reference's."""
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.training.trainer import TrainConfig, Trainer  # noqa: F401
