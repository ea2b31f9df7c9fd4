from .ckpt import CheckpointManager  # noqa: F401
