from .ckpt import CheckpointManager, ShardedCheckpointManager  # noqa: F401
