from .ckpt import CheckpointManager, restore, save

__all__ = ["CheckpointManager", "restore", "save"]
