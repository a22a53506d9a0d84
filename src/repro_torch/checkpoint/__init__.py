from repro_torch.checkpoint.ckpt import CheckpointManager, load_arrays, restore, save

__all__ = ["CheckpointManager", "load_arrays", "restore", "save"]
