from repro_torch.checkpoint.store import (CheckpointCorruptError,
                                          checkpoint_path, checkpoint_steps,
                                          latest_step, load_checkpoint,
                                          save_checkpoint, verify_checkpoint)

__all__ = ["CheckpointCorruptError", "checkpoint_path", "checkpoint_steps",
           "latest_step", "load_checkpoint", "save_checkpoint",
           "verify_checkpoint"]
