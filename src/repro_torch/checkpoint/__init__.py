from repro_torch.checkpoint.manager import (CheckpointManager,
                                            save_checkpoint,
                                            restore_checkpoint, latest_step,
                                            read_metadata)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step", "read_metadata"]
