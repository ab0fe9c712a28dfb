from caiman_asr_tpu_torch.export.checkpointer import (
    Checkpointer,
    average_checkpoints,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "Checkpointer",
    "save_checkpoint",
    "load_checkpoint",
    "average_checkpoints",
]
