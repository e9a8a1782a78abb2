from .checkpoint import (
    CheckpointManager,
    auto_resume,
    restore_params,
    save_params,
)

__all__ = [
    "CheckpointManager",
    "auto_resume",
    "restore_params",
    "save_params",
]
