from .checkpoint import (
    controller_restore_hint,
    latest_step,
    load_metadata,
    participation_restore_hint,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_metadata", "participation_restore_hint",
           "controller_restore_hint"]
