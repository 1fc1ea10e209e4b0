from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    CheckpointCorruptionError,
    CheckpointError,
    latest_step,
    read_manifest,
    restore,
    save,
)
