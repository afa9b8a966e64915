from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    AsyncCheckpointer, latest_step, restore, restore_latest, save)
