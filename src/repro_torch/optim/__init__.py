"""AdamW, its cosine schedule and global-norm clipping, as ``repro.optim``."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    adamw_update_,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
)

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "adamw_update_",
    "cosine_schedule",
    "global_norm",
    "clip_by_global_norm",
]
