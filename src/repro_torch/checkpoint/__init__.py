"""Checkpointing: atomic, keep-last-k, async, restorable by either
package."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)
