"""Fault tolerance: watchdog, straggler detection, resumable training."""
from repro_torch.fault.watchdog import (  # noqa: F401
    Heartbeat,
    StragglerDetector,
    Watchdog,
)
from repro_torch.fault.elastic import (  # noqa: F401
    elastic_restore,
    resumable_train_loop,
)
