"""Training: AdamW, remat policies, microbatching, the train step."""
from repro_torch.training.optimizer import (  # noqa: F401
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
)
from repro_torch.training.train_step import (  # noqa: F401
    TrainStepBundle,
    build_train_step,
    lm_loss,
    make_batch_shapes,
)
