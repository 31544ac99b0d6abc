"""The paper's split policies, the occupancy model and the metadata
entry point (counterpart of ``repro.core``).

``scheduler_metadata`` imports ``repro_torch.plan``, whose modules import
``repro_torch.core.split_policy``, so its names are re-exported lazily
(PEP 562), as the reference does.
"""
from repro_torch.core.occupancy import (  # noqa: F401
    H100_SXM,
    TPU_V5E,
    HardwareModel,
    modeled_latency_us,
    modeled_speedup,
    occupancy_fraction,
)
from repro_torch.core.split_policy import (  # noqa: F401
    DEFAULT_NUM_CORES,
    KV_BLOCK,
    KV_DTYPES,
    DecodeWorkload,
    analytic_policies,
    available_policies,
    choose_mesh_splits,
    choose_num_splits,
    fa3_baseline,
    get_policy,
    measured,
    paper_policy,
    tpu_adaptive,
)

_METADATA = ("SchedulerMetadata", "bucket_seqlen", "get_scheduler_metadata",
             "metadata_cache_info")


def __getattr__(name):
    if name in _METADATA:
        from repro_torch.core import scheduler_metadata
        return getattr(scheduler_metadata, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")
