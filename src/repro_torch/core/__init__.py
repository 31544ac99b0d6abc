"""The paper's split policies (counterpart of ``repro.core``)."""
from repro_torch.core.split_policy import (  # noqa: F401
    DEFAULT_NUM_CORES,
    KV_BLOCK,
    KV_DTYPES,
    DecodeWorkload,
    available_policies,
    choose_num_splits,
    fa3_baseline,
    get_policy,
    paper_policy,
)
