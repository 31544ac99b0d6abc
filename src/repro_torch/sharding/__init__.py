"""Sharding: logical-axis rules -> per-dim mesh-axis specs over a grid."""
from repro_torch.sharding.ctx import (  # noqa: F401
    activation_mesh,
    current_mesh,
    shard_activation,
)
from repro_torch.sharding.rules import (  # noqa: F401
    ShardingRules,
    activation_rules,
    batch_spec,
    cache_rules,
    device_coords,
    dim_slice,
    local_slices,
    param_rules,
    replicated,
    serve_param_rules,
    spec_for,
    tree_specs,
)
