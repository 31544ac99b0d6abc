"""``repro_torch.shard``: mesh-native serving (Spec -> Resolver -> Plan ->
Engine).

Counterpart of ``repro.shard``.  Where ``repro_torch.plan`` splits a
decode launch's KV over the card's SMs, this splits the serving topology
over a grid of devices: data-parallel slot shards for throughput, and
sequence-sharded decode (devices in place of SMs) for long contexts.

- :class:`ShardSpec`: the declarative ``dp x sp`` topology, slots and
  page budget per shard, params policy.
- :class:`ShardResolver`: checks divisibility against the cache layout,
  builds the device grid (:func:`~repro_torch.launch.mesh.
  make_engine_mesh`), fingerprints the devices.
- :class:`ShardPlan`: the grid, the per-shard sub-grids, and the
  per-(topology, shard) PlanCache registry.
- :class:`ShardedServingEngine`: dp per-shard
  :class:`~repro_torch.serving.ServingEngine` cores behind one routed
  submit / step / stream / drain surface.  A shard with sp > 1 freezes
  its plans through ``Planner.mesh_plan`` and decodes with one partials
  launch a device over its chunk of the cache, merged by the combine
  kernel (``kernels.ops.decode_seqsharded``).

A single controller drives every shard in one process.  Serve with
``ServeConfig(shard="4,2")`` or ``python -m repro_torch.launch.serve
--mesh 4,2``.
"""
from repro_torch.shard.engine import (  # noqa: F401
    ShardedServingEngine,
    pick_shard,
)
from repro_torch.shard.resolver import (  # noqa: F401
    ShardPlan,
    ShardResolver,
    clear_shard_plan_caches,
    shard_plan_cache,
)
from repro_torch.shard.spec import ShardSpec  # noqa: F401
