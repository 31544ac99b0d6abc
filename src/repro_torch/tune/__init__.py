"""``repro_torch.tune``: measured split autotuning (Spec -> Calibrator ->
Table), counterpart of ``repro.tune``.

- :class:`TuneSpec`: the workload grid (L_K buckets x head shapes x
  batch x impl family x dtype), candidate splits, timing budget;
  :data:`REFERENCE_SPEC` is the reference's grid, :data:`H100_SPEC` the
  port's.
- :class:`Calibrator`: times the decode op at every candidate split on
  the card (CUDA events, L2 flushed) or models it, and freezes the argmin.
- :class:`SplitTable`: the versioned JSON table, with load / save /
  merge / validate and the nearest-bucket lookup the ``measured`` policy
  serves from; :func:`select_table` picks one from a file or a registry
  directory.

Serve from a table with ``Planner(policy="measured", table=...)``,
``ServeConfig(split_policy="measured", tune_table_path=...)`` or
``python -m repro_torch.launch.serve --policy measured --tune-table``;
calibrate one with ``python -m repro_torch.launch.tune``.
"""
from repro_torch.tune.calibrator import Calibrator  # noqa: F401
from repro_torch.tune.spec import (  # noqa: F401
    DTYPE_BYTES,
    H100_SPEC,
    REFERENCE_SPEC,
    TuneSpec,
)
from repro_torch.tune.table import (  # noqa: F401
    H100_TABLE_DIR,
    PORT_IMPL,
    REFERENCE_TABLE_PATH,
    SCHEMA_VERSION,
    SplitTable,
    TABLE_DIR,
    family_key,
    select_table,
)
