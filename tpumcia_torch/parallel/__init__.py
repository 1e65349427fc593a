"""Device meshes and multi-process runs for the feature and CNN paths
(counterpart of ``tpumcia.parallel``): ``mesh`` (``Mesh``, ``make_mesh``,
``mesh_from_config``, ``row_ranges``, the placements ``data_sharding`` and
``replicated``), ``distributed``
(``init_distributed``, ``shard_across_processes``, ``process_summary`` and
the collectives), ``sharding`` (the sharded statistics, features, scaler
and permutation sweep) and ``data_parallel`` (the CNN's data-parallel step:
per-device replicas, the gradient all-reduce). ``python -m
tpumcia_torch.parallel.dryrun`` is one rank of a multi-process check run."""

from tpumcia_torch.parallel.mesh import (
    Mesh,
    Sharding,
    data_sharding,
    make_mesh,
    mesh_from_config,
    replicated,
    row_ranges,
)
from tpumcia_torch.parallel.distributed import (
    ShardedRows,
    init_distributed,
    process_summary,
    shard_across_processes,
)
from tpumcia_torch.parallel.data_parallel import data_parallel_step, reduce_gradients, replicate
from tpumcia_torch.parallel.sharding import (
    extract_features_sharded,
    fit_scaler_sharded,
    permutation_importance_sharded,
    sufficient_stats_sharded,
)

__all__ = [
    "make_mesh",
    "init_distributed",
    "shard_across_processes",
    "process_summary",
    "data_sharding",
    "replicated",
    "row_ranges",
    "extract_features_sharded",
    "sufficient_stats_sharded",
    "fit_scaler_sharded",
    "permutation_importance_sharded",
    "Mesh",
    "Sharding",
    "ShardedRows",
    "mesh_from_config",
    "replicate",
    "reduce_gradients",
    "data_parallel_step",
]
