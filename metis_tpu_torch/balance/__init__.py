"""Data, stage-performance and layer balancers of the port (``metis_tpu/balance``)."""
from metis_tpu_torch.balance.data import (
    DataBalancer,
    power_of_two_chunks,
    proportional_split,
    replica_chunks,
)
from metis_tpu_torch.balance.stage_perf import (
    StagePerformanceModel,
    node_device_types,
    rank_device_types,
)
from metis_tpu_torch.balance.layers import (
    LayerBalancer,
    minmax_partition,
)

__all__ = [
    "DataBalancer",
    "power_of_two_chunks",
    "proportional_split",
    "replica_chunks",
    "StagePerformanceModel",
    "node_device_types",
    "rank_device_types",
    "LayerBalancer",
    "minmax_partition",
]
