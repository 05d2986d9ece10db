"""Plan-space enumeration and search of the port (``metis_tpu/search``)."""
from metis_tpu_torch.search.multiperm import (
    multiset_permutations,
    count_multiset_permutations,
)
from metis_tpu_torch.search.device_groups import (
    power_of_two_shapes,
    nondecreasing_compositions,
    merge_for_permute_cap,
    arrangements_of_composition,
    enumerate_device_groups,
)
from metis_tpu_torch.search.uniform import (
    uniform_plans,
    grid_degrees,
)
from metis_tpu_torch.search.inter_stage import (
    inter_stage_plans,
)
from metis_tpu_torch.search.intra_stage import (
    PartitionResult,
    StageEvaluator,
    LayerPartitioner,
    initial_strategies,
    strategies_valid,
    escalate_dp_to_tp,
    intra_stage_plans,
)

__all__ = [
    "multiset_permutations",
    "count_multiset_permutations",
    "power_of_two_shapes",
    "nondecreasing_compositions",
    "merge_for_permute_cap",
    "arrangements_of_composition",
    "enumerate_device_groups",
    "uniform_plans",
    "grid_degrees",
    "inter_stage_plans",
    "PartitionResult",
    "StageEvaluator",
    "LayerPartitioner",
    "initial_strategies",
    "strategies_valid",
    "escalate_dp_to_tp",
    "intra_stage_plans",
]
