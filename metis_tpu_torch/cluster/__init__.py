"""Cluster description of the port (``metis_tpu/cluster``): the clusterfile
scalars (``spec.py``) and the TPU slice torus (``tpu.py``)."""
from metis_tpu_torch.cluster.spec import (
    DeviceSpec,
    NodeSpec,
    ClusterSpec,
    DEVICE_REGISTRY,
    register_device,
)
from metis_tpu_torch.cluster.tpu import (
    TpuGeneration,
    TpuSliceSpec,
    TpuClusterSpec,
    TPU_GENERATIONS,
    slice_from_name,
)

__all__ = [
    "DeviceSpec",
    "NodeSpec",
    "ClusterSpec",
    "DEVICE_REGISTRY",
    "register_device",
    "TpuGeneration",
    "TpuSliceSpec",
    "TpuClusterSpec",
    "TPU_GENERATIONS",
    "slice_from_name",
]
