"""Cluster description of the port (``metis_tpu/cluster``; the TPU torus
lowering ``cluster/tpu.py`` is not ported)."""
from metis_tpu_torch.cluster.spec import (
    DeviceSpec,
    NodeSpec,
    ClusterSpec,
    DEVICE_REGISTRY,
    register_device,
)

__all__ = [
    "DeviceSpec",
    "NodeSpec",
    "ClusterSpec",
    "DEVICE_REGISTRY",
    "register_device",
]
