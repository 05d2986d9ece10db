"""Profile contract and measured profiler of the port."""
from metis_tpu_torch.profiles.store import (
    DeviceTypeMeta,
    LayerProfile,
    ModelProfileMeta,
    ProfileStore,
)

__all__ = ["DeviceTypeMeta", "LayerProfile", "ModelProfileMeta", "ProfileStore"]
