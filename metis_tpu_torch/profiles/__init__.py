"""Profile contract, synthetic profiles and measured profiler of the port."""
from metis_tpu_torch.profiles.store import (
    DeviceTypeMeta,
    LayerProfile,
    ModelProfileMeta,
    ProfileStore,
)
from metis_tpu_torch.profiles.synthetic import (
    CHIP_PERF,
    ChipPerf,
    synthesize_profiles,
    tiny_test_model,
)

__all__ = ["DeviceTypeMeta", "LayerProfile", "ModelProfileMeta", "ProfileStore",
           "ChipPerf", "CHIP_PERF", "synthesize_profiles", "tiny_test_model"]
