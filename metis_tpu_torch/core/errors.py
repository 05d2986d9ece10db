"""Exception hierarchy — the port's copy of ``metis_tpu/core/errors.py``
(the part this slice raises or catches)."""
from __future__ import annotations


class MetisError(Exception):
    """Base class for all framework errors."""


class ProfileMissError(MetisError, KeyError):
    """A (device_type, tp, bs) combination is absent from the profile store.

    Subclasses KeyError so per-plan pruning can catch it like a missing key.
    """

    def __init__(self, device_type: str, tp: int, bs: int):
        super().__init__(f"no profile for device_type={device_type} tp={tp} bs={bs}")
        self.device_type = device_type
        self.tp = tp
        self.bs = bs
