"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default.  The CPU is used only when a
caller asks for it (the tests do); a machine without CUDA raises instead of
quietly running on the CPU, so no number measured on the host can pass for a
number from the card.
"""
from __future__ import annotations

import torch

from metis_tpu_torch.core.errors import MetisError


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MetisError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run on the host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise MetisError(f"unsupported device {dev}")
    return dev
