#!/usr/bin/env python
"""The port's fleet drill, the counterpart of ``tools/fleet_drill.py``.

    python3 tools/torch_fleet_drill.py [--skip-supervisor] [--tenants N] ...

Runs ``metis_tpu_torch.resilience.fleet_drill.main`` with these arguments,
as ``python -m metis_tpu_torch chaos --fleet`` does.  The supervisor leg
trains on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from metis_tpu_torch.resilience.fleet_drill import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
