"""Communication-volume model: activation and parameter sizes per plan.

The port's copy of ``metis_tpu/cost/volume.py``.

≅ reference ``GPTActivationAndParam`` (``model/activation_parameter.py:5-51``)
with the unit quirk fixed natively: the reference counts activation *elements*
and never multiplies by dtype width (SURVEY.md §2.3), so its PP costs are off
by the dtype factor.  ``elements=True`` reproduces that for strict-compat
costing; the native path returns bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from metis_tpu_torch.core.config import ModelSpec


@dataclass(frozen=True)
class TransformerVolume:
    """Analytic sizes for an embed + blocks + head transformer stack."""

    model: ModelSpec
    params_per_layer_bytes: tuple[int, ...]

    @property
    def num_layers(self) -> int:
        return self.model.num_layers

    def boundary_activation(
        self, boundary: int, batch_size: int, tp: int, elements: bool = False
    ) -> float:
        """Tensor volume crossing the stage boundary after layer
        ``boundary - 1``.

        Compat quirk preserved under ``elements=True``: the reference sizes
        the boundary *before its final layer* at vocab/tp
        (``activation_parameter.py:29-32``) even though the hidden-sized
        tensor is what actually crosses; natively every inter-stage boundary
        carries bs*seq*hidden activations in ``dtype_bytes``.
        """
        m = self.model
        if elements:
            if boundary == m.num_layers - 1:
                return batch_size * m.sequence_length * m.vocab_size / tp
            return float(batch_size * m.sequence_length * m.hidden_size)
        return float(
            batch_size * m.sequence_length * m.hidden_size * m.dtype_bytes)

    def parameter_bytes_per_layer(self, tp: int) -> list[float]:
        """Per-layer parameter bytes under tp sharding (first/middle/last
        pattern, ≅ ``get_parameter_size``)."""
        p = self.params_per_layer_bytes
        first, mid, last = float(p[0]), float(p[1]), float(p[-1])
        return (
            [first / tp]
            + [mid / tp] * (self.num_layers - 2)
            + [last / tp]
        )

    def stage_parameter_bytes(self, tp: int, start: int, end: int) -> float:
        """Parameter bytes held by a stage covering layers [start, end)
        (≅ ``get_parameter_size_by_stage``)."""
        p = self.params_per_layer_bytes
        count = end - start
        total = 0.0
        if start == 0:
            total += p[0] / tp
            count -= 1
        if end == self.num_layers:
            total += p[-1] / tp
            count -= 1
        total += p[1] / tp * count
        return total
