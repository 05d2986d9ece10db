"""Cost model of the port (``metis_tpu/cost``).  Not ported: the TPU
ICI/DCN model (``cost/ici.py``), the jit cost backend (``cost/jax_backend.py``)
and the measured calibration functions (``cost/calibration.py``)."""
from metis_tpu_torch.cost.volume import (
    TransformerVolume,
)
from metis_tpu_torch.cost.bandwidth import (
    StageBandwidthModel,
    HeteroScalarBandwidth,
    HomoScalarBandwidth,
)
from metis_tpu_torch.cost.uncertainty import (
    ResidualFit,
    ResidualModel,
    RiskScorer,
    certificate_confidence,
    fit_residual_model,
    make_risk_scorer,
)
from metis_tpu_torch.cost.estimator import (
    EstimatorOptions,
    UniformCostEstimator,
    HeteroCostEstimator,
    uniform_layer_split,
)

__all__ = [
    "TransformerVolume",
    "StageBandwidthModel",
    "HeteroScalarBandwidth",
    "HomoScalarBandwidth",
    "ResidualFit",
    "ResidualModel",
    "RiskScorer",
    "certificate_confidence",
    "fit_residual_model",
    "make_risk_scorer",
    "EstimatorOptions",
    "UniformCostEstimator",
    "HeteroCostEstimator",
    "uniform_layer_split",
]
