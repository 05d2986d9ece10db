"""Cost model of the port (``metis_tpu/cost``), with the TPU ICI/DCN model
(``cost/ici.py``), its calibration (``cost/calibration.py``: the fits, and
the measurements over ``torch.distributed``) and the batched cost tensor
on the card (``cost/torch_backend.py``, the counterpart of the reference's
``cost/jax_backend.py``; imported only when selected)."""
from metis_tpu_torch.cost.volume import (
    TransformerVolume,
)
from metis_tpu_torch.cost.bandwidth import (
    StageBandwidthModel,
    HeteroScalarBandwidth,
    HomoScalarBandwidth,
)
from metis_tpu_torch.cost.ici import (
    IciDcnBandwidth,
    ring_all_reduce_ms,
    all_gather_ms,
    reduce_scatter_ms,
    all_to_all_ms,
    p2p_ms,
    sub_torus_eff_bw_gbps,
)
from metis_tpu_torch.cost.calibration import (
    CalibrationError,
    CollectiveCalibration,
    LinearFit,
    fit_ledger_correction,
    fit_samples,
    fit_transfer_scale,
    measure_dp_overlap,
    measure_pipeline_overlap,
    microbenchmark_collectives,
    microbenchmark_chip,
    transfer_profiles,
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
    "IciDcnBandwidth",
    "ring_all_reduce_ms",
    "all_gather_ms",
    "reduce_scatter_ms",
    "all_to_all_ms",
    "p2p_ms",
    "sub_torus_eff_bw_gbps",
    "CalibrationError",
    "CollectiveCalibration",
    "LinearFit",
    "fit_ledger_correction",
    "fit_samples",
    "fit_transfer_scale",
    "measure_dp_overlap",
    "measure_pipeline_overlap",
    "microbenchmark_collectives",
    "microbenchmark_chip",
    "transfer_profiles",
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
