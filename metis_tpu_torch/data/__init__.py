"""Training input pipeline of the port."""
from metis_tpu_torch.data.pipeline import (
    TokenDataset,
    batch_source,
    make_input_pipeline,
    measure_batch_generator_ms,
    synthetic_run_dataset,
)

__all__ = ["TokenDataset", "batch_source", "make_input_pipeline",
           "measure_batch_generator_ms", "synthetic_run_dataset"]
