"""Training input pipeline of the port."""
from metis_tpu_torch.data.pipeline import TokenDataset, batch_source

__all__ = ["TokenDataset", "batch_source"]
