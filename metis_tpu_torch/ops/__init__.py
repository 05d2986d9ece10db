"""Attention ops of the PyTorch port: hand-written Hopper kernels with plain
PyTorch versions beside them."""
