"""Ops of the PyTorch port: hand-written Hopper kernels (flash attention,
the planner's batched cost tensor) with plain PyTorch versions beside
them."""
