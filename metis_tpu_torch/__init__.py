"""PyTorch/CUDA port of metis_tpu for NVIDIA Hopper (H100).

Mirrors the module paths and public names of ``metis_tpu``; imports
``torch`` and never ``jax`` or ``metis_tpu``.
"""
