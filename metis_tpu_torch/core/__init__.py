"""Core types, errors, events and timing of the PyTorch port."""
