"""core of the PyTorch port (flexflow_tpu/core/)."""
