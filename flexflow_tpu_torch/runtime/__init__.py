"""runtime of the PyTorch port (flexflow_tpu/runtime/)."""
