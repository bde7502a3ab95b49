"""kernels of the PyTorch port (flexflow_tpu/kernels/)."""
