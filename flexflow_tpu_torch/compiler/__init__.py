"""compiler of the PyTorch port (flexflow_tpu/compiler/)."""
