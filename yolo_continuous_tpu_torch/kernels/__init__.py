"""kernels (PyTorch port)."""
