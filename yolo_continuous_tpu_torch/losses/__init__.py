"""losses (PyTorch port)."""
