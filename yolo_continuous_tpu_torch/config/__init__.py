"""config (PyTorch port)."""
