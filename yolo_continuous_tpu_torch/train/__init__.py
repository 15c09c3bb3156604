"""train (PyTorch port)."""
