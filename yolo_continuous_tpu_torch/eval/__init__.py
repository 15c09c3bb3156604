"""eval (PyTorch port)."""
