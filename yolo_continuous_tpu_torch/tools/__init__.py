"""tools (PyTorch port)."""
