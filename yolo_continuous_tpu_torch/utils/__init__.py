"""utils (PyTorch port): ``timing.py``, ``image.py``, ``env.py``."""
