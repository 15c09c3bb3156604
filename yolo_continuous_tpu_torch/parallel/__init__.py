"""parallel (PyTorch port): ``mesh.py`` (the (data, model) process mesh, sharding
and its collectives) and ``distributed.py`` (the process group)."""
