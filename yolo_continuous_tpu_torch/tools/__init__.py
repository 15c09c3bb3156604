"""tools (PyTorch port): ``jax_weights.py`` (JAX trees -> state dicts),
``torch_import.py`` and ``torch_export.py`` (reference ``.pth`` files),
``gen_anchors.py`` and ``gen_annotation.py`` (dataset preparation)."""
