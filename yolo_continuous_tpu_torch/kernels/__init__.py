"""kernels (PyTorch port).

Each wrapper counts its launches on its ``.launches`` through
``utils/capture.count``: a launch inside a captured CUDA graph counts once
per replay of the graph.
"""
