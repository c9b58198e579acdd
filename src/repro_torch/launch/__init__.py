"""Command-line entry points of the port: ``serve_kmeans``, the serving
loop (``python -m repro_torch.launch.serve_kmeans --smoke``), and
``autotune``, the tuner's sweep into the tuning cache (``python -m
repro_torch.launch.autotune --sizes 16384x64x1024``)."""
