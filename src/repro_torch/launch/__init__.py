"""Command-line entry points of the port: ``serve_kmeans``, the serving
loop (``python -m repro_torch.launch.serve_kmeans --smoke``)."""
