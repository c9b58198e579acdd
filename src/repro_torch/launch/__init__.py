"""Command-line entry points of the port: ``serve_kmeans``, the serving
loop (``python -m repro_torch.launch.serve_kmeans --smoke``),
``autotune``, the tuner's sweep into the tuning cache (``python -m
repro_torch.launch.autotune --sizes 16384x64x1024``), ``kmeans_dryrun``,
the production-scale dry run on a fake world (``python -m
repro_torch.launch.kmeans_dryrun --backend batched --reseed-empty``),
``perf_variants``, its engine variants against their baselines (``python
-m repro_torch.launch.perf_variants --cell C4``), and ``serve``, greedy
LM serving for the dense decoder families (``python -m
repro_torch.launch.serve --arch minicpm-2b --smoke``)."""
