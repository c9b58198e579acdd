"""PyTorch/CUDA port of the IPKMeans system (``repro``'s JAX package is the
reference it is held against).  Imports ``torch`` and ``numpy`` only."""
from repro_torch.core import (IPKMeansConfig, IPKMeansResult, KMeansParams,
                              KMeansResult, PKMeansResult, ipkmeans, kmeans,
                              kmeans_batched, pkmeans)

__all__ = ["IPKMeansConfig", "IPKMeansResult", "KMeansParams",
           "KMeansResult", "PKMeansResult", "ipkmeans", "kmeans",
           "kmeans_batched", "pkmeans"]
