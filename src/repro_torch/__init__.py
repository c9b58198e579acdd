"""PyTorch/CUDA port of the IPKMeans system (``repro``'s JAX package is the
reference it is held against).  Imports ``torch`` and ``numpy`` only."""
from repro_torch.core import (BucketPolicy, IPKMeansConfig, IPKMeansResult,
                              KMeansParams, KMeansResult,
                              NearestCentroidServer, PKMeansResult, ipkmeans,
                              kmeans, kmeans_batched, pkmeans,
                              update_minibatch)

__all__ = ["BucketPolicy", "IPKMeansConfig", "IPKMeansResult",
           "KMeansParams", "KMeansResult", "NearestCentroidServer",
           "PKMeansResult", "ipkmeans", "kmeans", "kmeans_batched",
           "pkmeans", "update_minibatch"]
