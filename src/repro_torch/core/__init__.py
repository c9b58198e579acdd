"""Core library of the port: IPKMeans, the PKMeans baseline, the k-means
solvers and the serving tier."""
from repro_torch.core.ipkmeans import IPKMeansConfig, IPKMeansResult, ipkmeans
from repro_torch.core.kmeans import (KMeansParams, KMeansResult, kmeans,
                                     kmeans_batched, lloyd_step,
                                     update_minibatch)
from repro_torch.core.pkmeans import PKMeansResult, pkmeans
from repro_torch.core.serve import BucketPolicy, NearestCentroidServer
from repro_torch.core import init, io_model, kdtree, merge, metrics

__all__ = [
    "IPKMeansConfig", "IPKMeansResult", "ipkmeans",
    "KMeansParams", "KMeansResult", "kmeans", "kmeans_batched", "lloyd_step",
    "update_minibatch", "PKMeansResult", "pkmeans",
    "BucketPolicy", "NearestCentroidServer",
    "init", "io_model", "kdtree", "merge", "metrics",
]
