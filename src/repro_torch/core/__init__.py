"""Core library of the port: IPKMeans and the k-means solvers."""
from repro_torch.core.ipkmeans import IPKMeansConfig, IPKMeansResult, ipkmeans
from repro_torch.core.kmeans import (KMeansParams, KMeansResult, kmeans,
                                     kmeans_batched)
from repro_torch.core import init, kdtree, merge, metrics

__all__ = [
    "IPKMeansConfig", "IPKMeansResult", "ipkmeans",
    "KMeansParams", "KMeansResult", "kmeans", "kmeans_batched",
    "init", "kdtree", "merge", "metrics",
]
