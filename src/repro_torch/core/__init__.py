"""Core library of the port: IPKMeans, the PKMeans baseline and the k-means
solvers."""
from repro_torch.core.ipkmeans import IPKMeansConfig, IPKMeansResult, ipkmeans
from repro_torch.core.kmeans import (KMeansParams, KMeansResult, kmeans,
                                     kmeans_batched, lloyd_step)
from repro_torch.core.pkmeans import PKMeansResult, pkmeans
from repro_torch.core import init, kdtree, merge, metrics

__all__ = [
    "IPKMeansConfig", "IPKMeansResult", "ipkmeans",
    "KMeansParams", "KMeansResult", "kmeans", "kmeans_batched", "lloyd_step",
    "PKMeansResult", "pkmeans",
    "init", "kdtree", "merge", "metrics",
]
