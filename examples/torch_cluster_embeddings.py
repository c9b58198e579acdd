"""Train a VQ codebook over patch embeddings with IPKMeans on the
PyTorch/CUDA port (VQ image tokens ARE k-means codes).

    PYTHONPATH=src python examples/torch_cluster_embeddings.py \\
        [--codebook 64] [--device cpu]

The twin of ``examples/cluster_embeddings.py`` on ``repro_torch``:
synthesizes patch embeddings from a mixture (standing in for a VQ-VAE
encoder's outputs), learns a codebook with IPKMeans, and reports the
quantization error and codebook use against a PKMeans-trained codebook.
Runs on the first CUDA card unless ``--device`` says otherwise.
"""
import argparse
import time

import torch

from repro_torch.core import IPKMeansConfig, KMeansParams, ipkmeans, pkmeans
from repro_torch.data import gaussian_mixture, initial_centroid_groups
from repro_torch.kernels import engine as engines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--patches", type=int, default=16384)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--codebook", type=int, default=64)
    ap.add_argument("--reducers", type=int, default=16)
    ap.add_argument("--backend", default="eager",
                    choices=list(engines.available()),
                    help="Lloyd engine for the solves AND the final "
                         "patch->code assignment ('fused' takes the codes "
                         "from the fused kernel's assign-only pass instead "
                         "of materializing the (n, k) distance matrix)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu' (the kernels' plain versions)")
    args = ap.parse_args()

    gen = torch.Generator().manual_seed(0)
    embeds, _, _ = gaussian_mixture(args.patches, args.codebook,
                                    d=args.dim, generator=gen,
                                    device=args.device)
    init = initial_centroid_groups(embeds, args.codebook, groups=1)[0]
    eng = engines.get_engine(args.backend)

    def timed(fn):
        if embeds.is_cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        if embeds.is_cuda:
            torch.cuda.synchronize()
        return out, time.time() - t0

    ref, t_pk = timed(lambda: pkmeans(
        embeds, init, params=KMeansParams(backend=args.backend),
        device=args.device))
    cfg = IPKMeansConfig(num_clusters=args.codebook,
                         num_subsets=args.reducers).with_backend(args.backend)
    res, t_ipk = timed(lambda: ipkmeans(embeds, init, cfg,
                                        device=args.device))

    for name, codebook, t in (("PKMeans ", ref.centroids, t_pk),
                              ("IPKMeans", res.centroids, t_ipk)):
        codes, mind = eng.assign(embeds[None], codebook[None])
        used = len(torch.unique(codes))
        mse = float(torch.mean(mind))
        print(f"{name}: quantization MSE={mse:.4f}  "
              f"codebook use={used}/{args.codebook}  ({t:.2f}s)")


if __name__ == "__main__":
    main()
