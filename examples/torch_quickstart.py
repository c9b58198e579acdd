"""Quickstart on the PyTorch/CUDA port: cluster a Gaussian dataset with
IPKMeans vs PKMeans.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of ``examples/quickstart.py`` on ``repro_torch``: the paper's
dataset 1, the same initial centroids for both, one parallel program for
IPKMeans against an iteration-synchronous PKMeans, their SSE, and the
job and I/O arithmetic that favours IPKMeans.  Runs on the first CUDA card
unless ``--device`` says otherwise.
"""
import argparse
import time

import torch

from repro_torch.core import IPKMeansConfig, io_model, ipkmeans, pkmeans
from repro_torch.data import initial_centroid_groups, paper_dataset_3000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu' (the kernels' plain versions)")
    args = ap.parse_args()

    points, _ = paper_dataset_3000(seed=0, device=args.device)
    init = initial_centroid_groups(points, k=5, groups=1)[0]

    def timed(fn):
        if points.is_cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        if points.is_cuda:
            torch.cuda.synchronize()
        return out, time.time() - t0

    ref, t_pk = timed(lambda: pkmeans(points, init, device=args.device))
    print(f"PKMeans : SSE={float(ref.sse):10.2f}  "
          f"Lloyd iters={int(ref.iters)}  ({t_pk:.2f}s)")

    cfg = IPKMeansConfig(num_clusters=5, num_subsets=6)   # 6 'reducers'
    res, t_ipk = timed(lambda: ipkmeans(points, init, cfg,
                                        device=args.device))
    print(f"IPKMeans: SSE={float(res.sse):10.2f}  "
          f"kd-tree depth={res.kd_depth}  ({t_ipk:.2f}s)")
    print(f"SSE gap: {100 * (float(res.sse) / float(ref.sse) - 1):.3f}%")

    model = io_model.HadoopCostModel()
    pk = model.pkmeans_bytes(3000, 2, 5, int(ref.iters))
    ipk = model.ipkmeans_bytes(3000, 2, 5, 6, res.kd_depth)
    print(f"MapReduce jobs : PKMeans={pk['jobs']}  IPKMeans={ipk['jobs']}")
    tot_pk = pk["read"] + pk["write"]
    tot_ipk = ipk["read"] + ipk["write"]
    print(f"modeled I/O    : PKMeans={tot_pk/1e6:.1f}MB  "
          f"IPKMeans={tot_ipk/1e6:.1f}MB  "
          f"({100 * (1 - tot_ipk / tot_pk):.0f}% lower)")


if __name__ == "__main__":
    main()
