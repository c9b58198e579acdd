"""Serving harness for the clustering tier, the counterpart of
``repro.launch.serve_kmeans``.

Stands up a :class:`repro_torch.core.serve.NearestCentroidServer` over the
centroids of a quick synthetic solve, then drives a steady dispatch loop:
batches of random size arrive, each is dispatched as one bucketed launch,
and every ``--refresh-every`` dispatches a mini-batch refresh folds a
sampled, drifting batch into the served centroids.  Prints the rows served,
p50/p99 dispatch latency, the builds per bucket and the refresh SSE series.

    python -m repro_torch.launch.serve_kmeans --smoke              # a card
    python -m repro_torch.launch.serve_kmeans --smoke --device cpu

Every draw comes from one ``torch.Generator`` seeded with ``--seed`` on the
serving device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import KMeansParams, kmeans
from repro_torch.core.serve import BucketPolicy, NearestCentroidServer
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def make_stream(generator: torch.Generator, n: int, d: int, k: int, *,
                drift: float = 0.0):
    """Synthetic traffic on the generator's device: points around k cluster
    centres, shifted by ``drift`` -> ``(points (n,d), centres (k,d))``."""
    dev = generator.device
    centers = torch.randn((k, d), generator=generator, device=dev) * 4.0 \
        + drift
    which = torch.randint(0, k, (n,), generator=generator, device=dev)
    pts = centers[which] + torch.randn((n, d), generator=generator,
                                       device=dev)
    return pts, centers


def _wait(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def serve_loop(server: NearestCentroidServer, generator: torch.Generator, *,
               requests: int, max_request: int, d: int,
               refresh_every: int = 0, refresh_rows: int = 256,
               drift_step: float = 0.0, quiet: bool = False):
    """Submit batches of random size, dispatch each, refresh every
    ``refresh_every`` dispatches -> ``(latencies_s, one a dispatch, rows
    served)``.  A dispatch is timed from ``step`` to its labels on the host
    side of a device synchronisation, so its latency holds the coalesce,
    pad, launch and unpad a caller sees."""
    latencies, served = [], 0
    drift = 0.0
    k = server.centroids.shape[0]
    for i in range(requests):
        n = int(torch.randint(1, max_request + 1, (1,), generator=generator,
                              device=generator.device))
        q, _ = make_stream(generator, n, d, k, drift=drift)
        t = server.submit(q)
        t0 = time.perf_counter()
        done = server.step()
        labels, _ = server.result(t)
        _wait(labels)
        latencies.append(time.perf_counter() - t0)
        served += n
        if t not in done:
            raise RuntimeError(f"dispatch {i} did not complete ticket {t}")
        if refresh_every and (i + 1) % refresh_every == 0:
            drift += drift_step
            batch, _ = make_stream(generator, refresh_rows, d, k,
                                   drift=drift)
            sse = server.refresh(batch)
            if not quiet:
                print(f"  refresh @{i + 1}: batch sse {float(sse):.1f} "
                      f"(drift {drift:.2f})")
    return latencies, served


def main(argv=None) -> NearestCentroidServer:
    ap = argparse.ArgumentParser(
        description="nearest-centroid serving endpoint (clustering tier)")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale sizes")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--max-request", type=int, default=256)
    ap.add_argument("--min-bucket", type=int, default=8)
    ap.add_argument("--max-bucket", type=int, default=512)
    ap.add_argument("--refresh-every", type=int, default=50,
                    help="dispatches between mini-batch refreshes (0: off)")
    ap.add_argument("--refresh-rows", type=int, default=256)
    ap.add_argument("--backend", default="fused",
                    help="engine of the seeding solve and the refreshes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions (default: "
                         "the CUDA card, raising without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.k, args.dim = 8, 8
        args.requests, args.max_request = 12, 24
        args.max_bucket, args.refresh_every = 32, 6
        args.refresh_rows = 64

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data, _ = make_stream(gen, max(64, 8 * args.k), args.dim, args.k)
    res = kmeans(data, data[:args.k],
                 params=KMeansParams(max_iters=10, backend=args.backend),
                 device=dev)
    # the refresh counts start at the solve's cluster sizes: large counts
    # are small learning rates, so a trusted solve drifts slowly
    labels = ops.assign(data, res.centroids).labels
    seed_counts = torch.bincount(labels.long(), minlength=args.k).float()

    server = NearestCentroidServer(
        res.centroids, seed_counts,
        policy=BucketPolicy(min_bucket=args.min_bucket,
                            max_bucket=args.max_bucket),
        refresh_backend=args.backend, device=dev)

    t0 = time.perf_counter()
    lats, served = serve_loop(
        server, gen, requests=args.requests, max_request=args.max_request,
        d=args.dim, refresh_every=args.refresh_every,
        refresh_rows=args.refresh_rows, drift_step=0.25)
    wall = time.perf_counter() - t0

    lat_ms = np.asarray(lats) * 1e3
    print(f"served {served} rows / {args.requests} requests in {wall:.2f}s "
          f"({served / wall:.0f} rows/s) on {dev}")
    print(f"dispatch latency p50 {np.percentile(lat_ms, 50):.2f}ms "
          f"p99 {np.percentile(lat_ms, 99):.2f}ms")
    print(f"builds per bucket: {dict(sorted(server.trace_counts.items()))}")
    if server.refresh_sse:
        print("refresh sse series:",
              [round(s, 1) for s in server.refresh_sse])
    if any(v != 1 for v in server.trace_counts.values()):
        raise RuntimeError(f"a bucket was built more than once: "
                           f"{server.trace_counts}")
    return server


if __name__ == "__main__":
    main()
