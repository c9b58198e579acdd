"""Serving tier: batched nearest-centroid queries and the mini-batch
refresh, the counterpart of ``repro.core.serve``.

The offline pipeline ends with a centroid set; traffic then asks which
centroid is nearest, many times over, in batches of every size.

  * **Buckets.**  Every batch is rounded up to a bucket (powers of two by
    default, :class:`BucketPolicy`), and each bucket has ONE callable, the
    fused kernel's assign-only mode (``ops.lloyd_assign_fused``) bound to
    the bucket's ``KernelSpec`` from the tuning cache
    (``tuning.lookup_spec(bucket, d, k, dtype)``), built at the bucket's
    first use.  ``trace_counts`` counts those builds: at most one a bucket,
    under any stream.  Batches above the top bucket go in chunks.
  * **Padding.**  A bucket pads its rows with zeros.  A row's label and
    distance depend on that row and the centroids only, so the real rows'
    results are what the unpadded call gives, bit for bit; the pad rows
    are sliced off.  Results stay on the device.
  * **Refresh.**  :meth:`NearestCentroidServer.refresh` folds a sampled
    batch into the served centroids with one ``update_minibatch``
    (Sculley's mini-batch k-means: one fused launch on the ``fused``
    engine).  Values change, shapes do not, so no bucket is built again.

``launch/serve_kmeans.py`` drives this in a dispatch loop.
"""
from __future__ import annotations

import functools
from collections import deque
from typing import NamedTuple

import torch

from repro_torch.core.kmeans import KMeansParams, update_minibatch
from repro_torch.device import as_float, as_weights, resolve_device
from repro_torch.kernels import ops, tuning


class BucketPolicy(NamedTuple):
    """How request sizes round up to bucket sizes.

    ``kind="pow2"`` (default): the next power of two in ``[min_bucket,
    max_bucket]``.  ``kind="fixed"``: the smallest rung of the ascending
    ``ladder`` that holds the request.  Larger requests are chunked by the
    server, so any n is servable under any policy.
    """
    kind: str = "pow2"            # 'pow2' | 'fixed'
    min_bucket: int = 8
    max_bucket: int = 4096
    ladder: tuple[int, ...] = ()  # kind='fixed' rungs, ascending

    def bucket_for(self, n: int) -> int:
        """Bucket size for an n-row chunk (n <= the top bucket)."""
        if n <= 0:
            raise ValueError(f"bucket_for needs n >= 1, got {n}")
        if self.kind == "fixed":
            if not self.ladder:
                raise ValueError("fixed bucket policy needs a ladder")
            for b in self.ladder:
                if n <= b:
                    return int(b)
            raise ValueError(f"n={n} exceeds top fixed bucket "
                             f"{self.ladder[-1]} (server chunks first)")
        if self.kind != "pow2":
            raise ValueError(f"unknown bucket policy kind: {self.kind!r}")
        b = self.min_bucket
        while b < n:
            b *= 2
        if b > self.max_bucket:
            raise ValueError(f"n={n} exceeds max_bucket={self.max_bucket} "
                             f"(server chunks first)")
        return int(b)

    @property
    def top(self) -> int:
        return int(self.ladder[-1]) if self.kind == "fixed" \
            else int(self.max_bucket)

    def buckets(self) -> tuple[int, ...]:
        """Every bucket this policy can emit, ascending."""
        if self.kind == "fixed":
            return tuple(int(b) for b in self.ladder)
        out, b = [], int(self.min_bucket)
        while b <= self.max_bucket:
            out.append(b)
            b *= 2
        return tuple(out)


class _Ticket(NamedTuple):
    ticket: int
    n: int


class NearestCentroidServer:
    """A nearest-centroid endpoint over a served centroid set.

    :meth:`assign` answers one batch at once (chunk, bucket, pad, one
    launch a chunk, unpad); :meth:`submit` and :meth:`step` coalesce queued
    batches, first in first out up to the top bucket, into one dispatch.
    ``centroids (k,d)`` and ``counts (k,)`` (default zeros) may be tensors
    or numpy arrays, float32 or bfloat16 centroids; the server runs on
    ``device`` (default: CUDA, raising without a card), where its results
    stay.
    """

    def __init__(self, centroids, counts=None, *,
                 policy: BucketPolicy = BucketPolicy(),
                 refresh_backend: str = "fused", device=None):
        self.device = resolve_device(device)
        self.centroids = as_float(centroids, self.device)
        k = self.centroids.shape[0]
        self.counts = (torch.zeros((k,), dtype=torch.float32,
                                   device=self.device) if counts is None
                       else as_weights(counts, self.device))
        self.policy = policy
        self.refresh_backend = refresh_backend
        self.refresh_sse: list[float] = []    # each refresh's batch SSE
        self.trace_counts: dict[int, int] = {}
        self._fns: dict[int, object] = {}     # bucket -> assign callable
        self._queue: deque = deque()          # (_Ticket, queries)
        self._results: dict[int, tuple] = {}
        self._next_ticket = 0

    def _fn_for(self, bucket: int):
        """The bucket's one assign callable, built at its first use with the
        spec the tuning cache holds for (bucket, d, k, the centroids'
        dtype).  The centroids are an argument, so a refresh builds
        nothing."""
        fn = self._fns.get(bucket)
        if fn is None:
            k, d = self.centroids.shape
            spec = tuning.lookup_spec(bucket, d, k, self.centroids.dtype,
                                      device=self.device)
            fn = functools.partial(ops.lloyd_assign_fused, spec=spec)
            self._fns[bucket] = fn
            self.trace_counts[bucket] = self.trace_counts.get(bucket, 0) + 1
        return fn

    def _assign_bucketed(self, queries):
        """One chunk (rows <= the top bucket) -> (labels, mind), through its
        bucket."""
        n = queries.shape[0]
        bucket = self.policy.bucket_for(n)
        padded = queries
        if bucket > n:
            pad = torch.zeros((bucket - n, queries.shape[1]),
                              dtype=queries.dtype, device=queries.device)
            padded = torch.cat([queries, pad])
        labels, mind = self._fn_for(bucket)(padded, self.centroids)
        return labels[:n], mind[:n]

    def assign(self, queries):
        """Nearest centroids of one batch ``(n,d)`` -> ``(labels (n,) i32,
        mind (n,) f32)``.  Batches above the top bucket go in chunks of the
        top bucket, so no n builds a new callable."""
        queries = as_float(queries, self.device)
        n = queries.shape[0]
        top = self.policy.top
        if n <= top:
            return self._assign_bucketed(queries)
        parts = [self._assign_bucketed(queries[i:i + top])
                 for i in range(0, n, top)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def submit(self, queries) -> int:
        """Queue a batch for the next coalesced dispatch -> its ticket."""
        queries = as_float(queries, self.device)
        t = self._next_ticket
        self._next_ticket += 1
        self._queue.append((_Ticket(t, queries.shape[0]), queries))
        return t

    def step(self) -> list[int]:
        """One dispatch: take queued batches first in first out while they
        fit the top bucket together (the first one always, chunked by
        :meth:`assign` if it is larger), run them as one batch -> the
        tickets completed.  The rest wait for the next step."""
        if not self._queue:
            return []
        taken, rows = [], 0
        top = self.policy.top
        while self._queue and (not taken
                               or rows + self._queue[0][0].n <= top):
            tk, q = self._queue.popleft()
            taken.append((tk, q))
            rows += tk.n
        labels, mind = self.assign(
            torch.cat([q for _, q in taken]) if len(taken) > 1
            else taken[0][1])
        off = 0
        done = []
        for tk, _ in taken:
            self._results[tk.ticket] = (labels[off:off + tk.n],
                                        mind[off:off + tk.n])
            off += tk.n
            done.append(tk.ticket)
        return done

    def result(self, ticket: int):
        """Pop a completed ticket's ``(labels, mind)``; ``KeyError`` if it
        is not ready."""
        return self._results.pop(ticket)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def refresh(self, batch, weights=None):
        """Fold one sampled batch into the served centroids (one
        ``update_minibatch`` on ``refresh_backend``) -> the batch's SSE
        against the centroids it arrived at (also appended to
        ``refresh_sse``, a host read).  A rising series is the signal to
        schedule a full solve."""
        new_c, new_counts, sse = update_minibatch(
            batch, self.centroids, self.counts, weights,
            params=KMeansParams(backend=self.refresh_backend),
            device=self.device)
        self.centroids = new_c
        self.counts = new_counts
        self.refresh_sse.append(float(sse))
        return sse
