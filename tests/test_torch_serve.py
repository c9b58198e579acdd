"""The port's serving tier against the reference's: ``BucketPolicy``, the
bucketed (zero-padded) assign, the coalescing dispatch, the mini-batch
refresh (``update_minibatch``, ``ref.minibatch_update_ref``), the tuning
cache's lookup and the ``tuned`` engine, and the ``serve_kmeans`` launcher,
all on the CPU path of each package.

The same numpy inputs, made from a seed, go to both packages, at one shape
(d = 6, k = 12, buckets up to 64), so that each reference program compiles
once; the reference runs its jnp oracles and its ``jnp`` engine, and its
server (whose assign is its Pallas kernel in interpret mode) on one bucket.
Tolerances: bucket policies, tickets, labels and counts exact; padded and
unpadded assigns of the port bit for bit; refreshed centroids rtol 1e-6,
SSE rtol 1e-5 (float32 sums in another order), centres the batch never
touched bit for bit; tuning-cache keys and specs exact.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KMeansParams as JParams
from repro.core import serve as jserve
from repro.core import update_minibatch as jupdate_minibatch
from repro.core.serve import BucketPolicy as JPolicy
from repro.core.serve import NearestCentroidServer as JServer
from repro.kernels import ref as jref
from repro.kernels import specs as jspecs
from repro.kernels import tuning as jtuning
from repro_torch import BucketPolicy, KMeansParams, NearestCentroidServer
from repro_torch import update_minibatch
from repro_torch.kernels import engine, ops, ref, specs, tuning
from repro_torch.launch import serve_kmeans

D, K = 6, 12
POLICY = BucketPolicy(min_bucket=8, max_bucket=64)
ENGINES = ["eager", "twopass", "fused"]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, D)) * 3.0).astype(np.float32)


def _centroids(seed=100):
    return _data(K, seed)


def _cpu_server(c=None, **kw):
    return NearestCentroidServer(_centroids() if c is None else c,
                                 policy=kw.pop("policy", POLICY),
                                 device="cpu", **kw)


# ------------------------------------------------------------- buckets --

@pytest.mark.parametrize("kw", [dict(min_bucket=8, max_bucket=128),
                                dict(min_bucket=3, max_bucket=40),
                                dict(kind="fixed", ladder=(32, 256)),
                                dict(kind="fixed", ladder=(5, 6, 50))],
                         ids=["pow2", "pow2_odd", "fixed", "fixed3"])
def test_bucket_policy_matches_reference(kw):
    def outcome(policy, n):
        try:
            return policy.bucket_for(n)
        except ValueError as e:
            return str(e)

    ours, theirs = BucketPolicy(**kw), JPolicy(**kw)
    assert ours.top == theirs.top and ours.buckets() == theirs.buckets()
    got = [outcome(ours, n) for n in range(ours.top + 2)]
    assert got == [outcome(theirs, n) for n in range(theirs.top + 2)]
    assert isinstance(got[0], str) and isinstance(got[-1], str)
    for bad in (dict(kind="fixed"), dict(kind="pow3")):
        assert (outcome(BucketPolicy(**bad), 4)
                == outcome(JPolicy(**bad), 4))


@pytest.fixture(scope="module")
def queries():
    """150 query rows (each test takes a prefix) and the reference's labels
    of them, one reference call at one shape."""
    q, c = _data(150, seed=150), _centroids()
    return q, np.asarray(jref.assign_ref(jnp.asarray(q), jnp.asarray(c))[0])


@pytest.mark.parametrize("n", [1, 3, 8, 17, 64, 100, 150])
def test_padded_assign_is_unpadded_bit_for_bit(n, queries):
    q, c = queries[0][:n], _centroids()
    server = _cpu_server(c)
    labels, mind = server.assign(q)
    labels0, mind0 = ops.lloyd_assign_fused(torch.from_numpy(q),
                                            torch.from_numpy(c))
    assert torch.equal(labels, labels0) and torch.equal(mind, mind0)
    assert labels.dtype == torch.int32 and labels.device.type == "cpu"
    np.testing.assert_array_equal(labels.numpy(), queries[1][:n])


def test_each_bucket_is_built_once_under_a_mixed_stream():
    server = _cpu_server()
    sizes = [3, 9, 17, 64, 150, 5, 33, 9, 3, 12, 64, 1, 40, 150]
    for i, n in enumerate(sizes):
        server.assign(_data(n, seed=i))
    assert set(server.trace_counts) == {8, 16, 32, 64}
    assert all(v == 1 for v in server.trace_counts.values())


def test_coalesced_dispatch_is_direct_and_keeps_the_reference_fifo(
        monkeypatch):
    # the reference server's assign is its Pallas kernel; its jnp oracle
    # gives the same labels and compiles in a fraction of the time
    monkeypatch.setattr(jserve.ops, "lloyd_assign_fused",
                        lambda q, c, spec=None: jref.assign_ref(q, c))
    c = _centroids()
    one = BucketPolicy(min_bucket=64, max_bucket=64)
    ours = _cpu_server(c, policy=one)
    theirs = JServer(jnp.asarray(c), policy=JPolicy(min_bucket=64,
                                                     max_bucket=64))
    sizes = [4, 7, 11, 60, 70, 2]
    qs = [_data(n, seed=50 + i) for i, n in enumerate(sizes)]
    tickets = [ours.submit(q) for q in qs]
    assert tickets == [theirs.submit(jnp.asarray(q)) for q in qs]
    steps, jsteps = [], []
    while ours.pending:
        steps.append(ours.step())
        jsteps.append(theirs.step())
    assert steps == jsteps and theirs.pending == 0 and ours.step() == []
    assert steps == [[0, 1, 2], [3], [4], [5]]  # 70 rows: chunked alone
    for t, q in zip(tickets, qs):
        labels, mind = ours.result(t)
        l0, m0 = ours.assign(q)
        assert torch.equal(labels, l0) and torch.equal(mind, m0)
    with pytest.raises(KeyError):
        ours.result(tickets[0])                 # results pop once
    assert ours.trace_counts == {64: 1}


def test_step_leaves_an_overflow_queued():
    server = _cpu_server(policy=BucketPolicy(min_bucket=8, max_bucket=16))
    t1 = server.submit(_data(10, seed=1))
    t2 = server.submit(_data(12, seed=2))      # 22 rows > the top bucket
    assert server.step() == [t1] and server.pending == 1
    assert server.step() == [t2] and server.pending == 0


# ---------------------------------------------------- mini-batch refresh --

def _batch():
    x = _data(97, seed=7)
    c = _centroids()
    c[3] = 1e4                                  # a centre no row reaches
    counts = (np.abs(np.random.default_rng(8).normal(size=K)) * 10.0
              ).astype(np.float32)
    mask = (np.arange(97) < 70).astype(np.float32)
    return x, c, counts, mask


def _centroids_close(got, want, rtol=1e-6):
    """Each coordinate within ``rtol`` of its centroid's largest one: the
    sums behind a coordinate near 0 cancel, so its own size is no scale."""
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * scale), np.abs(got - want).max()


@pytest.fixture(scope="module")
def reference_refresh():
    x, c, counts, mask = _batch()
    want = {}
    for masked in (False, True):
        m = jnp.asarray(mask) if masked else None
        oracle = jref.minibatch_update_ref(jnp.asarray(x), jnp.asarray(c),
                                           jnp.asarray(counts), m)
        entry = jupdate_minibatch(jnp.asarray(x), jnp.asarray(c),
                                  jnp.asarray(counts), m,
                                  params=JParams(backend="jnp"))
        want[masked] = [tuple(np.asarray(t) for t in out)
                        for out in (oracle, entry)]
    return want


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("backend", ENGINES)
def test_update_minibatch_matches_reference(backend, masked,
                                            reference_refresh):
    x, c, counts, mask = _batch()
    got = update_minibatch(x, c, counts, mask if masked else None,
                           KMeansParams(backend=backend), device="cpu")
    new_c, new_counts, sse = (t.numpy() for t in got)
    for want_c, want_counts, want_sse in reference_refresh[masked]:
        np.testing.assert_array_equal(new_counts, want_counts)
        _centroids_close(new_c, want_c)
        np.testing.assert_allclose(sse, want_sse, rtol=1e-5)
    assert np.array_equal(new_c[3], c[3]) and new_counts[3] == counts[3]
    if masked:                                  # the masked rows are ignored
        cut = update_minibatch(x[:70], c, counts,
                               params=KMeansParams(backend=backend),
                               device="cpu")
        assert torch.equal(cut[1], got[1])
        _centroids_close(cut[0].numpy(), new_c)
    # the plain oracle is the eager engine's arithmetic
    plain = ref.minibatch_update_ref(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(counts),
        torch.from_numpy(mask) if masked else None)
    _centroids_close(plain[0].numpy(), new_c)


@pytest.mark.parametrize("backend", ENGINES)
def test_update_minibatch_keeps_bf16_centroids(backend):
    x, c, counts, _ = _batch()
    cb = torch.from_numpy(c).to(torch.bfloat16)
    new_c, new_counts, sse = update_minibatch(
        x, cb, counts, params=KMeansParams(backend=backend), device="cpu")
    assert new_c.dtype == torch.bfloat16 and new_counts.dtype == torch.float32
    # rounded once, from the float32 merge of the bf16 centroids
    f32 = update_minibatch(x, cb.float(), counts,
                           params=KMeansParams(backend=backend), device="cpu")
    assert torch.equal(new_c, f32[0].to(torch.bfloat16))


def test_refresh_series_matches_reference_and_builds_nothing():
    c = _centroids()
    batches = [_data(96, seed=200 + i) + 0.5 * i for i in range(4)]
    ours = _cpu_server(c, refresh_backend="eager")
    theirs = JServer(jnp.asarray(c), refresh_backend="jnp")
    ours.assign(batches[0][:10])
    before = dict(ours.trace_counts)
    for b in batches:
        ours.refresh(b)
        theirs.refresh(jnp.asarray(b))
    np.testing.assert_allclose(ours.refresh_sse, theirs.refresh_sse,
                               rtol=1e-5)
    np.testing.assert_allclose(ours.centroids.numpy(),
                               np.asarray(theirs.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ours.counts.numpy(),
                                  np.asarray(theirs.counts))
    ours.assign(batches[1][:9])                 # same bucket, new size
    assert ours.trace_counts == before


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    x, c, counts, _ = _batch()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NearestCentroidServer(c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        update_minibatch(x, c, counts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_kmeans.main(["--smoke"])


# ---------------------------------------------------------- tuning cache --

@pytest.mark.parametrize("args", [
    ("NVIDIA H100 80GB HBM3", "float32", 300, 2, 5, None, None),
    ("cpu", "bfloat16", 4096, 64, 1024, None, None),
    ("cpu", "float32", 16384, 64, 1024, 512, None),
    ("TPU v5 lite", "float32", 1 << 23, 64, 2048, None, "init"),
    ("cpu", "float32", 100, 8, 300, 7, "init")],
    ids=["single", "bf16", "stack", "init", "stack_init"])
def test_cache_key_is_the_reference_key(args):
    kind, dt, n, d, k, m, kernel = args
    want = jtuning.cache_key(kind, getattr(jnp, dt), n, d, k, m=m,
                             kernel=kernel)
    assert tuning.cache_key(kind, getattr(torch, dt), n, d, k, m=m,
                            kernel=kernel) == want
    assert tuning.cache_key(kind, dt, n, d, k, m=m, kernel=kernel) == want
    assert tuning.n_bucket(n) == jtuning.n_bucket(n)


SPECS = [dict(), dict(block_n=64, block_k=64),
         dict(acc_dtype="bfloat16", block_n=512),
         dict(block_n=128, group_t=4)]


def test_caches_cross_between_the_packages(tmp_path):
    kind = specs.CPU_PROFILE.device_kind
    theirs = jtuning.TuningCache.load(tmp_path / "from_reference.json")
    ours = tuning.TuningCache.load(tmp_path / "from_port.json")
    for i, kw in enumerate(SPECS):
        key = tuning.cache_key(kind, torch.float32, 64 << i, D, K)
        theirs.put(key, jspecs.KernelSpec(**kw), time_us=1.5 * i)
        ours.put(key, specs.KernelSpec(**kw), time_us=1.5 * i)
    theirs.save(), ours.save()
    assert (json.loads(ours.path.read_text())
            == json.loads(theirs.path.read_text()))
    read_ours = tuning.TuningCache.load(theirs.path)
    read_theirs = jtuning.TuningCache.load(ours.path)
    for key in ours.entries:
        a, b = read_ours.get(key), read_theirs.get(key)
        assert (a.block_n, a.block_k, a.acc_dtype, a.group_t) == (
            b.block_n, b.block_k, b.acc_dtype, b.group_t)


def test_cache_ignores_a_wrong_version_and_garbage(tmp_path):
    vpath = tmp_path / "wrong_version.json"
    vpath.write_text(json.dumps({"version": 99, "entries": {"k": {}}}))
    with pytest.warns(UserWarning, match="version"):
        assert tuning.TuningCache.load(vpath).entries == {}
    gpath = tmp_path / "garbage.json"
    gpath.write_text("{not json")
    with pytest.warns(UserWarning, match="unreadable"):
        assert tuning.TuningCache.load(gpath).entries == {}
    mpath = tmp_path / "malformed_entry.json"
    mpath.write_text(json.dumps({
        "version": tuning.CACHE_VERSION,
        "entries": {"key": {"block_n": 7, "block_k": 64}}}))
    with pytest.warns(UserWarning, match="malformed"):
        assert tuning.TuningCache.load(mpath).get("key") is None


def _seed_cache(monkeypatch, tmp_path, spec, n=96, kernel=None):
    """A cache holding ``spec`` at (n, D, K) under the CPU's device kind
    (for the init sweep, at its candidate tile 32), made the active one."""
    cache = tuning.TuningCache.load(tmp_path / "kernel_specs.json")
    k = 32 if kernel == "init" else K
    cache.put(tuning.cache_key(specs.CPU_PROFILE.device_kind, torch.float32,
                               n, D, k, kernel=kernel), spec)
    cache.save()
    monkeypatch.setenv(tuning.ENV_CACHE_PATH, str(cache.path))
    tuning.reload_cache()


def test_lookup_of_an_unknown_device_kind_is_none(monkeypatch, tmp_path):
    _seed_cache(monkeypatch, tmp_path, specs.KernelSpec(block_n=64))
    assert tuning.lookup_spec(96, D, K, device="cpu") == specs.KernelSpec(
        block_n=64)
    assert tuning.lookup_spec(96, D, K, device_kind="weird chip 9000") is None
    assert tuning.lookup_spec(96, D, K + 1, device="cpu") is None


def _stack():
    x = torch.from_numpy(np.stack([_data(96, seed=300 + i)
                                   for i in range(2)]))
    return x, torch.from_numpy(_centroids()).expand(2, K, D).contiguous()


def test_tuned_engine_takes_the_cached_spec(monkeypatch, tmp_path):
    bf16 = specs.KernelSpec(acc_dtype="bfloat16")
    _seed_cache(monkeypatch, tmp_path, bf16)
    tuned, fused = engine.get_engine("tuned"), engine.get_engine("fused")
    x, c = _stack()
    assert "tuned" not in engine.LATER and set(engine.LATER) == {"pallas"}
    assert tuned.resolve_spec(x, c) == bf16
    got = tuned.step(x, c)
    want = ops.lloyd_step_fused(x, c, spec=bf16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    f32 = fused.step(x, c)
    assert not torch.equal(got[0], f32[0])      # the spec reached the pass
    labels, mind = tuned.assign(x, c)
    want_a = ops.lloyd_assign_fused(x, c, spec=bf16)
    assert torch.equal(labels, want_a[0]) and torch.equal(mind, want_a[1])


def test_tuned_engine_without_an_entry_is_resident(monkeypatch, tmp_path):
    monkeypatch.setenv(tuning.ENV_CACHE_PATH, str(tmp_path / "none.json"))
    tuning.reload_cache()
    x, c = _stack()
    kw = dict(max_iters=20, tol=1e-6, reseed_empty=True)
    got = engine.get_engine("tuned").solve_batched(x, c[0], **kw)
    want = engine.get_engine("resident").solve_batched(x, c[0], **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert engine.get_engine("tuned").resolve_spec(x, c) is None


def test_tuned_engine_refuses_a_spec_no_kernel_reads(monkeypatch, tmp_path):
    # a block_k the reference accepts but no score kernel is built for
    _seed_cache(monkeypatch, tmp_path, specs.KernelSpec(block_k=96))
    tuned = engine.get_engine("tuned")
    x, c = _stack()
    with pytest.raises(ValueError, match="built for block_k in"):
        tuned.step(x, c)
    with pytest.raises(ValueError, match="built for block_k in"):
        tuned.solve(x[0], c[0], max_iters=5, tol=1e-6)


def test_serving_bucket_takes_its_cached_spec(monkeypatch, tmp_path):
    bf16 = specs.KernelSpec(acc_dtype="bfloat16")
    _seed_cache(monkeypatch, tmp_path, bf16, n=64)
    q, c = _data(50, seed=9), _centroids()
    served = _cpu_server(c).assign(q)
    want = ops.lloyd_assign_fused(torch.from_numpy(q), torch.from_numpy(c),
                                  spec=bf16)
    f32 = ops.lloyd_assign_fused(torch.from_numpy(q), torch.from_numpy(c))
    assert torch.equal(served[1], want[1]) and not torch.equal(served[1],
                                                               f32[1])
    small = _cpu_server(c).assign(q[:20])      # bucket 32: no entry
    assert torch.equal(small[1], f32[1][:20])


def test_kmeans_parallel_takes_the_cached_init_spec(monkeypatch, tmp_path):
    from repro_torch.core.init import kmeans_parallel_init
    bf16 = specs.KernelSpec(acc_dtype="bfloat16")
    # the sweep's steady candidate tile at ell = 2k = 24: 32
    _seed_cache(monkeypatch, tmp_path, bf16, n=96, kernel="init")
    cache = json.loads((tmp_path / "kernel_specs.json").read_text())
    assert list(cache["entries"]) == [tuning.cache_key(
        specs.CPU_PROFILE.device_kind, "float32", 96, D, 32, kernel="init")]
    x = torch.from_numpy(_data(96, seed=11))

    def seeds(**kw):
        return kmeans_parallel_init(x, K, backend="kernel",
                                    generator=torch.Generator().manual_seed(0),
                                    return_stats=True, **kw)

    got, want = seeds(), seeds(spec=bf16)
    assert torch.equal(got[0], want[0]) and got[1]["psi"] == want[1]["psi"]
    assert got[1]["psi"] != seeds(spec=specs.DEFAULT_SPEC)[1]["psi"]


# -------------------------------------------------------------- launcher --

def test_serve_kmeans_smoke_on_the_cpu(capsys):
    server = serve_kmeans.main(["--smoke", "--device", "cpu"])
    assert len(server.refresh_sse) == 2
    assert all(v == 1 for v in server.trace_counts.values())
    assert server.centroids.shape == (8, 8)
    assert "rows/s" in capsys.readouterr().out
