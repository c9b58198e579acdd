"""The port's distributed pipeline (``repro_torch.distributed``,
``ipkmeans_distributed``, ``pkmeans_sharded``, the sharded S1 and
k-means||, the a2a pack, int8 error feedback) against the JAX reference.

One gloo world of 4 ranks on the CPU (``distributed/world.py``) is started
once for the module and runs every scenario (``torch_dist_ranks.run``,
which imports no JAX); the JAX reference, and the port's single-process
runs, are computed here while the ranks work.  The inputs are made with
numpy and JAX keys and written to ``tmp_path`` for the ranks.  The world
has its own deadline, so a hang fails in about a minute.

Meshes: the flat ``(4,)`` mesh ``("data",)`` and the ``(2, 2)`` pod mesh
``("pods", "data")``.  Data: ``paper_dataset_3000(0)`` and its first
group of initial centroids, K = 5 (the input of
``tests/test_multidevice.py``).

Tolerances, each the reference's own bar: subset ids, region ids,
iteration counts and packs exact; the flat mesh against the port's
single-process run bit for bit (intermediate centroids, iterations); final
centroids rtol 1e-5 against the reference (and atol 1e-5 on the pod path,
``tests/test_multidevice.py:108-139``); the per-pod S2 slices rtol 1e-5
with iterations exact; int8ef against the reference's int8ef pod run
(its bar against exact, 1e-3, fails for the reference on this input);
PKMeans rtol 1e-5 with iterations exact; compression as the reference's
compiled program computes it (``tests/test_torch_compress.py``).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.core import kdtree as jkd
from repro.core.ipkmeans import IPKMeansConfig as JConfig
from repro.core.ipkmeans import _merge_stage as j_merge_stage
from repro.core.ipkmeans import _s2_cross_pod_solve as j_s2_cross_pod
from repro.core.ipkmeans import ipkmeans as jipkmeans
from repro.core.ipkmeans import ipkmeans_distributed as jipkmeans_dist
from repro.core.kmeans import KMeansParams as JParams
from repro.core.kmeans import KMeansResult as JResult
from repro.core.kmeans import kmeans_batched as jkmeans_batched
from repro.core.pkmeans import pkmeans as jpkmeans
from repro.core.pkmeans import pkmeans_sharded as jpkmeans_sharded
from repro.data import initial_centroid_groups, paper_dataset_3000
from repro.distributed import compress as jcompress
from repro.distributed.sharding import kmeans_pod_mesh as j_pod_mesh
from repro import compat
from repro_torch.core import init, kdtree
from repro_torch.core.ipkmeans import a2a_pod_capacity, ipkmeans
from repro_torch.distributed import comm, world
from repro_torch.kernels import ref

P = 4
RTOL = ATOL = 1e-5
# seconds before the world is killed (its own run takes about 15-20 s)
WORLD_DEADLINE = 90.0
KPAR_KEY = jax.random.key(5)


def _kpar_draws(key, n, k, rounds):
    """The uniforms the reference's k-means|| consumes from ``key``."""
    keys = jax.random.split(key, rounds + 3)
    rows = [jax.random.uniform(keys[2 + r], (n,), jnp.float32)
            for r in range(rounds + 1)]
    k0, kk = jax.random.split(keys[1])
    rec = [jax.random.uniform(k0, ())]
    for _ in range(1, k):
        kk, sub = jax.random.split(kk)
        rec.append(jax.random.uniform(sub, ()))
    return (np.array(jax.random.uniform(keys[0], ())),
            np.array(jnp.stack(rows)), np.array(jnp.stack(rec)))


def _inputs() -> dict:
    pts, _ = paper_dataset_3000(0)
    pts = np.asarray(pts, np.float32)
    init0 = np.asarray(initial_centroid_groups(pts, ranks.K, groups=1)[0],
                       np.float32)
    n = pts.shape[0]
    first, rounds, rec = _kpar_draws(KPAR_KEY, n, ranks.K,
                                     init.default_rounds(n, ranks.K))
    rng = np.random.default_rng(0)
    ties = rng.normal(size=(777, 3)).astype(np.float32)
    ties[50:150, 0] = ties[0, 0]                  # duplicate coords: ties
    z = dict(pts=pts, init=init0, kpar_first=first, kpar_rounds=rounds,
             kpar_recluster=rec, s1_ties=ties,
             s1_equal=np.ones((256, 2), np.float32),
             pk_mask=np.random.default_rng(1).random(n) > 0.1,
             sample_u=np.random.default_rng(2).random(ranks.SORTED_N)
             .astype(np.float32),
             ef_sums=(rng.normal(size=(2, 4, ranks.K, 2)) * 100).astype(
                 np.float32),
             ef_counts=rng.integers(0, 60, (2, 4, ranks.K)).astype(
                 np.float32))
    z["ef_counts"][0, 1] = 0.0                    # an all-zero counts row
    z["ef_sums"][1, 2, 3] = 0.0                   # an all-zero sums row
    for case in ("ties", "equal"):
        for depth in (0, 3):
            z[f"s1_{case}_region{depth}"] = kdtree.build_kdtree_histogram(
                torch.from_numpy(z[f"s1_{case}"]), depth).numpy()
    return z


def _jcfg(m, **kw):
    return JConfig(num_clusters=ranks.K, num_subsets=m, **kw)


def _s1_reference(z) -> dict:
    out = {}
    for case in ("ties", "equal"):
        x = jnp.asarray(z[f"s1_{case}"])
        for depth in (0, 3):
            region = jkd.build_kdtree_histogram(x, depth)
            out[case, depth] = (np.asarray(region), np.asarray(
                jkd.label_regions_histogram(x, region, jax.random.key(7),
                                            2 ** depth, 4)))
    return out


def _s2_reference(z, reduce):
    """The reference's cross-pod S2 under ``jax.vmap(axis_name="pods")``,
    compiled ahead for the ranks' slices: ``(pods, M, S_loc, d)``, the two
    data columns' subsets side by side."""
    cfg = _jcfg(ranks.M_POD, reduce=reduce)
    n, d = z["pts"].shape
    s_loc = a2a_pod_capacity(ranks.pod_cfg().subset_capacity(n), 2) // 2
    fn = jax.vmap(lambda s, m: j_s2_cross_pod(s, m, jnp.asarray(z["init"]),
                                              cfg, "pods"), axis_name="pods")
    return jax.jit(fn).lower(
        jax.ShapeDtypeStruct((2, ranks.M_POD, s_loc, d), jnp.float32),
        jax.ShapeDtypeStruct((2, ranks.M_POD, s_loc), jnp.bool_)).compile()


def _pod_reference(z) -> dict:
    """The reference's single-process IPKMeans with the histogram S1, and
    its (2, 2) pod runs: its pack, S2 and merge stage by stage, the pod
    runs its ``_s2_cross_pod_solve`` under ``jax.vmap(axis_name="pods")``,
    each pod the capacity slice its ``shard_map`` gives it.  (On this input
    these are the numbers of the reference's ``ipkmeans_distributed`` on a
    real 2 x 2 mesh of four devices.)  The subset ids are the port's
    single-device histogram S1's, which is the reference's bit for bit
    (``tests/test_torch_s1.py``, and the sharded cases below): the
    reference's depth-9 build would compile for longer than this whole
    file runs."""
    pts, init0 = jnp.asarray(z["pts"]), jnp.asarray(z["init"])
    cfg = _jcfg(ranks.M_POD).with_s1("histogram")
    part = kdtree.partition_dataset(torch.from_numpy(z["pts"]), ranks.M_POD,
                                    builder="histogram", labeler="histogram")
    sub, msk = jkd.pack_subsets(pts, jnp.asarray(part.subset_ids.numpy()),
                                ranks.M_POD, cfg.subset_capacity(len(pts)))
    res = jkmeans_batched(sub, msk, init0, cfg.kmeans)
    out = {"single": (res, j_merge_stage(pts, res, cfg)),
           "scatter": (sub, msk)}
    m, s, d = sub.shape
    pod_sub = jnp.transpose(sub.reshape(m, 2, s // 2, d), (1, 0, 2, 3))
    pod_msk = jnp.transpose(msk.reshape(m, 2, s // 2), (1, 0, 2))
    for reduce in ("exact", "int8ef"):
        rcfg = cfg.with_reduce(reduce)
        c, sse, asse, iters, conv = jax.jit(jax.vmap(
            lambda a, b: j_s2_cross_pod(a, b, init0, rcfg, "pods"),
            axis_name="pods"))(pod_sub, pod_msk)
        res = JResult(c[0], sse[0], asse[0], iters[0], conv[0])
        out[reduce] = (res, j_merge_stage(pts, res, rcfg))
    return out


def _ef_reference(z) -> list:
    """Two compiled ``ef_allreduce`` calls over two pods, the residual
    carried."""
    axes = {"sums": -1, "counts": -1}
    stats = {"sums": jnp.asarray(z["ef_sums"]),
             "counts": jnp.asarray(z["ef_counts"])}
    state = jax.vmap(jcompress.init_ef)(stats)
    fn = jax.jit(jax.vmap(lambda t, s: jcompress.ef_allreduce(
        t, s, "pods", axes=axes, return_error_bound=True), axis_name="pods"))
    out = []
    for _ in range(2):
        red, state, err = fn(stats, state)
        out.append((red, state.residual, err))
    return out


def _references(z) -> dict:
    """The reference's results (compiled in threads: XLA compiles in
    parallel) and the port's single-process ones."""
    pts, init0 = jnp.asarray(z["pts"]), jnp.asarray(z["init"])
    key = jax.random.key(0)
    jobs = {
        "flat": lambda: jipkmeans(pts, init0, key, _jcfg(ranks.M_FLAT)),
        "pod": lambda: _pod_reference(z),
        "pk": lambda: jpkmeans(pts, init0, jnp.asarray(z["pk_mask"]),
                               JParams(max_iters=ranks.PK_PARAMS.max_iters)),
        "s1": lambda: _s1_reference(z),
        "s2_exact": lambda: _s2_reference(z, "exact"),
        "s2_int8ef": lambda: _s2_reference(z, "int8ef"),
        "ef": lambda: _ef_reference(z),
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        out = _port_references(z)
        out["errors"] = _reference_errors(pts, init0)
        out.update({name: f.result() for name, f in futures.items()})
    return out


def _port_references(z) -> dict:
    """The port's single-process runs of the same inputs."""
    tp, ti = torch.from_numpy(z["pts"]), torch.from_numpy(z["init"])
    out = {"port_flat": ipkmeans(tp, ti, ranks.flat_cfg(), device="cpu"),
           "port_flat_hist": ipkmeans(tp, ti, ranks.flat_cfg(s1="histogram"),
                                      device="cpu")}
    draws = init.KMeansParallelDraws(*(torch.from_numpy(z[f"kpar_{f}"])
                                       for f in init.KMeansParallelDraws
                                       ._fields))
    out["port_kpar"] = ipkmeans(tp, None, ranks.flat_cfg().with_init(
        "kmeans||"), draws=draws, device="cpu")
    out["port_sorted"] = ipkmeans(tp[:ranks.SORTED_N], None,
                                  ranks.sorted_cfg(), draws=z["sample_u"],
                                  device="cpu")
    # the single-process k-means|| rounds, each sweep's inputs and outputs
    sweeps = []

    def spy(*a, **kw):
        res = ref_sweep(*a, **kw)
        sweeps.append((a[3], a[4], kw["ell"], res))
        return res

    ref_sweep = ref.init_sweep_ref
    with mock.patch.object(ref, "init_sweep_ref", spy):
        seeds, stats = init.kmeans_parallel_init(
            tp, ranks.K, backend="plain", draws=draws, return_stats=True)
    out["port_kpar_seeds"] = (seeds, stats, sweeps)
    return out


def _reference_errors(pts, init0) -> dict:
    """The reference's messages for the validations a one-device mesh can
    reach (the subsets check needs more devices: its format is used)."""
    mesh = compat.make_mesh((1,), ("data",))
    key = jax.random.key(0)
    cfg = _jcfg(ranks.M_FLAT)

    def err(fn, kind=ValueError):
        with pytest.raises(kind) as e:
            fn()
        return f"{kind.__name__}: {e.value}"

    return {
        "subsets": f"ValueError: num_subsets=6 not divisible by mesh size "
                   f"{P}",
        "pod_in_axes": err(lambda: jipkmeans_dist(
            pts, init0, key, cfg, mesh, ("data",), pod_axis="data")),
        "pod_missing": err(lambda: jipkmeans_dist(
            pts, init0, key, cfg, mesh, ("data",), pod_axis="pods")),
        "reduce": err(lambda: jipkmeans_dist(
            pts, init0, key, cfg.with_reduce("int8ef"), mesh, ("data",))),
        "pod_reseed": err(lambda: jipkmeans_dist(
            pts, init0, key, dataclasses.replace(
                _jcfg(ranks.M_POD), kmeans=JParams(reseed_empty=True)),
            j_pod_mesh(1, 1), ("data",), pod_axis="pods")),
        "pk_reseed": err(lambda: jpkmeans_sharded(
            mesh, ("data",), JParams(reseed_empty=True)),
            NotImplementedError),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    z = _inputs()
    path = tmp_path_factory.mktemp("dist") / "inputs.npz"
    np.savez(path, **z)
    w = world.start(ranks.run, P, args=(str(path),), device="cpu",
                    deadline=WORLD_DEADLINE)
    try:
        refs = _references(z)
    except BaseException:
        w.close()
        raise
    return z, refs, w.join()


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_results_replicated_on_every_rank(run):
    _, _, outs = run
    for key in ("flat", "flat_a2a", "flat_kpar", "flat_sorted", "pod_exact",
                "pod_int8ef", "pkmeans"):
        for r in range(1, P):
            for f in ("centroids", "sse"):
                assert torch.equal(outs[r][key][f], outs[0][key][f]), (key, r)


def test_flat_matches_reference(run):
    _, refs, outs = run
    got, want = outs[0]["flat"], refs["flat"]
    _close(got["centroids"], want.centroids)
    np.testing.assert_array_equal(got["subset_iters"],
                                  np.asarray(want.subset_iters))
    assert got["kd_depth"] == want.kd_depth


@pytest.mark.parametrize("key,single", [("flat", "port_flat"),
                                        ("flat_a2a", "port_flat_hist"),
                                        ("flat_sorted", "port_sorted")])
def test_flat_is_the_single_process_run_and_s2_has_no_collective(run, key,
                                                                 single):
    """S2 of the flat mesh issues no collective; its lanes are the
    single-process run's bit for bit: with the sort S1 and the scatter
    pack; with the sharded histogram S1 and the a2a pack (which keeps
    each subset's point order, so it packs what the scatter pack packs);
    and with seeds drawn by ``init="sample"`` and the sorted pack."""
    _, refs, outs = run
    got, want = outs[0][key], refs[single]
    assert torch.equal(got["intermediate"], want.intermediate)
    assert torch.equal(got["subset_iters"], want.subset_iters)
    assert torch.equal(got["centroids"], want.centroids)
    _close(got["sse"], want.sse)
    assert "s2" not in got["comm"]
    assert got["comm"]["s3"]["calls"] == 2    # the results, then the SSE


def test_flat_kmeans_parallel_matches_single_process(run):
    """The sharded k-means|| sweeps: the potential is a sum in another
    order, so a draw ``u * psi_prev < ell * mind`` could move at a row on
    its boundary; count such rows, then hold the seeds and the whole run to
    the single-process port's bit for bit."""
    _, refs, outs = run
    seeds, stats, sweeps = refs["port_kpar_seeds"]
    got = outs[0]["kpar_seeds"]
    _close(got["psi"], stats["psi"], rtol=1e-6)
    boundary = 0
    for r in range(1, len(sweeps)):
        u, _, ell, (mind, _, _) = sweeps[r]
        one, two = (torch.tensor(p, dtype=torch.float32)
                    for p in (stats["psi"][r - 1], got["psi"][r - 1]))
        boundary += int(torch.sum((u * one < ell * mind)
                                  != (u * two < ell * mind)))
    assert boundary == 0
    assert got["candidates"] == stats["candidates"]
    assert torch.equal(got["seeds"], seeds)
    run_d, run_s = outs[0]["flat_kpar"], refs["port_kpar"]
    assert torch.equal(run_d["intermediate"], run_s.intermediate)
    assert torch.equal(run_d["subset_iters"], run_s.subset_iters)
    assert outs[0]["flat_kpar"]["comm"]["init"]["calls"] > 0


def test_pod_exact_matches_reference(run):
    """The (2, 2) pod path with the exact reduction against the reference's
    single-process IPKMeans with the histogram S1 (its own bar), and
    against the reference's pod run: lane iterations exact."""
    _, refs, outs = run
    got = outs[0]["pod_exact"]
    single, (final, _) = refs["pod"]["single"]
    _close(got["centroids"], final, atol=ATOL)
    pod, (pod_final, pod_sse) = refs["pod"]["exact"]
    np.testing.assert_array_equal(got["subset_iters"],
                                  np.asarray(pod.iters))
    _close(got["centroids"], pod_final, atol=ATOL)
    _close(got["sse"], pod_sse)


def test_int8ef_is_the_reference_s_int8ef(run):
    """The pod path with int8 error feedback against the reference's pod
    run with it: lane iterations exact, centroids and SSE within rtol
    1e-5.  The reference's bar for int8ef's SSE against exact's (1e-3,
    ``tests/test_multidevice.py:108-139``) does not hold on this input for
    the reference itself (3.457e-3: its noise floor stops lanes early), so
    the port's departure from exact is held to the reference's."""
    _, refs, outs = run
    got, ex = outs[0]["pod_int8ef"], outs[0]["pod_exact"]
    res, (final, sse) = refs["pod"]["int8ef"]
    np.testing.assert_array_equal(got["subset_iters"], np.asarray(res.iters))
    _close(got["centroids"], final, atol=ATOL)
    _close(got["sse"], sse)
    want = float(sse) / float(refs["pod"]["exact"][1][1]) - 1.0
    rel = float(got["sse"]) / float(ex["sse"]) - 1.0
    assert abs(rel - want) <= 1e-5, (rel, want)


@pytest.mark.parametrize("reduce", ["exact", "int8ef"])
def test_pod_s2_slices_match_reference(run, reduce):
    """Each rank's slice of the pod a2a pack, solved by the port's
    cross-pod S2, against the reference's ``_s2_cross_pod_solve`` on the
    same slices under ``jax.vmap(axis_name="pods")`` (the two data columns'
    subsets side by side: lanes are independent)."""
    _, refs, outs = run
    cols = P // 2
    coord = [o["pod_coord"] for o in outs]
    rank_of = {c: r for r, c in enumerate(coord)}

    def stack(field):
        return np.stack([np.concatenate(
            [np.asarray(outs[rank_of[p, j]]["a2a_pod"][field])
             for j in range(cols)]) for p in range(2)])

    c, sse, asse, iters, conv = refs[f"s2_{reduce}"](
        jnp.asarray(stack("sub")), jnp.asarray(stack("msk")))
    m_loc = outs[0]["a2a_pod"]["sub"].shape[0]
    for r, (p, j) in enumerate(coord):
        got = outs[r][f"s2_{reduce}"]
        lanes = slice(j * m_loc, (j + 1) * m_loc)
        np.testing.assert_array_equal(got["iters"],
                                      np.asarray(iters[p, lanes]))
        np.testing.assert_array_equal(got["conv"], np.asarray(conv[p, lanes]))
        _close(got["c"], c[p, lanes], atol=ATOL)
        _close(got["sse"], sse[p, lanes])
        _close(got["asse"], asse[p, lanes])


def test_pod_s2_reduces_once_a_trip(run):
    """One reduction over the pods a Lloyd trip: exact one f32 all-reduce
    of the active lanes' (sums, counts), int8ef two all-gathers (the int8
    values, then the f32 scales); then one all-reduce of the (SSE,
    count)."""
    _, _, outs = run
    ex, q = outs[0]["s2_exact"], outs[0]["s2_int8ef"]
    assert ex["comm"]["other"]["calls"] == int(ex["iters"].max()) + 1
    assert q["comm"]["other"]["calls"] == 2 * int(q["iters"].max()) + 1
    ef = outs[0]["ef"][0]["comm"]["other"]
    m, k, d = outs[0]["ef"][0]["red"]["sums"].shape
    # int8 values, then an f32 scale a sums row and a counts vector: at
    # d = 2 that is 0.65 of exact's 4 (m k d + m k) bytes, at d = 64 0.27
    assert ef == {"calls": 2,
                  "bytes": (m * k * d + m * k) + 4 * (m * k + m)}


def test_sharded_s1_is_the_single_device_s1(run):
    """Forced ties, all points equal, depth 0 and 3, on the pod mesh (rows
    over both axes): region ids and subset ids of the row blocks, in rank
    order, are the reference's bit for bit (row blocks of 777 / 4 leave the
    last one short)."""
    _, refs, outs = run
    per_rank = [o["s1_cases"] for o in outs]
    for i, (case, depth, _, _) in enumerate(per_rank[0]):
        region = torch.cat([pr[i][2] for pr in per_rank]).numpy()
        label = torch.cat([pr[i][3] for pr in per_rank]).numpy()
        want_r, want_l = refs["s1"][case, depth]
        np.testing.assert_array_equal(region, want_r, err_msg=str(
            (case, depth)))
        np.testing.assert_array_equal(label, want_l, err_msg=str(
            (case, depth)))


def test_pod_a2a_pack_holds_each_subset(run):
    """Nothing dropped, and each subset's points over the two pods are the
    reference's scatter pack's (as sets of rows: each pod packs its own
    points)."""
    z, refs, outs = run
    assert all("s1" in o["a2a_pod"]["comm"] for o in outs)
    want_p, want_m = (np.asarray(t) for t in refs["pod"]["scatter"])
    total = sum(int(o["a2a_pod"]["msk"].sum()) for o in outs)
    assert total == z["pts"].shape[0]
    coord = [o["pod_coord"] for o in outs]
    m_loc = outs[0]["a2a_pod"]["sub"].shape[0]
    for s in range(ranks.M_POD):
        j, lane = divmod(s, m_loc)
        rows = [o["a2a_pod"]["sub"][lane][o["a2a_pod"]["msk"][lane]].numpy()
                for o, (_, col) in zip(outs, coord) if col == j]
        got = np.concatenate(rows)
        want = want_p[s][want_m[s]]
        np.testing.assert_array_equal(got[np.lexsort(got.T)],
                                      want[np.lexsort(want.T)])


def test_pkmeans_sharded_matches_reference(run):
    """One all-reduce of K * d + K floats a trip, and the reference's
    centroids, SSE and iterations."""
    _, refs, outs = run
    got, want = outs[0]["pkmeans"], refs["pk"]
    assert int(got["iters"]) == int(want.iters)
    assert bool(got["converged"]) == bool(want.converged)
    _close(got["centroids"], want.centroids)
    _close(got["sse"], want.sse)
    k, d = got["centroids"].shape
    trips = int(got["iters"])
    assert got["comm"]["pkmeans"] == {"calls": trips,
                                      "bytes": trips * 4 * (k * d + k)}
    assert got["comm"]["sse"]["calls"] == 1


def test_ef_allreduce_matches_reference(run):
    """Two calls over the pod group, the residual carried, against the
    reference's ``ef_allreduce`` under ``jax.vmap(axis_name="pods")``,
    compiled as the reference's S2 loop compiles it.  The error bound (the
    scales) bit for bit.  The reduced tree and the residual hold a product
    ``q * scale`` that the port rounds once with its sum (a fused
    multiply-add, as the compiled reference does); the reference's compiled
    code rounds it once in its vector loop and twice in the loop's
    remainder, so an element may differ by the rounding of that product:
    at most the float32 spacing of the largest input it sums."""
    z, refs, outs = run
    for call, (red, residual, err) in enumerate(refs["ef"]):
        for o in outs:
            p = o["pod_coord"][0]
            got = o["ef"][call]
            for leaf in ("sums", "counts"):
                msg = f"call {call} {leaf}"
                np.testing.assert_array_equal(
                    got["err"][leaf].numpy(), np.asarray(err[leaf][p]),
                    err_msg=msg)
                spacing = np.spacing(np.abs(z[f"ef_{leaf}"]).max(axis=0)
                                     + np.abs(np.asarray(red[leaf][p])))
                for mine, theirs in ((got["red"], red),
                                     (got["residual"], residual)):
                    diff = np.abs(mine[leaf].numpy()
                                  - np.asarray(theirs[leaf][p]))
                    assert np.all(diff <= spacing), msg


def test_validation_errors_are_the_reference_s(run):
    _, refs, outs = run
    for name, want in refs["errors"].items():
        assert outs[0]["errors"][name] == want, name


def test_stage_times_only_when_asked():
    """``comm.stage`` times its block (draining the card at both ends) only
    after ``comm.reset(timed=True)``; a plain ``reset`` turns it off."""
    comm.reset()
    with comm.stage("s2"):
        pass
    assert comm.seconds == {} and comm.read() == {}
    comm.reset(timed=True)
    with comm.stage("s2"):
        pass
    assert list(comm.seconds) == ["s2"] and comm.seconds["s2"] >= 0.0
    comm.reset()
    with comm.stage("s2"):
        pass
    assert comm.seconds == {}
