"""The port's dry run (``launch/kmeans_dryrun.py``), its shape-only kernel
routes and its work counts, on the CPU.

The dry run traces the port's stage functions as rank 0 of a fake world
on fake CUDA tensors: no JAX compile and no card.  Its parity with the
reference is held where the two compute the same thing without a
compiler: the tree depth, the byte models, the variant table and its
record names, and the per-solve byte model.  The reference's variant table
and suffix rule are read from its source (``ast``): importing its
``launch/perf_variants.py`` would set ``XLA_FLAGS`` for 512 devices in
this process.
"""
import ast
import json
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from repro.core import io_model as jio
from repro.core import kdtree as jkdtree
from repro_torch import device as device_mod
from repro_torch.core import io_model, kdtree
from repro_torch.distributed import world
from repro_torch.kernels import (assign, batch_resident, centroid_update,
                                 fused, init, resident, specs)
from repro_torch.launch import dryrun, kmeans_dryrun, perf_variants

REFERENCE = Path(__file__).resolve().parents[1] / "src/repro/launch"
RECORD_KEYS = {"arch", "shape", "mesh", "status", "flops", "bytes_accessed",
               "collective_bytes", "collective_counts", "roofline",
               "argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "trace_s", "backend", "reseed_empty",
               "prune", "note"}
ENGINE = {"jnp": "eager", "pallas": "twopass"}
DEV = kmeans_dryrun.DEV


@pytest.fixture(autouse=True)
def no_group_outlives_a_test():
    yield
    assert not dist.is_initialized()


def test_production_dry_run(tmp_path):
    """The 16x16 production run on the main configuration: every record
    has the reference's keys, S2 has no collective, one PKMeans trip is ONE
    all-reduce of K d + K floats, and the whole solve is one launch."""
    k, d = kmeans_dryrun.K, kmeans_dryrun.D
    recs = {r["arch"]: r for r in kmeans_dryrun.lower_all(
        False, "batched", reseed_empty=True, init_round=True,
        out_dir=tmp_path, verbose=False)}
    assert set(recs) == {"kmeans-pkmeans-iter", "kmeans-ipkmeans-s2s3",
                         "kmeans-ipkmeans-init-round"}
    for name, rec in recs.items():
        assert RECORD_KEYS <= set(rec), name
        assert rec["mesh"] == "16x16" and rec["status"] == "ok"
        assert rec["roofline"]["dominant"] in rec["roofline"]
        on_disk = json.loads((tmp_path / f"{name}__16x16__batched__reseed"
                              ".json").read_text())
        assert on_disk == rec
    s2 = recs["kmeans-ipkmeans-s2s3"]
    assert s2["collectives_in_solver_loop"] == 0
    assert s2["kernel_launches"] == {"lloyd_solve_batched": 1}
    pk = recs["kmeans-pkmeans-iter"]
    assert pk["comm_by_stage"] == {"pkmeans": {"calls": 1,
                                               "bytes": (k * d + k) * 4}}
    assert pk["collective_bytes"] == {"all-reduce": (k * d + k) * 4}
    # one fused trip on the rank's 2^18 rows: the score product's operations
    assert pk["kernel_launches"] == {"fused_lloyd": 1}
    assert pk["flops"] == 2.0 * (kmeans_dryrun.N // 256) * k * d
    assert pk["argument_size_in_bytes"] >= (kmeans_dryrun.N // 256) * d * 4


SMALL = kmeans_dryrun.Shape(n=512, d=4, k=8, m=256, max_iters=3)


def test_cross_pod_cells(tmp_path):
    """``--pods 2``: on the eager baseline (which alone traces the S1
    cells) with ``exact``, the cross-pod S1 check passes (and raises on a
    tally over its bound); with ``int8ef`` (on ``fused``: the S1 cells do
    not depend on the reduction) the S2 trip carries its two all-gathers;
    S2 of the flat mesh has no collective either way."""
    for backend, reduce, in_loop in (("eager", "exact", 1),
                                     ("fused", "int8ef", 2)):
        recs = {r["arch"]: r for r in kmeans_dryrun.lower_all(
            False, backend, pods=2, reduce=reduce, shape=SMALL,
            out_dir=tmp_path, verbose=False)}
        xs2 = recs[f"kmeans-ipkmeans-s2-xpod2-{reduce}"]
        assert xs2["collectives_in_solver_loop"] == in_loop
        assert xs2["dcn_bytes_per_pod_modeled"] == \
            jio.dcn_reduce_bytes_ipkmeans(SMALL.m, SMALL.k, SMALL.d,
                                          SMALL.max_iters, 2, reduce)
        assert recs["kmeans-ipkmeans-s2s3"]["collectives_in_solver_loop"] \
            == 0
        if backend != "eager":
            assert not any("-s1" in name for name in recs)
            continue
        s1 = recs["kmeans-ipkmeans-s1-xpod2"]
        assert s1["mesh"] == "2x128" and s1["pack"] == "a2a"
        assert 0 < s1["s1_summary_collective_bytes"] <= 4 * \
            jio.s1_histogram_dcn_bytes(s1["kd_depth"], 256)
        assert {"kmeans-ipkmeans-s1", "kmeans-ipkmeans-s1-hist",
                "kmeans-ipkmeans-s1-opt", "kmeans-ipkmeans-s1-a2a"} <= \
            set(recs)
        # the sort build runs on the whole array on every rank
        assert recs["kmeans-ipkmeans-s1"]["argument_size_in_bytes"] >= \
            SMALL.n * SMALL.d * 4
    bound = 4 * io_model.s1_histogram_dcn_bytes(14, 256)
    ok = {"all-reduce": bound, "all-to-all": 10 * bound, "_counts": {}}
    assert kmeans_dryrun.check_s1_summaries(ok, 14, 256) == bound
    with pytest.raises(RuntimeError, match="histogram model"):
        kmeans_dryrun.check_s1_summaries({"all-gather": bound + 1}, 14, 256)


def _reference_variants():
    """The reference's KMEANS_VARIANTS as (backend, reseed, prune) triples
    and baselines, and its suffix function, read from its source."""
    tree = ast.parse((REFERENCE / "perf_variants.py").read_text())
    table, suffix_src = None, None
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "KMEANS_VARIANTS"):
            table = node.value
        if (isinstance(node, ast.FunctionDef)
                and node.name == "_kmeans_variant_suffix"):
            suffix_src = ast.unparse(node)

    def fields(call):
        kw = {k.arg: k.value for k in call.keywords if k.arg != "note"}
        base = kw.pop("baseline", None)
        out = {k: ast.literal_eval(v) for k, v in kw.items()}
        if base is not None:
            out["baseline"] = fields(base)
        return out

    variants = {ast.literal_eval(k): fields(v)
                for k, v in zip(table.keys, table.values)}
    ns = {}
    exec(suffix_src, ns)
    return variants, ns["_kmeans_variant_suffix"]


def _triple(v):
    return (ENGINE.get(v["backend"], v["backend"]),
            bool(v.get("reseed_empty")), v.get("prune", "none"))


def test_parity_with_the_reference():
    assert kdtree.required_depth(2 ** 26, 4096) == 14
    assert jkdtree.required_depth(2 ** 26, 4096) == 14
    args = (4096, 1024, 64, 50, 2, "exact")
    assert io_model.dcn_reduce_bytes_ipkmeans(*args) == \
        jio.dcn_reduce_bytes_ipkmeans(*args) == 54_525_952_000
    assert io_model.s1_histogram_dcn_bytes(14, 256) == \
        jio.s1_histogram_dcn_bytes(14, 256) == 435_403_316
    theirs, suffix = _reference_variants()
    ours = perf_variants.KMEANS_VARIANTS
    assert set(ours) == set(theirs) == {f"C{i}" for i in range(1, 7)}
    for tag, v in theirs.items():
        assert _triple(ours[tag]) == _triple(v), tag
        base = v.get("baseline", dict(backend="jnp"))
        assert _triple(ours[tag].get("baseline", dict(backend="eager"))) \
            == _triple(base), tag
        for b, r, p in (_triple(v), _triple(base)):
            # the eager baseline's records carry no suffix, as jnp's
            ref_backend = {"eager": "jnp", "twopass": "pallas"}.get(b, b)
            assert perf_variants._kmeans_variant_suffix(b, r, p) == \
                suffix(ref_backend, r, p).replace("__pallas", "__twopass")
    # benchmarks/kernel_bench.py's per-solve model, written out
    f32 = 4
    for n, d, k, iters in ((16384, 64, 1024, 50), (1000, 3, 7, 9)):
        small = k * d * f32 * 2 + k * f32
        want = {"resident": n * d * f32 + n * f32 + 2 * k * d * f32
                + 3 * f32,
                "fused": iters * (n * d * f32 + n * f32 + small),
                "twopass": iters * (2 * n * d * f32 + 4 * n * f32 + small)}
        for engine, b in want.items():
            assert perf_variants.lloyd_solve_hbm_bytes(n, d, k, iters,
                                                       engine) == b


def test_perf_variants_c5_reseed_cell(monkeypatch, tmp_path, capsys):
    """C5 traces the reseed-on batched variant and its baseline (the fused
    engine's host loop with the reseed), never the eager records, and
    prints the reseed-on launch model."""
    calls = []

    def fake_lower_all(multi_pod, backend="eager", reseed_empty=False,
                       prune="none"):
        calls.append((backend, reseed_empty))
        sfx = perf_variants._kmeans_variant_suffix(backend, reseed_empty,
                                                   prune)
        rec = {"roofline": {"compute_s": 1.0, "memory_s": 2.0,
                            "collective_s": 3.0, "dominant": "collective_s"}}
        for stage in perf_variants.STAGES:
            (tmp_path / f"{stage}__16x16{sfx}.json").write_text(
                json.dumps(rec))

    monkeypatch.setattr(perf_variants, "OUT_DIR", tmp_path)
    monkeypatch.setattr(kmeans_dryrun, "lower_all", fake_lower_all)
    perf_variants.run_kmeans("C5")
    assert ("batched", True) in calls and ("fused", True) in calls
    assert ("eager", False) not in calls
    out = capsys.readouterr().out
    assert "reseed-on" in out and "per-stack launch model" in out
    with pytest.raises(SystemExit):
        perf_variants.main(["--cell", "A1"])


g = torch.Generator().manual_seed(0)
X = torch.randn(3, 40, 5, generator=g)
C = torch.randn(3, 7, 5, generator=g)
W = (torch.rand(3, 40, generator=g) > 0.2).float()
LANES = torch.tensor([0, 2], dtype=torch.int32)
LABELS = torch.randint(-1, 8, (2, 40), generator=g, dtype=torch.int32)
MIND = torch.rand(40, generator=g)
U = torch.rand(40, generator=g)
BF16 = specs.KernelSpec(acc_dtype="bfloat16")
SOLVE = dict(max_iters=4)

# name -> (call(mk), kernel counted, [work of each launch])
ROUTES = {
    "fused-step-lanes": (
        lambda mk: fused.fused_lloyd(mk(X), mk(C), None, mk(LANES)),
        "fused_lloyd", [fused.work(2, 40, 5, 7)]),
    "fused-labels-weights": (
        lambda mk: fused.fused_lloyd(mk(X), mk(C), mk(W),
                                     return_labels=True),
        "fused_lloyd", [fused.work(3, 40, 5, 7, return_labels=True)]),
    "fused-assign-only-bf16": (
        lambda mk: fused.fused_lloyd(mk(X.bfloat16()), mk(C),
                                     assign_only=True, spec=BF16),
        "fused_lloyd", [fused.work(3, 40, 5, 7, assign_only=True)]),
    "assign-one": (lambda mk: assign.assign(mk(X[0]), mk(C[0])),
                   "assign", [assign.work(1, 40, 5, 7)]),
    "assign-lanes": (lambda mk: assign.assign(mk(X), mk(C), mk(LANES)),
                     "assign", [assign.work(2, 40, 5, 7)]),
    "update-one": (lambda mk: centroid_update.centroid_update(
        mk(X[0]), mk(LABELS[0]), mk(W[0]), 7), "centroid_update",
        [centroid_update.work(1, 40, 5, 7)]),
    "update-lanes": (lambda mk: centroid_update.centroid_update(
        mk(X), mk(LABELS), mk(W), 7, mk(LANES)), "centroid_update",
        [centroid_update.work(2, 40, 5, 7)]),
    "init-sweep": (lambda mk: init.init_sweep(
        mk(X[0]), mk(C[0]), mk(MIND), mk(U), 0.5, ell=4.0, weights=mk(W[0])),
        "init_sweep", [init.work(40, 5, 7)]),
    "solve-shared": (lambda mk: batch_resident.lloyd_solve_batched(
        mk(X), mk(C[0]), mk(W), **SOLVE), "lloyd_solve_batched",
        [batch_resident.work(3, 40, 5, 7, 3, max_iters=4)]),
    "solve-lanes-bf16-reseed-prune-skips": (
        lambda mk: batch_resident.lloyd_solve_batched(
            mk(X), mk(C.bfloat16()), mk(W), reseed_empty=True,
            prune="bounds", return_skips=True, **SOLVE),
        "lloyd_solve_batched",
        [batch_resident.work(3, 40, 5, 7, 3, max_iters=4,
                             per_lane_seeds=True)]),
    "solve-groups": (lambda mk: batch_resident.lloyd_solve_batched(
        mk(X), mk(C), group_t=2, **SOLVE), "lloyd_solve_batched",
        [batch_resident.work(2, 40, 5, 7, 2, max_iters=4,
                             per_lane_seeds=True),
         batch_resident.work(1, 40, 5, 7, 1, max_iters=4,
                             per_lane_seeds=True)]),
    "solve-resident": (lambda mk: resident.lloyd_solve_resident(
        mk(X[0]), mk(C[0]), return_skips=True, **SOLVE),
        "lloyd_solve_resident", [resident.work(40, 5, 7, 1, max_iters=4)]),
}


def _signature(out):
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(out)]


def test_shape_only_routes():
    """Every mode of every kernel wrapper (``ROUTES``): a fake CUDA tensor
    and a meta tensor give the plain version's shapes and dtypes; the fake
    one hands each launch's work to the tally and launches nothing.  (One
    test: the file keeps few enough tests to queue after the tier-1 run's
    critical path.)"""
    mods = {"fused_lloyd": fused, "assign": assign,
            "centroid_update": centroid_update, "init_sweep": init,
            "lloyd_solve_batched": batch_resident,
            "lloyd_solve_resident": resident}
    for name, (call, kernel, works) in ROUTES.items():
        want = _signature(call(lambda t: t))
        before = mods[kernel].launches
        tally = dryrun.Tally()
        with dryrun.traced(tally):
            got = _signature(call(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=DEV)))
        assert got == want, name
        assert tally.launches == {kernel: len(works)}, name
        assert tally.kernel_flops == sum(w.flops for w in works), name
        assert _signature(call(lambda t: t.to("meta"))) == want, name
        assert mods[kernel].launches == before, name


H100 = (67e12, 3.35e12)


BOUNDS = [
    (fused.work(512, 16384, 64, 1024), 16.4106),
    (fused.work(8, 16384, 64, 1024), 0.2564),
    (batch_resident.work(512, 16384, 64, 1024, 4956, 0, 50), 158.8497),
    (resident.work(16384, 64, 1024, 10, 0, 50), 0.3205),
    (assign.work(1, 2 ** 20, 64, 4100), 8.2133),
    (centroid_update.work(512, 16384, 64, 1024), 0.7018),
    (centroid_update.work(1, 2 ** 20, 64, 4100), 0.0830),
    (init.work(2 ** 23, 64, 2048), 32.8212),
]


def test_work_gives_the_perf_bounds():
    """Each kernel's work at the main shapes, over the H100's f32 peak and
    memory rate, is its bound in PERF.md's kernel table."""
    for work, ms in BOUNDS:
        bound = max(work.flops / H100[0], work.bytes / H100[1]) * 1e3
        assert round(bound, 4) == ms, (work, ms)


def test_resolve_device_and_fake_world(monkeypatch):
    """Without a card, CUDA raises outside a fake mode and is the fake card
    inside one; a fake world is gone after its block, error or not."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_mod.resolve_device(dev)
        with FakeTensorMode():
            assert device_mod.resolve_device(dev) == DEV
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        with world.fake(4):
            assert dist.get_world_size() == 4
            raise ValueError
    assert not dist.is_initialized()
