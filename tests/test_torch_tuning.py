"""The port's tuner sweep (``repro_torch.kernels.tuning``, ``launch/
autotune.py``) and the whole solve's group size against the reference's.

Every sweep here takes an injected ``measure`` (or runs the plain versions
on tiny shapes), so no kernel runs and no time is meaningful: what is held
is the grid, the keys the winners land under, the files both packages read,
and that a group size changes no bit.  The stack is the (4, 32, 4), k = 5
one of ``tests/test_reseed.py:291`` (``tests/test_torch_bf16.py`` builds it
the same way), in float32.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tuning as jtuning
from repro_torch.kernels import batch_resident, engine, specs, tuning
from repro_torch.kernels import resident
from repro_torch.launch import autotune

KIND = specs.CPU_PROFILE.device_kind
M, S, D, K = 4, 32, 4, 5


def _stack():
    rng = np.random.default_rng(291)
    x = torch.from_numpy((rng.normal(size=(M, S, D)) * 3.0).astype(
        np.float32))
    w = torch.ones((M, S))
    w[2, 20:] = 0.0
    far = torch.from_numpy((rng.normal(size=(K, D)) * 5 + 100.0).astype(
        np.float32))
    # per-lane seeds: the far block, shifted a little in each lane
    lanes = far + torch.arange(M, dtype=torch.float32).view(M, 1, 1) * 0.5
    return x, w, far, lanes.contiguous()


def _use_cache(monkeypatch, path):
    monkeypatch.setenv(tuning.ENV_CACHE_PATH, str(path))
    tuning.reload_cache()
    jtuning.reload_cache()


def test_candidate_specs_prune_collapse_and_keep_the_default():
    n, d, k = 16384, 64, 1024
    got = tuning.candidate_specs(n, d, k, specs.CPU_PROFILE)
    # float32: block_n changes nothing, so one candidate a tile width, and
    # the module default itself competes, first
    assert got[0] == specs.DEFAULT_SPEC
    assert sorted(c.block_k for c in got) == list(specs.BLOCK_KS)
    assert len(got) == len(specs.BLOCK_KS)
    # widths no kernel is built for drop out (96, 512), and so does a block
    # past the profile's shared memory; the default survives either way
    odd = tuning.candidate_specs(n, d, k, specs.CPU_PROFILE,
                                 block_ks=(64, 96, 512))
    assert [c.block_k for c in odd] == [128, 64]
    tight = specs.DeviceProfile("tight", 30000)
    assert [c.block_k for c in tuning.candidate_specs(
        n, d, k, tight)] == [128, 64]
    assert tuning.candidate_specs(n, d, 60000, specs.CPU_PROFILE) == [
        specs.DEFAULT_SPEC]
    # bfloat16: the accumulate's clamped block tells candidates apart,
    # except in the init sweep, which has no accumulate
    bf = tuning.candidate_specs(n, d, k, specs.CPU_PROFILE,
                                acc_dtypes=("bfloat16",))
    assert len(bf) == len(tuning.BLOCK_NS) * len(specs.BLOCK_KS)
    small = tuning.candidate_specs(100, d, k, specs.CPU_PROFILE,
                                   acc_dtypes=("bfloat16",))
    assert len(small) == 2 * len(specs.BLOCK_KS)     # bn 64, then 100
    init = tuning.candidate_specs(n, d, 2048, specs.CPU_PROFILE,
                                  acc_dtypes=("bfloat16",),
                                  smem_bytes="init_smem_bytes")
    assert len(init) == len(specs.BLOCK_KS)
    # the prices: one block's score tiles and the update's k counts
    assert [specs.KernelSpec(block_k=b).assign_smem_bytes(n, d, k)
            for b in specs.BLOCK_KS] == [25600, 33792, 50176]
    assert specs.DEFAULT_SPEC.init_smem_bytes(n, d, k) == 33792 + 1024
    assert specs.DEFAULT_SPEC.fused_smem_bytes(n, d, 20000) == 80000
    assert specs.DEFAULT_SPEC.update_smem_bytes(n, d, k) == 4096


def test_sweeps_write_the_reference_keys_and_files(monkeypatch, tmp_path):
    path = tmp_path / "kernel_specs.json"
    cache = tuning.TuningCache.load(path)
    times = {64: 3.0, 128: 2.0, 256: 1.0}
    best, rows = tuning.autotune_step(
        300, D, K, cache=cache, device="cpu",
        measure=lambda sp: times[sp.block_k] * 1e-6)
    assert best.block_k == 256 and [r["time_us"] for r in rows] == [1, 2, 3]
    ibest, _ = tuning.autotune_init_sweep(
        4096, D, 24, cache=cache, device="cpu",
        measure=lambda sp: 1e-6 if sp.block_k == 64 else 2e-6)
    gbest, grows = tuning.autotune_batched(
        M, S, D, K, cache=cache, device="cpu", reseed_empty=True,
        measure=lambda t: {1: 4e-6, 2: 1e-6}.get(t, 3e-6))
    assert ibest.block_k == 64 and gbest.group_t == 2
    assert [(r["group_t"], r["launches"]) for r in sorted(
        grows, key=lambda r: r["group_t"])] == [(1, 4), (2, 2), (4, 1)]
    cache.save()
    want = {jtuning.cache_key(KIND, jnp.float32, 300, D, K): best,
            jtuning.cache_key(KIND, jnp.float32, 4096, D, 24,
                              kernel="init"): ibest,
            jtuning.cache_key(KIND, jnp.float32, S, D, K, m=M): gbest}
    assert set(json.loads(path.read_text())["entries"]) == set(want)
    # the reference reads the port's file: the same fields, the same group
    theirs = jtuning.TuningCache.load(path)
    for key, spec in want.items():
        got = theirs.get(key)
        assert (got.block_n, got.block_k, got.acc_dtype, got.group_t) == (
            spec.block_n, spec.block_k, spec.acc_dtype, spec.group_t)
    _use_cache(monkeypatch, path)
    assert jtuning.lookup_group_t(S, D, K, M, jnp.float32,
                                  device_kind=KIND) == 2
    assert tuning.lookup_group_t(S, D, K, M, device="cpu") == 2
    assert tuning.lookup_spec(300, D, K, device="cpu") == best
    # and the port reads the reference's sweep
    jpath = tmp_path / "from_reference.json"
    jcache = jtuning.TuningCache.load(jpath)
    jbest, _ = jtuning.autotune_step(
        300, D, K, profile=jtuning.specs.DeviceProfile(KIND, 16 << 20),
        cache=jcache, measure=lambda sp: 1e-6 * sp.block_n * sp.block_k)
    jcache.save()
    key = tuning.cache_key(KIND, torch.float32, 300, D, K)
    mine = tuning.TuningCache.load(jpath).get(key)
    assert (mine.block_n, mine.block_k) == (jbest.block_n, jbest.block_k)


def test_candidate_group_ts_clamp_to_m_and_keep_the_cap():
    prof = specs.CPU_PROFILE
    assert tuning.candidate_group_ts(512, 16384, 64, 1024, prof) == [
        1, 2, 4, 8, 16, 512]
    assert tuning.candidate_group_ts(3, 16384, 64, 1024, prof) == [1, 2, 3]
    assert tuning.candidate_group_ts(
        40, 128, 64, 1024, prof, group_ts=(4, 64)) == [4, 40]
    # one lane past a block's shared memory: no group, the fused fallback
    assert tuning.candidate_group_ts(8, 64, 4, 20000, prof) == []
    assert batch_resident.batched_group_size(8, 64, 4, 20000,
                                             device="cpu") == 0
    assert prof.batched_group_size(512, 16384, 64, 1024) == 512
    # the resident sizing knob: S does not enter without pruning; with it,
    # every subset up to the answer fits and the next 8 rows may not
    assert resident.max_resident_points(64, 1024) == resident.MAX_LANE_ROWS
    n = prof.max_resident_points(64, 1024, "bounds")
    assert n % 8 == 0 and batch_resident.batched_feasible(
        n, 64, 1024, "bounds", bound_block=8)
    assert not batch_resident.batched_feasible(n + 8, 64, 1024, "bounds",
                                               bound_block=8)
    assert resident.resident_smem_bytes(16384, 64, 1024) == (
        batch_resident.smem_bytes(16384, 1024))
    assert prof.max_resident_points(64, 60000) == 0


def test_grouped_plain_solve_is_the_one_launch_solve(monkeypatch):
    x, w, far, lanes = _stack()
    calls = []
    plain = batch_resident.lloyd_solve_plain

    def counted(subsets, *a, **kw):
        calls.append(subsets.shape[0])
        return plain(subsets, *a, **kw)

    monkeypatch.setattr(batch_resident, "lloyd_solve_plain", counted)
    for seeds in (far, lanes):
        for reseed in (False, True):
            kw = dict(max_iters=12, tol=1e-6, reseed_empty=reseed,
                      return_skips=True)
            calls.clear()
            want = batch_resident.lloyd_solve_batched(x, seeds, w, **kw)
            assert calls == [M]
            for t in (1, 3, M):
                calls.clear()
                got = batch_resident.lloyd_solve_batched(x, seeds, w,
                                                         group_t=t, **kw)
                assert len(calls) == -(-M // t)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            # a spec's group_t is the default group size
            calls.clear()
            batch_resident.lloyd_solve_batched(
                x, seeds, w, spec=specs.KernelSpec(group_t=3), **kw)
            assert calls == [3, 1]
    with pytest.raises(ValueError, match="group sizes"):
        batch_resident.lloyd_solve_batched(x, far, w, group_t=0)


def test_batched_engine_takes_the_cached_group_t(monkeypatch, tmp_path):
    x, w, far, lanes = _stack()
    bat = engine.get_engine("batched")
    kw = dict(max_iters=12, tol=1e-6, reseed_empty=True)
    _use_cache(monkeypatch, tmp_path / "none.json")
    assert bat.resolve_group_size(M, S, D, K, torch.float32,
                                  device="cpu") == M
    want = [bat.solve_batched(x, seeds, w, **kw) for seeds in (far, lanes)]
    cache = tuning.TuningCache.load(tmp_path / "kernel_specs.json")
    cache.put(tuning.cache_key(KIND, torch.float32, S, D, K, m=M),
              specs.DEFAULT_SPEC.replace(group_t=3))
    cache.save()
    _use_cache(monkeypatch, cache.path)
    assert bat.resolve_group_size(M, S, D, K, torch.float32,
                                  device="cpu") == 3
    launches = []
    solve = batch_resident.solve_stack

    def counted(subsets, *a, **kw):
        launches.append((subsets.shape[0], kw.get("group_t")))
        return solve(subsets, *a, **kw)

    monkeypatch.setattr(batch_resident, "solve_stack", counted)
    for seeds, ref in zip((far, lanes), want):
        launches.clear()
        got = bat.solve_batched(x, seeds, w, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert launches == [(M, 3), (3, None), (1, None)]
    # a cached group past the cap is clamped to it
    cache.put(tuning.cache_key(KIND, torch.float32, S, D, K, m=M),
              specs.DEFAULT_SPEC.replace(group_t=64))
    cache.save()
    tuning.reload_cache()
    assert bat.resolve_group_size(M, S, D, K, torch.float32,
                                  device="cpu") == M


def test_autotune_cli_round_trip_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "tuning.json"
    autotune.main(["--sizes", "64x4x4", "--repeats", "1", "--block-ks",
                   "64,128", "--group-ts", "1,2", "--stack-m", "4",
                   "--init-sweep", "--device", "cpu", "--cache", str(path)])
    out = capsys.readouterr().out
    assert "cache round-trip OK (1 shapes + 1 stacks + 1 init sweeps" in out
    entries = json.loads(path.read_text())["entries"]
    assert set(entries) == {
        jtuning.cache_key(KIND, jnp.float32, 64, 4, 4),
        jtuning.cache_key(KIND, jnp.float32, 64, 4, 4, m=4),
        jtuning.cache_key(KIND, jnp.float32, 64, 4, 4, kernel="init")}
    assert entries[jtuning.cache_key(KIND, jnp.float32, 64, 4, 4, m=4)][
        "group_t"] in (1, 2, 4)


def test_block_k_reaches_the_wrappers_and_odd_widths_raise():
    x, w, far, _ = _stack()
    c = far.expand(M, K, D).contiguous()
    from repro_torch.kernels import ops
    want = ops.lloyd_step_fused(x, c, w, return_labels=True)
    for bk in specs.BLOCK_KS:
        sp = specs.KernelSpec(block_k=bk)
        got = ops.lloyd_step_fused(x, c, w, return_labels=True, spec=sp)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(ops.assign(x, c, spec=sp)[0], want[3])
    for bad in (96, 512):
        sp = specs.KernelSpec(block_k=bad)
        with pytest.raises(ValueError, match=r"built for block_k in"):
            ops.lloyd_step_fused(x, c, w, spec=sp)
        with pytest.raises(ValueError, match=r"built for block_k in"):
            ops.init_sweep(x[0], c[0], torch.full((S,), torch.inf),
                           torch.rand(S), 1.0, ell=2.0, spec=sp)
