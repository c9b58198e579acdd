"""Recoverable IPKMeans, its parts: the port's fault-tolerance runtime
(``repro_torch.distributed.runtime``) against ``repro.distributed.runtime``,
and the whole solve from per-lane seeds (``ipkmeans_recoverable`` itself:
``tests/test_torch_recoverable.py``).

The runtime is host logic: both packages run the same scenarios, with the
same deterministic counter as the stand-in for a Lloyd round, and must give
the same ``(states, log, work)``.
"""
import numpy as np
import pytest
import torch

from repro.distributed import runtime as jruntime
from repro_torch.distributed import runtime
from repro_torch.kernels import engine


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _counter_advance(need):
    """A deterministic stand-in for a Lloyd round: the state is an int
    counter, and stack s converges once it reaches need[s]."""
    def advance(s, v):
        return v + 1, v + 1 >= need[s]
    return advance


def _stacks(rt, need, **kw):
    return rt.solve_stacks_with_recovery(
        _counter_advance(need), [0] * len(need),
        cfg=rt.FTConfig(heartbeat_timeout=1.5, min_workers=1), **kw)


def _run_with_recovery(rt):
    state = {"sum": 0.0, "ckpt": {}, "last": 0}

    def train_one_step(step, workers):
        state["sum"] += sum(step * 1000 + i for i in range(8)) / 8

    def save_fn(step):
        state["ckpt"][step] = state["sum"]
        state["last"] = step

    def restore_fn():
        state["sum"] = state["ckpt"].get(state["last"], 0.0)
        return state["last"]

    log = rt.run_with_recovery(train_one_step, num_workers=4, steps=10,
                               save_every=5, save_fn=save_fn,
                               restore_fn=restore_fn, fail_at={7: 2})
    return log, state["sum"]


def _timeout(rt):
    clock = FakeClock()
    c = rt.Coordinator(4, rt.FTConfig(heartbeat_timeout=10.0), clock=clock)
    clock.t = 5.0
    for w in (0, 1, 2):
        c.heartbeat(w, step=1, step_time=1.0)
    clock.t = 12.0
    return c.sweep(), c.alive_workers(), c.generation


def _straggler(rt):
    clock = FakeClock()
    c = rt.Coordinator(4, rt.FTConfig(straggler_factor=3.0,
                                      straggler_patience=3), clock=clock)
    for step in range(4):
        clock.t += 1.0
        for w in range(4):
            c.heartbeat(w, step, 10.0 if w == 2 else 1.0)
    return c.sweep(), c.alive_workers()


def _min_workers(rt):
    clock = FakeClock()
    c = rt.Coordinator(2, rt.FTConfig(heartbeat_timeout=1.0, min_workers=2),
                       clock=clock)
    clock.t = 5.0
    with pytest.raises(RuntimeError) as err:
        c.sweep()
    return str(err.value), c.alive_workers()


def _rejoin_and_rebalance(rt):
    c = rt.Coordinator(3)
    c.report_failure(1)
    c.join(7)
    stacks = {0: [0, 3], 1: [1, 4], 2: [2, 5]}
    return (c.generation, c.alive_workers(),
            rt.RecoveryPlan.build(c, None, 4, stacks=stacks),
            rt.RecoveryPlan.build(c, None, None, stacks=stacks,
                                  rebalance=True))


SCENARIOS = {
    # the four per-stack recovery scenarios of tests/test_fault_tolerance.py
    "orphan_restore": lambda rt: _stacks(rt, [6, 6, 6, 6], num_workers=2,
                                         max_rounds=30, snapshot_every=2,
                                         fail_at={3: 1}),
    "zero_snapshots": lambda rt: _stacks(rt, [4, 4], num_workers=2,
                                         max_rounds=30, snapshot_every=10,
                                         fail_at={0: 1}),
    "final_round_timeout": lambda rt: _stacks(rt, [3, 5], num_workers=2,
                                              max_rounds=30,
                                              snapshot_every=2,
                                              fail_at={4: 1}),
    "rejoin": lambda rt: _stacks(rt, [12] * 4, num_workers=2, max_rounds=60,
                                 snapshot_every=2, fail_at={3: 1},
                                 rejoin_at={8: 1}),
    "run_with_recovery": _run_with_recovery,
    "coordinator_timeout": _timeout,
    "coordinator_straggler": _straggler,
    "coordinator_min_workers": _min_workers,
    "coordinator_rejoin_and_plans": _rejoin_and_rebalance,
}


def _plain(x):
    """Recovery plans as tuples, so that the two packages' results
    compare."""
    if isinstance(x, (runtime.RecoveryPlan, jruntime.RecoveryPlan)):
        return ("plan", x.generation, x.workers, x.restart_step,
                x.data_shards, x.stack_owners)
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_runtime_matches_reference(name):
    got = _plain(SCENARIOS[name](runtime))
    want = _plain(SCENARIOS[name](jruntime))
    assert got == want
    if name.startswith("orphan"):
        states, log, work = got
        assert states == [6, 6, 6, 6]
        assert [e for e in log if e[0] == "recover"][0][3] == {1: 1, 3: 1}


def _lane_data(seed=0, m=5, s=200, d=3, k=6):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor((rng.normal(size=(m, s, d)) * 3).astype(np.float32))
    c = torch.as_tensor((rng.normal(size=(m, k, d)) * 3).astype(np.float32))
    c[1, 4] = c[1, 2]                      # a duplicate: reseed fires
    w = torch.as_tensor((rng.random((m, s)) > 0.2).astype(np.float32))
    w[3] = 0.0                             # an all-padding lane
    return x, c, w


@pytest.mark.parametrize("backend", ["eager", "fused", "resident",
                                     "batched"])
def test_solve_batched_with_per_lane_seeds_is_each_lanes_solve(backend):
    """(M, k, d) seeds: each lane of the stacked call is bit for bit that
    lane's ``solve`` from its own seeds; shared (k, d) seeds are the same
    seeds given to every lane."""
    x, c, w = _lane_data()
    eng = engine.get_engine(backend)
    kw = dict(max_iters=30, tol=1e-6, reseed_empty=True)
    got = eng.solve_batched(x, c, w, **kw)
    lanes = [eng.solve(x[i], c[i], w[i], **kw) for i in range(x.shape[0])]
    for a, b in zip(got, zip(*lanes)):
        assert torch.equal(a, torch.stack(b))
    assert len(set(got[2].tolist())) > 1          # the lanes really differ
    shared = eng.solve_batched(x, c[0], w, **kw)
    every = eng.solve_batched(x, c[0].expand_as(c).contiguous(), w, **kw)
    for a, b in zip(shared, every):
        assert torch.equal(a, b)
