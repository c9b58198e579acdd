"""Fault-tolerance runtime: heartbeats, failure and straggler detection,
elastic membership, and per-stack recovery of IPKMeans S2.

The counterpart of ``repro.distributed.runtime``: the same protocol, host
logic only, exercised by a deterministic in-process simulation on an
injectable clock (``tests/test_torch_recover.py``).  The protocol:

  * HEARTBEAT  — every worker stamps (step, wall_time) after each step.
  * FAILURE    — the coordinator marks a worker dead after
    ``heartbeat_timeout`` without a stamp (or an explicit crash); the fleet
    drops to the last committed checkpoint, rebuilds its membership from
    the survivors, and resumes from the checkpoint step.
  * STRAGGLER  — synchronous-with-deadline: a worker whose step time exceeds
    ``straggler_factor`` x the fleet median for ``straggler_patience``
    consecutive steps is treated as failed.
  * SCALE-UP   — joining workers wait at the next checkpoint boundary and
    the membership is rebuilt to include them.

The checkpoint is ``repro_torch.checkpoint``'s commit protocol; recovery is
``restore_latest``.

Two functions run the protocol: :func:`run_with_recovery` (a failure drops the
whole fleet to the checkpoint step) and :func:`solve_stacks_with_recovery`
(IPKMeans S2: reducer stacks are independent, so a failure re-solves ONLY
the dead worker's stacks from their last snapshot while the survivors keep
their live state; ``RecoveryPlan.stack_owners`` carries the deterministic
reassignment).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    last_step: int = -1
    last_beat: float = 0.0
    step_times: list = dataclasses.field(default_factory=list)
    alive: bool = True


@dataclasses.dataclass(frozen=True)
class FTConfig:
    heartbeat_timeout: float = 60.0
    straggler_factor: float = 3.0
    straggler_patience: int = 3
    min_workers: int = 1


class Coordinator:
    """Failure detector and elastic membership: pure logic, host agnostic."""

    def __init__(self, num_workers: int, cfg: FTConfig = FTConfig(),
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.workers = {i: WorkerState(i, last_beat=clock())
                        for i in range(num_workers)}
        self.generation = 0          # bumps on every membership change

    # -- worker-side calls --------------------------------------------
    def heartbeat(self, worker_id: int, step: int, step_time: float):
        w = self.workers[worker_id]
        w.last_step = step
        w.last_beat = self.clock()
        w.step_times.append(step_time)
        if len(w.step_times) > 16:
            w.step_times.pop(0)

    def report_failure(self, worker_id: int):
        if self.workers[worker_id].alive:
            self.workers[worker_id].alive = False
            self.generation += 1

    def join(self, worker_id: int):
        self.workers[worker_id] = WorkerState(worker_id,
                                              last_beat=self.clock())
        self.generation += 1

    # -- coordinator sweep --------------------------------------------
    def alive_workers(self) -> list[int]:
        return sorted(i for i, w in self.workers.items() if w.alive)

    def sweep(self) -> dict:
        """Detect dead and straggling workers; returns the actions taken.
        Raises ``RuntimeError`` when fewer than ``min_workers`` remain."""
        now = self.clock()
        evicted, reasons = [], {}
        alive = [w for w in self.workers.values() if w.alive]
        med = statistics.median(
            [statistics.median(w.step_times) for w in alive if w.step_times]
        ) if any(w.step_times for w in alive) else None
        for w in alive:
            if now - w.last_beat > self.cfg.heartbeat_timeout:
                evicted.append(w.worker_id)
                reasons[w.worker_id] = "heartbeat-timeout"
            elif (med is not None and
                  len(w.step_times) >= self.cfg.straggler_patience and
                  all(t > self.cfg.straggler_factor * med
                      for t in w.step_times[-self.cfg.straggler_patience:])):
                evicted.append(w.worker_id)
                reasons[w.worker_id] = "straggler"
        for wid in evicted:
            self.workers[wid].alive = False
        if evicted:
            self.generation += 1
        n_alive = len(self.alive_workers())
        if n_alive < self.cfg.min_workers:
            raise RuntimeError(
                f"fleet below min_workers: {n_alive} < {self.cfg.min_workers}")
        return {"evicted": evicted, "reasons": reasons,
                "generation": self.generation}


@dataclasses.dataclass
class RecoveryPlan:
    """What a membership change means for the job.

    For a job with one global state the plan is global (everyone drops to
    the checkpoint step).  For IPKMeans S2 the reducer stacks are
    INDEPENDENT, so the plan also carries ``stack_owners``: the survivors
    keep their live state and only the dead workers' stacks, reassigned
    round-robin over the survivors, restart from their last snapshot.
    """
    generation: int
    workers: list[int]
    restart_step: int
    data_shards: int
    stack_owners: Optional[dict] = None     # worker -> list of stack ids

    @staticmethod
    def build(coord: Coordinator, ckpt_dir, ckpt_step: Optional[int],
              stacks: Optional[dict] = None, rebalance: bool = False):
        """``stacks``: the worker -> stack-ids map before the failure;
        orphaned stacks (owners no longer alive) are reassigned round-robin
        over the survivors in sorted order, so every worker computes the
        same plan without communication.  ``rebalance=True`` deals ALL
        stacks round-robin over the alive workers instead: the scale-up
        plan, since under the orphan-only policy a joiner would never
        receive work."""
        workers = coord.alive_workers()
        owners = None
        if stacks is not None:
            if rebalance:
                owners = {w: [] for w in workers}
                for i, s in enumerate(
                        sorted(s for ss in stacks.values() for s in ss)):
                    owners[workers[i % len(workers)]].append(s)
            else:
                owners = {w: list(stacks.get(w, ())) for w in workers}
                orphans = sorted(s for w, ss in stacks.items()
                                 if w not in workers for s in ss)
                for i, s in enumerate(orphans):
                    owners[workers[i % len(workers)]].append(s)
        return RecoveryPlan(generation=coord.generation,
                            workers=workers,
                            restart_step=ckpt_step or 0,
                            data_shards=len(workers),
                            stack_owners=owners)


def run_with_recovery(train_one_step, *, num_workers: int, steps: int,
                      save_every: int, save_fn, restore_fn,
                      fail_at: dict | None = None,
                      cfg: FTConfig = FTConfig()):
    """Deterministic fleet simulation driving the protocol end to end.

    ``train_one_step(step, workers)`` advances the global state;
    ``save_fn(step)`` / ``restore_fn() -> step`` persist it.
    ``fail_at``: ``{step: worker_id}`` crash injections.
    Returns the event log.
    """
    coord = Coordinator(num_workers, cfg)
    log = []
    step = 0
    while step < steps:
        crashed = (fail_at or {}).get(step)
        if crashed is not None and coord.workers[crashed].alive:
            coord.report_failure(crashed)
            ckpt_step = restore_fn()
            plan = RecoveryPlan.build(coord, None, ckpt_step)
            log.append(("recover", step, crashed, plan.restart_step,
                        plan.data_shards))
            step = plan.restart_step
            continue
        workers = coord.alive_workers()
        train_one_step(step, workers)
        for w in workers:
            coord.heartbeat(w, step, 1.0)
        if (step + 1) % save_every == 0:
            save_fn(step + 1)
            log.append(("save", step + 1))
        step += 1
    return log


def solve_stacks_with_recovery(advance, init_states, *, num_workers: int,
                               max_rounds: int, snapshot_every: int,
                               fail_at: dict | None = None,
                               rejoin_at: dict | None = None,
                               cfg: FTConfig = FTConfig(),
                               round_time: float = 1.0):
    """IPKMeans S2 under the heartbeat protocol, with per-STACK recovery.

    The unit of work is a reducer stack (a worker's slice of the M
    independent S2 solves), so a failure never restarts the job: the
    survivors keep their live state and ONLY the dead worker's stacks
    re-solve from their last snapshot (``RecoveryPlan.stack_owners``
    reassigns them round-robin).

    ``advance(stack_id, state) -> (state, converged)`` advances one stack's
    Lloyd solve by one round's worth of iterations (Lloyd is Markov in the
    centroids, so a chunked advance replays the unchunked iteration
    sequence exactly).  ``init_states`` seeds one opaque state per stack;
    stack ``s`` starts owned by worker ``s % num_workers``.

    Each round: a crash from ``fail_at`` (``{round: worker}``) silences that
    worker, which stops heartbeating and loses its live (unsnapshotted)
    state, so the snapshot is the recovery point; the coordinator's
    ``sweep()`` evicts it only once ``heartbeat_timeout`` has elapsed (each
    round moves a deterministic clock by ``round_time``), and the plan then
    restores the orphaned stacks from their snapshots, or from
    ``init_states`` when none was ever committed.  ``rejoin_at`` (``{round:
    worker}``) lets an evicted worker join again; it picks up stacks at the
    next plan.

    Returns ``(final states, event log, work)``, ``work`` listing every
    ``(round, worker, stack)`` advance executed: the recomputation
    accounting.
    """
    clock = {"t": 0.0}
    coord = Coordinator(num_workers, cfg, clock=lambda: clock["t"])
    owners = {w: [s for s in range(len(init_states))
                  if s % num_workers == w] for w in range(num_workers)}
    live = {s: st for s, st in enumerate(init_states)}
    snapshot = {}                       # stack id -> last committed state
    snapshot_round = {}                 # stack id -> round it was taken
    done = {s: False for s in live}
    crashed: set[int] = set()
    log, work = [], []

    for rnd in range(max_rounds):
        if all(done.values()):
            break
        clock["t"] += round_time
        victim = (fail_at or {}).get(rnd)
        if victim is not None:
            crashed.add(victim)
            log.append(("crash", rnd, victim))
        joiner = (rejoin_at or {}).get(rnd)
        if joiner is not None and joiner not in coord.alive_workers():
            crashed.discard(joiner)
            coord.join(joiner)
            # the scale-up plan: deal every stack over the grown fleet
            plan = RecoveryPlan.build(coord, None, None, stacks=owners,
                                      rebalance=True)
            owners = plan.stack_owners
            log.append(("rejoin", rnd, joiner, plan.generation))
        for w in coord.alive_workers():
            if w in crashed:
                continue                # silent: no work, no heartbeat
            for s in owners.get(w, ()):
                if done[s]:
                    continue
                live[s], done[s] = advance(s, live[s])
                work.append((rnd, w, s))
            coord.heartbeat(w, rnd, round_time)
        if (rnd + 1) % snapshot_every == 0:
            for w in coord.alive_workers():
                if w in crashed:
                    continue            # a dead worker commits nothing
                for s in owners.get(w, ()):
                    snapshot[s] = (live[s], done[s])
                    snapshot_round[s] = rnd
            log.append(("snapshot", rnd))
        swept = coord.sweep()
        if swept["evicted"]:
            orphans = [s for w in swept["evicted"] for s in owners.get(w, ())]
            plan = RecoveryPlan.build(coord, None, None, stacks=owners)
            for s in orphans:
                # the dead worker's live progress is gone with it: the stack
                # restarts from its last snapshot, or from its initial state
                # when it never reached a snapshot boundary
                live[s], done[s] = snapshot.get(s, (init_states[s], False))
            owners = plan.stack_owners
            log.append(("recover", rnd, tuple(swept["evicted"]),
                        {s: snapshot_round.get(s, -1) for s in orphans},
                        plan.generation))
    return [live[s] for s in sorted(live)], log, work
