"""Start a world of processes for the tests and ``chip_smoke.py``.

    results = world.run(fn, 4, args=(path,), device="cpu")

``run`` starts ``P`` processes (``python -m repro_torch.distributed.world``,
so a rank imports only torch, numpy, ``repro_torch`` and the module that
holds ``fn``), each joining one process group through a ``FileStore`` in a
temporary directory, with an explicit timeout on ``init_process_group``.
Each rank calls ``fn(rank, world_size, device, *args)`` and its return
value (tensors on the CPU, numbers, dicts) comes back in rank order.  The
parent joins with a deadline: if a rank fails, the others are killed and
``WorldError`` carries the failing rank's traceback; if the deadline
passes, every rank is killed and ``WorldError`` says so.  ``start`` does
the same without waiting (``World.join`` waits), so the parent can work
while the ranks run.

Devices: ``device="cpu"`` puts every rank on the CPU, on gloo, with one
torch thread each; ``"cuda"`` gives rank ``r`` the card ``cuda:{r % count}``,
on NCCL when every rank has a card of its own and on gloo (collectives
through host memory, ``comm``) when ranks share one (``pick_backend``).
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

# seconds a rank may wait in init_process_group, and in any collective
# (gloo's default is 30 minutes)
INIT_TIMEOUT = 60.0


class WorldError(RuntimeError):
    pass


def pick_backend(device: str, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device == "cpu":
        return "gloo"
    import torch
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


def _target(fn) -> tuple[str, str]:
    """Where a rank finds ``fn``: a module name, or the file of a script
    run as ``__main__``, and the function's name."""
    mod = fn.__module__
    if mod == "__main__":
        mod = str(Path(sys.modules["__main__"].__file__).resolve())
    return mod, fn.__qualname__


class World:
    """A started world: ``join()`` waits for every rank -> their results."""

    def __init__(self, procs, tmp, deadline: float, world_size: int):
        self._procs = procs
        self._tmp = tmp
        self._deadline = deadline
        self._n = world_size

    def _log(self, rank: int) -> str:
        path = Path(self._tmp.name) / f"rank{rank}.log"
        return path.read_text(errors="replace") if path.exists() else ""

    def _kill(self):
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            p.wait()

    def close(self) -> None:
        """Kill every rank still running and remove the world's files."""
        self._kill()
        self._tmp.cleanup()

    def join(self) -> list:
        try:
            while True:
                codes = [p.poll() for p in self._procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    self._kill()
                    r = bad[0]
                    raise WorldError(f"rank {r} of {self._n} exited with "
                                     f"{codes[r]}:\n{self._log(r)[-6000:]}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self._deadline:
                    self._kill()
                    tails = "\n".join(f"--- rank {r}:\n{self._log(r)[-1500:]}"
                                      for r in range(self._n))
                    raise WorldError(f"the world of {self._n} ranks passed "
                                     f"its deadline:\n{tails}")
                time.sleep(0.05)
            out = []
            for r in range(self._n):
                with open(Path(self._tmp.name) / f"result{r}.pkl", "rb") as f:
                    out.append(pickle.load(f))    # written by our own rank
            return out
        finally:
            self.close()


def start(fn, world_size: int, *, args=(), device: str = "cuda",
          deadline: float = 120.0) -> World:
    """Start ``world_size`` ranks running ``fn(rank, world_size, device,
    *args)``; ``fn`` is a module-level function.  ``deadline``: seconds
    until ``join`` kills the world."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    tmp = tempfile.TemporaryDirectory(prefix="world-")
    job = dict(target=_target(fn), args=args, device=device,
               world_size=world_size)
    with open(Path(tmp.name) / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    procs = []
    for r in range(world_size):
        log = open(Path(tmp.name) / f"rank{r}.log", "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.distributed.world",
             "--dir", tmp.name, "--rank", str(r)],
            stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            env=env))
        log.close()
    return World(procs, tmp, time.monotonic() + deadline, world_size)


def run(fn, world_size: int, **kw) -> list:
    """``start(...).join()``: the ranks' results in rank order."""
    return start(fn, world_size, **kw).join()


def _load(target):
    mod, name = target
    if mod.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_world_main", mod)
        module = importlib.util.module_from_spec(spec)
        sys.modules["_world_main"] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(mod)
    return getattr(module, name)


def _rank_main(directory: str, rank: int) -> int:
    import torch
    import torch.distributed as dist
    with open(Path(directory) / "job.pkl", "rb") as f:
        job = pickle.load(f)                      # written by the parent
    n = job["world_size"]
    if job["device"] == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    store = dist.FileStore(str(Path(directory) / "store"), n)
    dist.init_process_group(pick_backend(job["device"], n), store=store,
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT))
    try:
        out = _load(job["target"])(rank, n, device, *job["args"])
        tmp = Path(directory) / f"result{rank}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, Path(directory) / f"result{rank}.pkl")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a world started "
                                             "by repro_torch.distributed."
                                             "world.start")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--rank", type=int, required=True)
    a = ap.parse_args(argv)
    try:
        return _rank_main(a.dir, a.rank)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        raise


if __name__ == "__main__":
    sys.exit(main())
