"""The tuner's sweep from the command line, the counterpart of
``repro.launch.autotune``: ``python -m repro_torch.launch.autotune``.

Runs the sweep of ``repro_torch.kernels.tuning`` over a list of launch
shapes, writes the winners to the JSON cache (default
``experiments/tuning/kernel_specs.json``; ``--cache`` /
``REPRO_TUNING_CACHE`` override), then reads the file again through the
lookups the engines use (``lookup_spec``, ``lookup_group_t``,
``lookup_init_spec``) and asserts that every swept shape resolves: a run
that exits 0 is its own round-trip proof.

On a card (the default ``--device``) it times the CUDA kernels.  With
``--device cpu`` it times their plain PyTorch versions: every candidate
runs end to end, but the times order the CPU, not the card, so use tiny
shapes, ``--repeats 1`` and a throwaway ``--cache`` there (the winners are
keyed by the H100's name, the CPU's profile).

Examples::

    # the main path's lane shape and the serving bucket, full grid
    python -m repro_torch.launch.autotune --sizes 16384x64x1024 4096x64x1024

    # also the whole solve's group sizes: each size is a subset shape SxDxK
    # solved as a --stack-m stack, the paper pipeline's reseed on
    python -m repro_torch.launch.autotune --sizes 16384x64x1024 \\
        --group-ts 4,8,16 --stack-m 512 --reseed-empty

    # also the k-means|| round: each size read as NxDxC, C the candidate
    # tile, winners under the |init key
    python -m repro_torch.launch.autotune --sizes 2097152x64x2048 --init-sweep

    # on the CPU: a tiny shape and a throwaway cache
    python -m repro_torch.launch.autotune --sizes 64x4x4 --repeats 1 \\
        --block-ks 64,128 --group-ts 1,2 --stack-m 4 --init-sweep \\
        --device cpu --cache /tmp/tuning.json
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import specs, tuning


def _parse_size(s: str) -> tuple[int, int, int]:
    try:
        n, d, k = (int(v) for v in s.lower().split("x"))
        return n, d, k
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"{s!r}: expected NxDxK, e.g. 4096x64x256")


def _parse_ints(s: str) -> tuple[int, ...]:
    return tuple(int(v) for v in s.split(","))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Sweep the port's kernel geometry and cache the winners")
    ap.add_argument("--sizes", nargs="+", type=_parse_size, required=True,
                    metavar="NxDxK", help="launch shapes to tune")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="points dtype the winners are keyed under")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repeats per candidate (median wins)")
    ap.add_argument("--block-ns", type=_parse_ints,
                    default=tuning.BLOCK_NS, metavar="N1,N2,...",
                    help="block_n grid (the bf16 accumulate's block)")
    ap.add_argument("--block-ks", type=_parse_ints,
                    default=tuning.BLOCK_KS, metavar="K1,K2,...",
                    help=f"block_k grid (the score tile; the kernels are "
                         f"built for {specs.BLOCK_KS})")
    ap.add_argument("--acc-dtypes", type=lambda s: tuple(s.split(",")),
                    default=("float32",), metavar="DT1,DT2",
                    help="arithmetic to sweep (float32[,bfloat16])")
    ap.add_argument("--group-ts", type=_parse_ints, default=None,
                    metavar="T1,T2,...",
                    help="ALSO sweep the whole-solve kernel's lanes a "
                         "launch: each NxDxK is read as a subset shape "
                         "SxDxK solved as a --stack-m stack (winner cached "
                         "with group_t set under the |m<bucket> key)")
    ap.add_argument("--stack-m", type=int, default=8, metavar="M",
                    help="lanes of the stack for the --group-ts sweep")
    ap.add_argument("--reseed-empty", action="store_true",
                    help="time the --group-ts sweep with the in-kernel "
                         "reseed of empty clusters (the paper pipeline's "
                         "configuration; same key)")
    ap.add_argument("--prune", default="none", choices=["none", "bounds"],
                    help="time the --group-ts sweep with bound-gated block "
                         "skipping (the same bits as 'none', same key)")
    ap.add_argument("--init-sweep", action="store_true",
                    help="ALSO sweep the k-means|| round: each NxDxK is read "
                         "as NxDxC (C the candidate tile) and the winner "
                         "lands under the |init key")
    ap.add_argument("--cache", default=None,
                    help="cache path (default: REPRO_TUNING_CACHE or "
                         "experiments/tuning/kernel_specs.json)")
    ap.add_argument("--device-kind", default=None,
                    help="key the winners under this device kind instead of "
                         "the device's")
    ap.add_argument("--device", default=None,
                    help="where to time: a card (default 'cuda') or 'cpu' "
                         "(the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    profile = specs.get_profile(dev)
    if args.device_kind:
        profile = specs.DeviceProfile(args.device_kind,
                                      profile.smem_per_block)
    dtype = getattr(torch, args.dtype)
    cache = tuning.TuningCache.load(args.cache)
    print(f"device {dev}, profile {profile.device_kind} (shared memory "
          f"{profile.smem_per_block} B a block)  cache: {cache.path}")
    common = dict(dtype=dtype, profile=profile, cache=cache,
                  repeats=args.repeats, device=dev)

    for n, d, k in args.sizes:
        best, rows = tuning.autotune_step(
            n, d, k, block_ns=args.block_ns, block_ks=args.block_ks,
            acc_dtypes=args.acc_dtypes, **common)
        # the row that launches what the module default launches
        want = tuning.launch_key(
            specs.DEFAULT_SPEC.replace(acc_dtype=args.acc_dtypes[0]),
            n, d, k, "fused_smem_bytes")
        default = next(r for r in rows if tuning.launch_key(
            r["spec"], n, d, k, "fused_smem_bytes") == want)
        print(f"n{n} d{d} k{k}: {len(rows)} candidates -> "
              f"block_n={best.block_n} block_k={best.block_k} "
              f"acc={best.acc_dtype} ({rows[0]['time_us']:.1f} us, "
              f"{default['time_us'] / rows[0]['time_us']:.3f}x the "
              f"default's {default['time_us']:.1f} us)")

    batched_swept = []
    if args.group_ts:
        for s, d, k in args.sizes:
            best, rows = tuning.autotune_batched(
                args.stack_m, s, d, k, group_ts=args.group_ts,
                reseed_empty=args.reseed_empty, prune=args.prune, **common)
            if best is None:
                print(f"m{args.stack_m} s{s} d{d} k{k}: one lane does not "
                      f"fit a block's shared memory: skipped")
                continue
            batched_swept.append((s, d, k))
            print(f"m{args.stack_m} s{s} d{d} k{k}: {len(rows)} group sizes "
                  f"-> group_t={best.group_t} ({rows[0]['launches']} "
                  f"launches a stack, {rows[0]['time_us']:.1f} us); "
                  + ", ".join(f"t={r['group_t']}: {r['time_us']:.1f} us"
                              for r in sorted(rows,
                                              key=lambda r: r["group_t"])))

    if args.init_sweep:
        for n, d, c in args.sizes:
            best, rows = tuning.autotune_init_sweep(
                n, d, c, block_ns=args.block_ns, block_ks=args.block_ks,
                acc_dtypes=args.acc_dtypes, **common)
            print(f"init n{n} d{d} c{c}: {len(rows)} candidates -> "
                  f"block_n={best.block_n} block_k={best.block_k} "
                  f"acc={best.acc_dtype} ({rows[0]['time_us']:.1f} us)")

    path = cache.save()
    print(f"wrote {len(cache.entries)} entries to {path}")

    # the round trip: the winners resolve through the engines' own lookups
    # from a fresh read of the file just written
    saved = os.environ.get(tuning.ENV_CACHE_PATH)
    os.environ[tuning.ENV_CACHE_PATH] = str(path)
    try:
        tuning.reload_cache()
        kind = profile.device_kind
        for n, d, k in args.sizes:
            assert tuning.lookup_spec(n, d, k, dtype, kind) is not None, \
                f"cache round trip failed for n{n} d{d} k{k}"
        for s, d, k in batched_swept:
            assert tuning.lookup_group_t(s, d, k, args.stack_m, dtype,
                                         kind), \
                f"batched cache round trip failed for s{s} d{d} k{k}"
        if args.init_sweep:
            for n, d, c in args.sizes:
                assert tuning.lookup_init_spec(n, d, c, dtype, kind) \
                    is not None, \
                    f"init cache round trip failed for n{n} d{d} c{c}"
    finally:
        if saved is None:
            del os.environ[tuning.ENV_CACHE_PATH]
        else:
            os.environ[tuning.ENV_CACHE_PATH] = saved
        tuning.reload_cache()
    print(f"cache round-trip OK ({len(args.sizes)} shapes"
          + (f" + {len(batched_swept)} stacks" if batched_swept else "")
          + (f" + {len(args.sizes)} init sweeps" if args.init_sweep else "")
          + " resolve)")
    return cache


if __name__ == "__main__":
    main()
