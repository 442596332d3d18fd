"""All-reduce bandwidth: the port's two collective paths.

    python -m tensorflow_train_distributed_torch.tools.bench_allreduce \\
        [--size-mb 64] [--iters 10] [--quant none|int8] [--world N] \\
        [--device cuda|cpu]
    python -m tensorflow_train_distributed_torch.tools.bench_allreduce \\
        --host --world 4 [--algo ring|ring_q8|hd|shuffle]

- **device** (the default): ``parallel.collectives.allreduce_bus_bandwidth``
  over ``--world`` ranks, one process each: NCCL on the cards
  (``--device cuda``, one card a rank) or gloo (``--device cpu``).  The
  figure is the NCCL benchmark's bus bandwidth, ``2(k-1)/k · bytes /
  time``, comparable to ``nccl-tests``; ``--quant int8`` times the int8
  wire (``q8_all_reduce``, the trainer's grad-quant sync) and reports the
  effective f32 rate beside its ``wire_bytes``.  At one rank nothing
  crosses a link: the record then carries the rate of the one-rank
  all-reduce, a copy, under ``copy_gbps`` and no bus bandwidth.
- **host** (``--host``): the native TCP ring (``native/ringcoll``) over
  ``--world`` localhost processes, the host-side path; host work, timed on
  the host clock under either ``--device``.

``--device cuda`` holds the card lock and fails, with a record, where
there is no card; there is no CPU fallback.  A ``--device cpu`` device
leg reports no bandwidth (a CPU run measures no device): its record
holds the gloo time in ``cpu_time_s``.  The last line of standard output
is one JSON record.
"""

from __future__ import annotations

import argparse
import sys
import time

from tensorflow_train_distributed_torch.tools import bench_lm as B

# The ranks' functions, by module path (``__name__`` is ``__main__`` under
# ``python -m``).
_MOD = "tensorflow_train_distributed_torch.tools.bench_allreduce"


# -- the device leg -----------------------------------------------------------


def join_world(rank: int, world: int, coordinator: str, device: str):
    """Join a ``world``-rank process group (nccl on ``device`` "cuda",
    else gloo) through ``coordinator``; returns the torch device of this
    rank."""
    import torch

    from tensorflow_train_distributed_torch.runtime.distributed import (
        DistributedConfig,
        initialize_distributed,
    )

    initialize_distributed(DistributedConfig(
        coordinator_address=coordinator, num_processes=world,
        process_id=rank, source="bench"), device=device)
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def free_coordinator() -> str:
    from tensorflow_train_distributed_torch.testing.multiprocess import (
        free_ports,
    )

    return f"127.0.0.1:{free_ports(1)[0]}"


def device_rank(rank: int, *, world: int, coordinator: str, device: str,
                size_mb: float, iters: int, quant: str) -> dict:
    """One rank of the device leg (``MultiProcessRunner`` worker, or the
    calling process at one rank); returns the collectives' record."""
    import torch.distributed as dist

    from tensorflow_train_distributed_torch.parallel import collectives as C
    from tensorflow_train_distributed_torch.runtime.distributed import (
        shutdown_distributed,
    )

    dev = join_world(rank, world, coordinator, device)
    try:
        return C.allreduce_bus_bandwidth(dist.group.WORLD, device=dev,
                                         size_mb=size_mb, iters=iters,
                                         quant=quant)
    finally:
        shutdown_distributed()


def run_ranks(target: str, world: int, payload: dict, *,
              timeout: float = 600.0) -> list:
    """``target`` ("module:function") in ``world`` processes, each joining
    the group itself (``payload`` has the coordinator); their returns in
    rank order."""
    from tensorflow_train_distributed_torch.testing.multiprocess import (
        MultiProcessRunner,
    )

    results = MultiProcessRunner(target, world, payload=payload,
                                 init_distributed=False,
                                 timeout=timeout).run()
    return [r.value for r in results]


def bench_device(world: int, size_mb: float, iters: int, quant: str,
                 device: str) -> dict:
    payload = dict(world=world, coordinator=free_coordinator(),
                   device=device, size_mb=size_mb, iters=iters, quant=quant)
    if world == 1:
        r = device_rank(0, **payload)
    else:
        r = run_ranks(f"{_MOD}:device_rank", world, payload)[0]
    rec = {"metric": ("allreduce_bus_bandwidth_device" if quant == "none"
                      else "allreduce_bus_bandwidth_device_q8"),
           "unit": "GB/s", "devices": r["devices"],
           "message_bytes": r["message_bytes"], "wire": r["wire"],
           "backend": "nccl" if device == "cuda" else "gloo",
           "iters": iters}
    if "wire_bytes" in r:
        # The figure counts the f32 payload reduced; ``wire_bytes`` the
        # int8 codes and scales a rank moves.
        rec["wire_bytes"] = r["wire_bytes"]
    if device == "cpu":
        rec.update(value=None, cpu_time_s=r["time_s"])
    elif r["devices"] == 1:
        rec.update(value=None, bus_bandwidth_gbps=None,
                   copy_gbps=r["message_bytes"] / r["time_s"] / 1e9,
                   time_s=r["time_s"],
                   note="one rank: no link is crossed, so the rate is a "
                        "one-rank all-reduce's (a copy), not a bus "
                        "bandwidth")
    else:
        rec.update(value=r["bus_bandwidth_gbps"], time_s=r["time_s"])
    return rec


# -- the host leg -------------------------------------------------------------


def host_rank(rank: int, *, peers: list, size_mb: float, iters: int,
              algo: str):
    """One process of the native host ring; rank 0 returns the seconds
    an all-reduce took."""
    import numpy as np

    from tensorflow_train_distributed_torch.native.ringcoll import (
        HostMesh,
        HostRing,
    )

    n = int(size_mb * 1e6 / 4)
    if algo in ("ring", "ring_q8"):
        group = HostRing(rank, peers, timeout_ms=20_000)
        reduce_fn = (group.allreduce if algo == "ring"
                     else group.allreduce_q8)
    else:
        group = HostMesh(rank, peers, timeout_ms=20_000)

        def reduce_fn(x):
            return group.allreduce(x, algorithm=algo)
    x = np.ones(n, np.float32)
    reduce_fn(x)                    # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        reduce_fn(x)
    dt = (time.perf_counter() - t0) / iters
    group.close()
    return {"time_s": dt} if rank == 0 else None


# A host rank's process: numpy and the native library, no torch.
_HOST_CHILD = ("import json, sys; from " + _MOD + " import host_rank; "
               "print(json.dumps(host_rank(int(sys.argv[1]), "
               "**json.loads(sys.argv[2]))))")


def bench_host(world: int, size_mb: float, iters: int,
               algo: str = "ring", timeout: float = 120.0) -> dict:
    import json
    import os
    import subprocess

    from tensorflow_train_distributed_torch import native
    from tensorflow_train_distributed_torch.testing.multiprocess import (
        free_ports,
    )

    native.load_library()           # build once, before the ranks load it
    peers = [f"127.0.0.1:{p}" for p in free_ports(world)]
    payload = json.dumps(dict(peers=peers, size_mb=size_mb, iters=iters,
                              algo=algo))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _HOST_CHILD, str(r),
                               payload], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = {i: err[-2000:] for i, (p, (_, err)) in
              enumerate(zip(procs, outs)) if p.returncode}
    if failed:
        raise RuntimeError(f"host {algo} ranks failed: {failed}")
    r = json.loads(outs[0][0].strip().splitlines()[-1])
    n = int(size_mb * 1e6 / 4)
    return {"metric": f"allreduce_bus_bandwidth_host_{algo}",
            "value": 2 * (world - 1) / world * n * 4 / r["time_s"] / 1e9,
            "unit": "GB/s (host)", "devices": world,
            "message_bytes": n * 4, "time_s": r["time_s"],
            "backend": f"tcp_{algo}", "iters": iters,
            "note": "host work: localhost TCP between processes, timed on "
                    "the host clock"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size-mb", type=float, default=64.0)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--host", action="store_true",
                   help="the native TCP ring instead of the device group")
    p.add_argument("--world", type=int, default=None,
                   help="ranks: processes of the host ring (default 4) or "
                        "of the device leg (default 1)")
    p.add_argument("--algo", default="ring",
                   choices=["ring", "ring_q8", "hd", "shuffle"],
                   help="with --host: the all-reduce (hd and shuffle need "
                        "a power-of-2 world)")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="device leg: the int8 wire (q8_all_reduce) "
                        "instead of the exact f32 sum")
    B.add_device_args(p)
    args = p.parse_args(argv)
    world = args.world or (4 if args.host else 1)
    if world < 1:
        p.error(f"--world must be >= 1, got {world}")
    if args.host and args.algo in ("hd", "shuffle") and world & (world - 1):
        p.error(f"--algo {args.algo} requires a power-of-2 --world, got "
                f"{world} (use --algo ring)")

    def run(device):
        if args.host:
            rec = bench_host(world, args.size_mb, args.iters, args.algo)
        else:
            import torch

            if device == "cuda" and world > torch.cuda.device_count():
                raise ValueError(f"--world {world} needs {world} cards; "
                                 f"this host has "
                                 f"{torch.cuda.device_count()}")
            rec = bench_device(world, args.size_mb, args.iters, args.quant,
                               device)
        fields = B.device_fields(device)
        if "note" in rec:           # the leg's own note says what it timed
            fields.pop("note", None)
        rec.update(fields)
        return rec

    metric = ("allreduce_bus_bandwidth_host_" + args.algo if args.host
              else "allreduce_bus_bandwidth_device")
    return B.run_tool(args, metric, "GB/s", run)


if __name__ == "__main__":
    sys.exit(main())
