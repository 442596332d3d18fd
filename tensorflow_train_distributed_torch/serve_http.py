"""Online HTTP serving gateway over the port's continuous-batching engine.

The online face of ``serving.ServingEngine`` (counterpart of the JAX
package's ``tools/serve_http.py``): where ``serve.py`` collects every
request up front and exits when the batch finishes, this launcher keeps
the engine decoding while a threaded HTTP frontend (``server``) accepts,
sheds, streams and times out requests concurrently:

- ``POST /v1/generate``  {"prompt": [ids], "max_new": N, "seed": S?,
  "stream": bool?, "timeout_s": F?} -> {"id", "prompt", "tokens"}
  (tokens = prompt + continuation, serve.py's convention); ``stream``
  sends tokens as they commit (NDJSON).
- ``GET /healthz``  liveness and occupancy (503 while draining).
- ``GET /metrics``  Prometheus text: request and token counters, queue
  depth, slot occupancy, TTFT / inter-token / latency histograms, the
  engine's overlap ratio and prefill stall, and the paged KV pool
  (``ttd_engine_kv_blocks_in_use`` / ``_total``,
  ``ttd_engine_prefix_hit_tokens_total``, ``ttd_engine_kv_evictions_total``).

Admission is bounded at ``--max-queue`` (beyond it 429 with Retry-After),
requests have deadlines (``--default-timeout`` or a body's ``timeout_s``:
504, slot freed), prompts are screened against the vocabulary (400), and
SIGTERM/SIGINT drains (stop admitting, finish in flight, log a final
metrics snapshot).  ``--replicas N`` fronts N engines in this process
(load and KV-affinity routing, per-replica health and the
``--watchdog-timeout`` hung-dispatch detector in ``/healthz``, failover
that resumes a dead replica's requests on a survivor from their last
streamed token, a staged ``--drain-timeout`` drain that migrates a
draining replica's live lanes to a survivor: KV blocks and decode state,
no re-prefill; ``TTD_NO_MIGRATION=1`` waits instead).  Each in-process
replica builds its own weights and pool on the card and launches from its
own driver thread on the card's default stream.

``--replica-procs`` runs each replica as a worker process
(``server.procpool``; ``TTD_NO_PROC_REPLICAS=1`` falls back to in-process
replicas) that rebuilds the engine from this CLI's parsed flags
(``serve.worker_engine_factory``), with an elastic pool between
``--scale-min`` and ``--scale-max`` and ``--restart-budget`` respawns.
``--listen HOST:PORT`` instead waits for ``serve_worker.py`` daemons to
dial in (``server.netpool``), each declaring ``--role prefill|decode|both``
for disaggregated prefill with a KV handoff (``TTD_NO_DISAGG=1`` collapses
the roles).  In both modes this process parses, screens and serves HTTP
but touches no CUDA state: the workers own the card.

Engine flags are ``serve.py``'s (``add_engine_args``), so both CLIs
configure every replica alike.

  python -m tensorflow_train_distributed_torch.serve_http \\
      --config llama2_7b_sft --port 8000 --slots 8 --cache-len 1024
  curl -s localhost:8000/v1/generate -d '{"prompt": [1,2,3], "max_new": 16}'
  curl -s localhost:8000/metrics | grep ttd_gateway
"""

from __future__ import annotations

import argparse
import logging
import sys

from tensorflow_train_distributed_torch.server import proto
from tensorflow_train_distributed_torch.serve import (
    add_engine_args,
    build_engine,
    engine_config,
    parse_prefix_arg,
)


def make_vocab_validator(vocab_size: int):
    """The gateway's prompt screen: a 400 for ids outside the
    vocabulary (the engine's own check, run before admission)."""
    from tensorflow_train_distributed_torch.server import RequestError

    def _validate(prompt, max_new, seed):
        bad = [int(t) for t in prompt if not 0 <= int(t) < vocab_size]
        if bad:
            raise RequestError(f"prompt ids outside vocab [0, "
                               f"{vocab_size}): {sorted(set(bad))[:8]}")

    return _validate


def _assert_no_cuda(where: str) -> None:
    """The parent of a worker fleet leaves the card to its workers."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(f"{where}: the gateway process initialised "
                           "CUDA; its workers own the card")


def _serve_procs(args, cfg) -> int:
    """N worker processes behind a ``ProcPool``, each rebuilding the
    engine from this CLI's serialized flags.  A worker SIGKILL, OOM or
    native crash fails one replica (classified in /healthz) and its
    requests resume on a survivor; the pool scales between
    --scale-min/--scale-max and respawns dead workers under
    --restart-budget."""
    from tensorflow_train_distributed_torch.server import (
        ProcPool,
        ServingGateway,
        WorkerSpec,
    )

    spec = WorkerSpec(
        factory="tensorflow_train_distributed_torch.serve:"
                "worker_engine_factory",
        factory_json=dict(vars(args)), max_frame_bytes=args.max_frame)
    scale_min = args.scale_min or args.replicas
    scale_max = max(args.scale_max or args.replicas, scale_min)
    pool = ProcPool(
        spec, replicas=args.replicas, scale_min=scale_min,
        scale_max=scale_max, max_queue=args.max_queue,
        validate=make_vocab_validator(cfg.vocab_size),
        default_timeout_s=args.default_timeout or None,
        retry_after_s=args.retry_after,
        watchdog_timeout_s=args.watchdog_timeout or None,
        idle_grace_s=args.idle_grace,
        max_restarts=args.restart_budget)
    gw = ServingGateway(pool, host=args.host, port=args.port,
                        default_max_new=args.max_new)
    gw.install_signal_handlers(drain_timeout=args.drain_timeout or None)
    gw.start()
    # Advertise the port once every worker has built and warmed its
    # engine and sent its HELLO.
    print(f"waiting for {args.replicas} subprocess workers...",
          flush=True)
    if not pool.wait_ready(timeout=600.0):
        print("workers failed to come up inside 600s; draining",
              flush=True)
        gw.drain(timeout=30)
        return 1
    _assert_no_cuda("--replica-procs")
    print(f"gateway listening on {args.host}:{gw.port} "
          f"(config={args.config}, replica-procs={args.replicas}, "
          f"scale=[{scale_min},{scale_max}], slots={args.slots}, "
          f"max_queue={args.max_queue})", flush=True)
    gw.wait()           # until SIGTERM/SIGINT drains
    return 0


def _serve_net(args, cfg) -> int:
    """A ``NetPool`` listens on --listen and ``serve_worker.py`` daemons
    (any machine) dial in, HELLO their --role and become replicas.
    Prefill workers stage prompts and hand the finished KV to decode
    workers over binary KV_HANDOFF frames (``TTD_NO_DISAGG=1`` collapses
    the role split).  The engine flags here only screen requests: each
    worker builds its engine from its own flags."""
    from tensorflow_train_distributed_torch.server import (
        NetPool,
        ServingGateway,
    )

    lhost, sep, lport = args.listen.rpartition(":")
    if not sep or not lport.isdigit():
        raise SystemExit(f"--listen wants HOST:PORT, got {args.listen!r}")
    scale_min = args.scale_min or args.replicas
    max_workers = max(args.scale_max or args.replicas, scale_min)
    pool = NetPool(
        host=lhost or "0.0.0.0", port=int(lport),
        scale_min=scale_min, max_workers=max_workers,
        max_queue=args.max_queue,
        validate=make_vocab_validator(cfg.vocab_size),
        default_timeout_s=args.default_timeout or None,
        retry_after_s=args.retry_after,
        watchdog_timeout_s=args.watchdog_timeout or None,
        max_restarts=args.restart_budget, max_frame_bytes=args.max_frame)
    gw = ServingGateway(pool, host=args.host, port=args.port,
                        default_max_new=args.max_new)
    gw.install_signal_handlers(drain_timeout=args.drain_timeout or None)
    gw.start()
    print(f"worker listener on {lhost or '0.0.0.0'}:{pool.port}; "
          f"waiting for {scale_min} dial-in workers...", flush=True)
    if not pool.wait_ready(timeout=600.0):
        print("workers failed to dial in inside 600s; draining",
              flush=True)
        gw.drain(timeout=30)
        return 1
    _assert_no_cuda("--listen")
    print(f"gateway listening on {args.host}:{gw.port} "
          f"(config={args.config}, dial-in workers, "
          f"scale_min={scale_min}, max_workers={max_workers}, "
          f"max_queue={args.max_queue})", flush=True)
    gw.wait()           # until SIGTERM/SIGINT drains
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_engine_args(p)
    p.add_argument("--host", default="0.0.0.0",
                   help="bind address (default: all interfaces)")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = ephemeral (printed at startup)")
    p.add_argument("--max-queue", type=int, default=64,
                   help="admission bound: requests WAITING for a slot "
                        "beyond this are shed with 429 + Retry-After")
    p.add_argument("--default-timeout", type=float, default=0.0,
                   help="per-request deadline in seconds when the body "
                        "carries no timeout_s (0 = none); an expired "
                        "request answers 504 and frees its slot")
    p.add_argument("--retry-after", type=float, default=1.0,
                   help="Retry-After seconds on shed (429) responses")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas behind the gateway: with N>1 "
                        "admissions route by load + KV-prefix affinity, "
                        "each replica has its own health/watchdog, and "
                        "a request whose replica dies resumes on a "
                        "survivor from its last streamed token "
                        "(TTD_NO_FAILOVER=1 forces the single-engine "
                        "path). In process, every replica builds its own "
                        "weights and KV pool on the one card: size the "
                        "pools with --kv-pool-blocks N (the default, slots "
                        "x ceil(cache_len / block), is explicit too); "
                        "--kv-pool-blocks auto solves each pool from the "
                        "whole card and is refused with N > 1 in process")
    p.add_argument("--listen", default="", metavar="HOST:PORT",
                   help="listen here for serve_worker.py daemons to DIAL "
                        "IN as replicas (the --replica-procs frame "
                        "protocol, across machines; workers declare "
                        "--role prefill|decode|both for disaggregated "
                        "prefill->decode KV handoff; --replicas/"
                        "--scale-min is the dial-in floor wait_ready "
                        "blocks on, --scale-max the fleet cap; "
                        "TTD_NO_DISAGG=1 collapses the role split)")
    p.add_argument("--replica-procs", action="store_true",
                   help="run each replica as a worker PROCESS "
                        "(server.procpool) speaking the length-prefixed "
                        "frame protocol: a replica OOM, native crash or "
                        "SIGKILL fails one worker, never the gateway, "
                        "and the pool scales between --scale-min/"
                        "--scale-max (TTD_NO_PROC_REPLICAS=1 falls back "
                        "to in-process replicas)")
    p.add_argument("--scale-min", type=int, default=0,
                   help="--replica-procs: never drain below this many "
                        "workers (0 = --replicas); dead workers are "
                        "respawned toward it under --restart-budget")
    p.add_argument("--scale-max", type=int, default=0,
                   help="--replica-procs: spawn up to this many workers "
                        "under queue pressure (0 = --replicas: no "
                        "scale-up)")
    p.add_argument("--restart-budget", type=int, default=8,
                   help="--replica-procs: dead-worker respawns before "
                        "the pool stops resurrecting (a crash-looping "
                        "engine must not fork-bomb); respawns back off "
                        "exponentially")
    p.add_argument("--idle-grace", type=float, default=30.0,
                   help="--replica-procs: seconds of whole-pool idle "
                        "before ONE scale-up worker is drained back "
                        "(staged, never below --scale-min)")
    p.add_argument("--watchdog-timeout", type=float, default=30.0,
                   help="seconds an engine step may run before the "
                        "replica is declared dead (hung-device "
                        "detection; 0 disables). Replicas are warmed "
                        "before they take traffic")
    p.add_argument("--max-frame", type=int, default=proto.MAX_FRAME_BYTES,
                   help="--replica-procs/--listen: the worker protocol's "
                        "frame bound in bytes (a dial-in worker takes "
                        "the same --max-frame). A migrated lane and a "
                        "prefill's KV handoff each travel in one frame, "
                        "so size it above the largest lane's KV rows: "
                        "one 16-row block of Llama-2-7B's bf16 KV is "
                        "8 MiB, beyond the 4-MiB default. A larger lane "
                        "is refused whole and its request re-prefills "
                        "(the failover path)")
    p.add_argument("--drain-timeout", type=float, default=0.0,
                   help="bound on the SIGTERM drain (replicas drain "
                        "one at a time; 0 = wait indefinitely)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from tensorflow_train_distributed_torch.server import ServingGateway

    cfg = engine_config(args)
    prefix = parse_prefix_arg(args, cfg)

    if args.listen:
        return _serve_net(args, cfg)
    if args.replica_procs:
        from tensorflow_train_distributed_torch.server.procpool import (
            proc_replicas_killed,
        )

        if proc_replicas_killed():
            print("TTD_NO_PROC_REPLICAS=1: subprocess replicas "
                  "disabled, falling back to in-process replicas",
                  flush=True)
            args.replica_procs = False
    if args.replica_procs:
        return _serve_procs(args, cfg)
    if args.replicas > 1 and args.kv_pool_blocks == "auto":
        raise SystemExit("--kv-pool-blocks auto solves one pool from the "
                         "whole card; with --replicas > 1 in process give "
                         "each replica's pool its size (--kv-pool-blocks N)")
    # One engine per replica, configured alike: each builds its own
    # weights and caches and preloads the prefix into its own pool, so
    # any one can die alone and none's tokens depend on another's.
    engines = [build_engine(args, cfg, prefix)
               for _ in range(args.replicas)]
    if args.replicas > 1:
        # Warm every replica before it takes traffic (cuBLAS handles, the
        # kernels' first load): the pool's watchdog then never times a
        # cold first step.
        for i, eng in enumerate(engines):
            print(f"warming replica {i}...", flush=True)
            eng.submit([1], 1)
            eng.run()

    gw = ServingGateway(
        engines if args.replicas > 1 else engines[0],
        host=args.host, port=args.port, max_queue=args.max_queue,
        default_timeout_s=args.default_timeout or None,
        default_max_new=args.max_new,
        validate=make_vocab_validator(cfg.vocab_size),
        retry_after_s=args.retry_after,
        watchdog_timeout_s=args.watchdog_timeout or None)
    gw.install_signal_handlers(
        drain_timeout=args.drain_timeout or None)
    gw.start()
    print(f"gateway listening on {args.host}:{gw.port} "
          f"(config={args.config}, replicas={args.replicas}, "
          f"slots={args.slots}, max_queue={args.max_queue})", flush=True)
    gw.wait()           # until SIGTERM/SIGINT drains
    return 0


if __name__ == "__main__":
    sys.exit(main())
