"""Standalone serving worker daemon: dial a gateway, become a replica.

The multi-host half of disaggregated serving (counterpart of the JAX
package's ``tools/serve_worker.py``).  Where ``serve_http.py
--replica-procs`` spawns workers as the gateway's own subprocesses, this
CLI runs the same worker loop (``server.worker.run_worker``: same engine,
same driver, same frame protocol) on any machine and DIALS IN to a
gateway started with ``--listen`` (``server.netpool.NetPool``):

  # gateway host
  python -m tensorflow_train_distributed_torch.serve_http \\
      --config llama2_7b_sft --listen 0.0.0.0:9000

  # each worker host
  python -m tensorflow_train_distributed_torch.serve_worker \\
      --dial gw-host:9000 --factory llama \\
      --json '{"preset": "llama2_7b", "slots": 8}' --role decode

``--factory`` is ``stub``, ``llama`` (a seeded random-init preset on
``"device"``, default the card) or ``module:function``;
``tensorflow_train_distributed_torch.serve:worker_engine_factory`` takes
``serve.py``'s parsed flags as its ``--json``.  ``--role`` declares the
disaggregated-serving role the HELLO carries: ``prefill`` workers only
stage prompts and export finished KV rows (the gateway hands them to a
decode worker over a binary KV_HANDOFF frame), ``decode`` workers only
take placements, ``both`` (default) serves everything.

The engine is built once; the dial loop reconnects with exponential
backoff when the gateway goes away (a gateway restart re-admits the
worker as a re-dial, counted against the pool's restart budget), and
exits cleanly when the gateway DRAINs it (an orderly scale-down must not
re-dial) or the ``--redials`` budget runs out.
"""

import argparse
import json
import logging
import os
import socket
import sys
import time

from tensorflow_train_distributed_torch.runtime import faults
from tensorflow_train_distributed_torch.runtime.lint.registry import (
    thread_role,
)
from tensorflow_train_distributed_torch.server import proto
from tensorflow_train_distributed_torch.server.worker import (
    resolve_factory,
    run_worker,
)

logger = logging.getLogger("serve_worker")


def parse_hostport(s: str) -> tuple:
    host, sep, port = s.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"--dial wants HOST:PORT, got {s!r}")
    return host or "127.0.0.1", int(port)


@thread_role("dialer")
def dial_loop(engine, addr: tuple, *, args) -> int:
    """Connect → serve → re-dial until drained, fatal, or out of
    budget.  The backoff resets on every successful connection: only
    CONSECUTIVE failures count against ``--redials`` (a gateway that
    is simply restarting should not permanently strand its fleet)."""
    failures = 0
    backoff = args.redial_backoff
    first = True
    while True:
        try:
            sock = socket.create_connection(addr, timeout=10.0)
        except OSError as e:
            failures += 1
            if failures > args.redials:
                logger.error("gave up dialing %s:%d after %d failures",
                             addr[0], addr[1], failures - 1)
                return 1
            logger.warning("dial %s:%d failed (%s); retry in %.2fs "
                           "(%d/%d)", addr[0], addr[1], e, backoff,
                           failures, args.redials)
            time.sleep(backoff)
            backoff = min(backoff * 2, 10.0)
            continue
        failures = 0
        backoff = args.redial_backoff
        logger.info("%s %s:%d as role=%s",
                    "connected to" if first else "re-dialed",
                    addr[0], addr[1], args.role)
        first = False
        drained = []
        rc = run_worker(engine, sock,
                        replica_id=args.replica_id,
                        max_queue=args.max_queue,
                        stats_interval=args.stats_interval,
                        max_frame=args.max_frame, role=args.role,
                        on_drain=lambda: drained.append(True))
        try:
            sock.close()
        except OSError:
            pass
        if drained:
            logger.info("gateway drained this worker; exiting")
            return 0
        if rc != 0:
            # A protocol failure is OURS to not repeat: a worker the
            # gateway just classified and fenced must not crash-loop
            # against its restart budget.
            logger.error("worker loop failed (rc=%d); not re-dialing",
                         rc)
            return rc
        logger.warning("gateway connection closed; re-dialing")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dial", required=True, metavar="HOST:PORT",
                   help="gateway worker-listener address (the gateway's "
                        "--listen)")
    p.add_argument("--role", default="both",
                   choices=("prefill", "decode", "both"),
                   help="disaggregated serving role advertised in the "
                        "HELLO: prefill = stage+export KV only, decode "
                        "= placements only, both = everything")
    p.add_argument("--factory", default="stub",
                   help="engine factory: 'stub', 'llama', or an "
                        "importable module:function")
    p.add_argument("--json", default="{}",
                   help="JSON spec handed to the factory (the "
                        "serialized engine flags)")
    p.add_argument("--replica-id", type=int, default=None,
                   help="label for log lines/events (the gateway "
                        "assigns its own replica index regardless)")
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--stats-interval", type=float, default=0.25)
    p.add_argument("--max-frame", type=int,
                   default=proto.MAX_FRAME_BYTES)
    p.add_argument("--redials", type=int, default=8,
                   help="consecutive failed dials tolerated before "
                        "giving up (successful connections reset the "
                        "count)")
    p.add_argument("--redial-backoff", type=float, default=0.5,
                   help="initial re-dial backoff seconds (doubles per "
                        "consecutive failure, capped at 10s)")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format=f"serve_worker[{args.replica_id}] %(levelname)s "
               f"%(message)s")
    addr = parse_hostport(args.dial)
    # Chaos plans arm from THIS daemon's environment (TTD_FAULT_PLAN),
    # exactly like a subprocess worker.
    faults.arm_from_env()
    factory = resolve_factory(args.factory)
    try:
        spec = json.loads(args.json)
    except ValueError as e:
        raise SystemExit(f"--json is not valid JSON: {e}")
    # Built ONCE, reused across re-dials: the warm engine (its pools and
    # preloaded prefixes) survives a gateway restart.
    engine = factory(spec)
    return dial_loop(engine, addr, args=args)


if __name__ == "__main__":
    code = main()
    # End without the interpreter's finalization: a daemon thread (a
    # relay, a KV install, the stats loop) still inside a torch call
    # while the interpreter tears down can abort the process, turning a
    # clean drain's 0 into SIGABRT.  The logs are flushed first; the
    # worker loop has already flushed its event spool.
    logging.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
