"""Serving chaos gate: kill, fail over and migrate a fleet under load.

The serving legs of the JAX package's ``tools/chaos_check.py``, over the
port's engines (``python -m tensorflow_train_distributed_torch.chaos_check
--serving [--procs|--disagg|--migrate] [--device cpu]``).  Each leg runs
once greedy and once with seeded sampling and holds every token stream
EQUAL to an uninterrupted run of the same requests on one engine with the
same weights (``server.worker.llama_params``: llama_tiny from seed 0):

- ``--serving``: two in-process replicas under concurrent streaming load;
  replica 0 vanishes at its third dispatch
  (``serve:dispatch:3:kill9:replica=0``).  Every request completes on the
  survivor, exactly one replica is dead, a failover happened and
  ``/healthz`` reads degraded at 200.
- ``--procs``: two worker processes (``server.procpool``); worker 0 takes
  a real ``os.kill(pid, SIGKILL)`` at its third dispatch (the ``killpid``
  fault in its own environment).  The dead worker is classified "killed
  by signal 9" against its pid and the pool respawns it.
- ``--disagg``: one prefill and two decode workers dial in over TCP
  (``server.netpool``, ``serve_worker.py``); the prefill worker is
  SIGKILLed the moment the first KV handoff lands and decode worker 1 at
  its second dispatch.  Both corpses read "disconnected" against their
  pids, a handoff and a failover happened.
- ``--migrate``: every stream on a three-replica gateway migrates twice
  mid-generation (KV exported and installed, no re-prefill), then the
  current replica of a stream vanishes mid-migration; KV bytes moved and
  one replica (never all) died.  A third, speculative run (a one-layer
  draft) migrates the draft's KV beside the target's.

The verdict is one JSON line on stdout; the exit code is 0 iff every
check passed.  Not ported yet (ROADMAP Queue 1 step 8): the training legs
(kill -9 with a torn checkpoint, ``--train-elastic``) and the disaggregated
leg's post-mortem checks, which read ``tools/trace_report.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "llama_tiny"


def _engine_kw(sampling: bool, slots: int = 2) -> dict:
    kw = dict(slots=slots, cache_len=64, chunk=4)
    if sampling:
        kw.update(temperature=0.8, top_k=40)
    return kw


def _reference(reqs, sampling: bool, device: str, **kw) -> list:
    """Each request's tokens from one uninterrupted engine, built as the
    workers build theirs (same preset, same seeded weights)."""
    from tensorflow_train_distributed_torch.server.worker import (
        llama_params,
    )
    from tensorflow_train_distributed_torch.serving import ServingEngine

    cfg, params = llama_params(PRESET, 0, device)
    eng = ServingEngine(cfg, params, device=device, **kw)
    rids = [eng.submit(p, m, seed=s if sampling else None)
            for p, m, s in reqs]
    out = eng.run()
    return [out[r] for r in rids]


def _stream(port: int, prompt, max_new: int, seed, timeout_s: float,
            on_chunk=None) -> tuple:
    """One streaming request -> (error or None, prompt + tokens or None).
    ``on_chunk(request_id)`` runs after each committed chunk."""
    body = {"prompt": prompt, "max_new": max_new, "stream": True}
    if seed is not None:
        body["seed"] = seed
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            toks, err, rid = [], None, None
            for raw in r:
                obj = json.loads(raw)
                if "id" in obj:
                    rid = obj["id"]
                if "tokens" in obj:
                    toks.extend(obj["tokens"])
                    if on_chunk is not None and rid is not None:
                        on_chunk(rid)
                elif "error" in obj:
                    err = obj["error"]
            return err, list(prompt) + toks
    except OSError as e:
        return f"{type(e).__name__}: {e}", None


def _run_clients(port: int, reqs, sampling: bool, timeout_s: float,
                 on_chunk=None) -> list:
    """All requests at once, one thread each; their (error, tokens)."""
    results: list = [None] * len(reqs)

    def client(i):
        prompt, max_new, seed = reqs[i]
        cb = None if on_chunk is None else (lambda rid: on_chunk(i, rid))
        results[i] = _stream(port, prompt, max_new,
                             seed if sampling else None, timeout_s, cb)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def _parity_checks(checks: dict, results, refs) -> None:
    checks["all_completed"] = all(
        r is not None and r[0] is None for r in results)
    checks["streams_match_reference"] = checks["all_completed"] and all(
        r[1] == ref for r, ref in zip(results, refs))


def _healthz_routable(port: int, statuses=("ok", "degraded")) -> bool:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=10) as r:
        return r.status == 200 and json.loads(r.read())["status"] in statuses


def _verdict(checks, results, **extra) -> dict:
    ok = all(checks.values())
    return {"ok": ok, "checks": checks, **extra,
            "results": [] if ok else
            [(r[0] if r else "no result") for r in results]}


def _short_requests(n: int) -> list:
    rng = np.random.default_rng(0)
    return [([int(t) for t in rng.integers(1, 200, int(rng.integers(2, 8)))],
             int(rng.integers(6, 14)), 1000 + i) for i in range(n)]


def _worker_env(device: str) -> dict:
    # CPU workers run one torch thread: a fleet of full-width thread pools
    # oversubscribes the host's cores.
    return {"OMP_NUM_THREADS": "1"} if device == "cpu" else {}


def run_serving_chaos(*, sampling: bool = True, n_requests: int = 8,
                      kill_dispatch: int = 3,
                      watchdog_timeout_s: float = 10.0,
                      timeout_s: float = 120.0, device: str = "cuda") -> dict:
    """Kill one of two in-process replicas mid-stream under load (the
    module docstring).  ``kill_dispatch`` stays within replica 0's
    guaranteed dispatches under the worst placement skew: its share can
    be one short request (~3 engine steps)."""
    from tensorflow_train_distributed_torch.runtime import faults
    from tensorflow_train_distributed_torch.server import ServingGateway
    from tensorflow_train_distributed_torch.server.worker import (
        llama_params,
    )
    from tensorflow_train_distributed_torch.serving import ServingEngine

    checks = {}
    kw = dict(_engine_kw(sampling), prompt_buckets=(8, 16, 32))
    reqs = _short_requests(n_requests)
    refs = _reference(reqs, sampling, device, **kw)
    cfg, params = llama_params(PRESET, 0, device)
    engines = [ServingEngine(cfg, params, device=device, **kw)
               for _ in range(2)]
    for e in engines:              # warm before the watchdog watches
        e.submit([1, 2, 3], 5, seed=0 if sampling else None)
        e.run()
    faults.arm(f"serve:dispatch:{kill_dispatch}:kill9:replica=0")
    gw = ServingGateway(engines, host="127.0.0.1", port=0,
                        max_queue=4 * n_requests,
                        watchdog_timeout_s=watchdog_timeout_s).start()
    try:
        results = _run_clients(gw.port, reqs, sampling, timeout_s)
        _parity_checks(checks, results, refs)
        states = gw.pool.replica_states()
        checks["one_replica_dead"] = (
            sum(s["state"] == "dead" for s in states) == 1)
        checks["failover_happened"] = gw.metrics.failovers.value() >= 1
        checks["healthz_degraded_not_503"] = _healthz_routable(
            gw.port, ("degraded",))
    finally:
        faults.disarm()
        gw.drain(timeout=30)
    return _verdict(checks, results, mode="serving",
                    leg="sampled" if sampling else "greedy",
                    failovers=gw.metrics.failovers.value())


def run_serving_chaos_procs(*, sampling: bool = True, n_requests: int = 8,
                            kill_dispatch: int = 3, workers: int = 2,
                            watchdog_timeout_s: float = 30.0,
                            timeout_s: float = 300.0,
                            device: str = "cuda") -> dict:
    """The subprocess leg (the module docstring): a real SIGKILL inside
    worker 0 at its ``kill_dispatch``'th dispatch.  Workers warm their
    engines before the HELLO."""
    from tensorflow_train_distributed_torch.server import (
        ProcPool,
        ServingGateway,
        WorkerSpec,
    )

    checks = {}
    kw = _engine_kw(sampling)
    reqs = _short_requests(n_requests)
    refs = _reference(reqs, sampling, device, prompt_buckets=(8, 16, 32),
                      **kw)
    spec = WorkerSpec(
        factory="llama",
        factory_json=dict(preset=PRESET, init_seed=0, device=device,
                          prompt_buckets=[8, 16, 32], **kw),
        env={"TTD_FAULT_PLAN":
             f"serve:dispatch:{kill_dispatch}:killpid:replica=0",
             **_worker_env(device)})
    pool = ProcPool(spec, replicas=workers, max_queue=4 * n_requests,
                    watchdog_timeout_s=watchdog_timeout_s,
                    monitor_poll_s=0.02, spawn_cooldown_s=0.0,
                    restart_backoff_s=0.05)
    gw = ServingGateway(pool, host="127.0.0.1", port=0).start()
    results: list = []
    try:
        checks["workers_ready"] = pool.wait_ready(timeout=timeout_s)
        killed_pid = pool.replicas[0].driver.pid
        results = _run_clients(gw.port, reqs, sampling, timeout_s)
        _parity_checks(checks, results, refs)
        dead = [s for s in pool.replica_states() if s["state"] == "dead"]
        checks["one_worker_dead"] = len(dead) == 1
        checks["killed_by_signal_9"] = (
            len(dead) == 1 and "signal 9" in dead[0].get("reason", "")
            and dead[0].get("failure_class") == "killed"
            and dead[0].get("pid") == killed_pid)
        checks["failover_happened"] = gw.metrics.failovers.value() >= 1
        checks["healthz_routable"] = _healthz_routable(gw.port)
        # The elastic pool respawns the corpse under its restart budget.
        deadline = time.monotonic() + 30.0 + timeout_s / 10
        while (pool.alive_count() < workers
               and time.monotonic() < deadline):
            time.sleep(0.05)
        checks["worker_respawned"] = (pool.alive_count() >= workers
                                      and pool.restarts_total() >= 1)
    finally:
        gw.drain(timeout=60)
    return _verdict(checks, results, mode="serving-procs",
                    leg="sampled" if sampling else "greedy",
                    failovers=gw.metrics.failovers.value(),
                    restarts=pool.restarts_total())


def serve_worker_cmd(port: int, factory: str, spec: dict, replica: int,
                     role: str) -> list:
    """The command line of one dial-in worker (``serve_worker.py``)."""
    return [sys.executable, "-m",
            "tensorflow_train_distributed_torch.serve_worker",
            "--dial", f"127.0.0.1:{port}", "--factory", factory,
            "--json", json.dumps(spec), "--replica-id", str(replica),
            "--role", role]


def run_serving_chaos_disagg(*, sampling: bool = True, n_requests: int = 6,
                             kill_dispatch: int = 2,
                             watchdog_timeout_s: float = 30.0,
                             timeout_s: float = 600.0,
                             device: str = "cuda") -> dict:
    """The disaggregated leg (the module docstring).  ``kill_dispatch``
    stays within decode worker 1's guaranteed dispatches: any placed
    request yields two (a prefill and a decode chunk), and load-ranked
    placement gives each decode worker at least one of ``n_requests``
    concurrent streams."""
    from tensorflow_train_distributed_torch.runtime import events
    from tensorflow_train_distributed_torch.server import (
        NetPool,
        ServingGateway,
    )

    checks = {}
    kw = _engine_kw(sampling)
    rng = np.random.default_rng(0)
    # Mixed load: even requests span more than one KV block (16 tokens),
    # so their placement hands KV from prefill to decode; odd ones are
    # short streams that keep the decode workers dispatching.
    reqs = []
    for i in range(n_requests):
        plen = (int(rng.integers(18, 30)) if i % 2 == 0
                else int(rng.integers(2, 8)))
        reqs.append(([int(t) for t in rng.integers(1, 200, plen)],
                     int(rng.integers(6, 12)), 1000 + i))
    refs = _reference(reqs, sampling, device, prompt_buckets=(8, 16, 32),
                      **kw)
    pool = NetPool(host="127.0.0.1", port=0, scale_min=3, max_workers=4,
                   max_queue=4 * n_requests,
                   watchdog_timeout_s=watchdog_timeout_s,
                   monitor_poll_s=0.02)
    # start() starts the pool and its listener: workers learn the port
    # only after it.
    gw = ServingGateway(pool, host="127.0.0.1", port=0).start()
    spec = dict(preset=PRESET, init_seed=0, device=device,
                prompt_buckets=[8, 16, 32], **kw)

    def worker(rid, role, extra_env=None):
        env = dict(os.environ, **_worker_env(device), **(extra_env or {}))
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else []))
        return subprocess.Popen(
            serve_worker_cmd(pool.port, "llama", spec, rid, role),
            cwd=REPO_ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    procs = [
        worker(0, "prefill"),
        worker(1, "decode",
               {"TTD_FAULT_PLAN":
                f"serve:dispatch:{kill_dispatch}:killpid:replica=1"}),
        worker(2, "decode"),
    ]
    handoffs = 0
    results: list = []
    try:
        checks["workers_ready"] = pool.wait_ready(timeout=timeout_s)
        rec = events.get_recorder()
        cursor, _ = rec.events_after(0)
        done = threading.Event()
        box: list = []

        def clients():
            box.append(_run_clients(gw.port, reqs, sampling, timeout_s))
            done.set()

        threading.Thread(target=clients, daemon=True).start()
        # Kill the prefill worker the instant the first handoff lands:
        # later long prompts must degrade to a local prefill.
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not done.is_set():
            cursor, evs = rec.events_after(cursor)
            handoffs += sum(1 for e in evs if e[0] == "request/kv_handoff")
            if handoffs:
                procs[0].kill()
                break
            time.sleep(0.005)
        done.wait(timeout_s)
        results = box[0] if box else [None] * len(reqs)
        _parity_checks(checks, results, refs)
        checks["handoff_happened"] = handoffs >= 1
        states = pool.replica_states()

        def dead_as_disconnect(pid):
            dead = [s for s in states
                    if s["state"] == "dead" and s.get("pid") == pid]
            return (len(dead) == 1
                    and dead[0].get("failure_class") == "disconnected")

        checks["prefill_worker_dead"] = dead_as_disconnect(procs[0].pid)
        checks["decode_worker_dead"] = dead_as_disconnect(procs[1].pid)
        checks["failover_happened"] = gw.metrics.failovers.value() >= 1
        checks["healthz_routable"] = _healthz_routable(gw.port)
    finally:
        gw.drain(timeout=60)
        for proc in procs:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)
    return _verdict(checks, results, mode="serving-disagg",
                    leg="sampled" if sampling else "greedy",
                    failovers=gw.metrics.failovers.value(),
                    handoffs=handoffs)


def run_serving_chaos_migrate(*, sampling: bool = True,
                              speculative: bool = False,
                              n_requests: int = 6, replicas: int = 3,
                              watchdog_timeout_s: float = 10.0,
                              timeout_s: float = 300.0,
                              device: str = "cuda") -> dict:
    """The live-migration leg (the module docstring).  Each hop is asked
    for after a committed chunk, so it is provably mid-generation; once a
    stream has both hops, its current replica is armed to vanish at its
    next dispatch while another migration begins (re-armed on later
    chunks until a replica dies; a fired plan is not re-armed, so the
    lag before the death is declared cannot cascade through the
    fleet)."""
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.runtime import events, faults
    from tensorflow_train_distributed_torch.server import ServingGateway
    from tensorflow_train_distributed_torch.server.worker import (
        llama_params,
    )
    from tensorflow_train_distributed_torch.serving import ServingEngine

    checks = {}
    cfg, params = llama_params(PRESET, 0, device)
    # slots=3 leaves the fleet under-subscribed (9 slots, 6 streams): a
    # hop needs a free lane on another replica.
    kw = dict(_engine_kw(sampling, slots=3), prompt_buckets=(8, 16, 32))
    if speculative:
        import torch

        if sampling:
            raise ValueError("speculative leg runs greedy")
        draft_cfg = dataclasses.replace(cfg, num_layers=1, num_heads=2,
                                        num_kv_heads=1)
        draft_params = convert.init_params(
            draft_cfg, torch.Generator(device=device).manual_seed(123),
            device=device)
        kw.update(draft_config=draft_cfg, draft_params=draft_params,
                  speculative_k=3)
    rng = np.random.default_rng(0)
    # Even requests span more than one KV block (their export ships
    # rows); max_new >= 28 (7+ chunks) leaves a lagging client time to
    # see the chunks both hops wait for.
    reqs = []
    for i in range(n_requests):
        plen = (int(rng.integers(18, 28)) if i % 2 == 0
                else int(rng.integers(2, 8)))
        reqs.append(([int(t) for t in rng.integers(1, 200, plen)],
                     int(rng.integers(28, 36)), 1000 + i))
    ref_eng = ServingEngine(cfg, params, device=device, **kw)
    rids = [ref_eng.submit(p, m, seed=s if sampling else None)
            for p, m, s in reqs]
    ref_out = ref_eng.run()
    refs = [ref_out[r] for r in rids]
    engines = [ServingEngine(cfg, params, device=device, **kw)
               for _ in range(replicas)]
    for e in engines:
        e.submit([1, 2, 3], 5, seed=0 if sampling else None)
        e.run()
    gw = ServingGateway(engines, host="127.0.0.1", port=0,
                        max_queue=4 * n_requests,
                        watchdog_timeout_s=watchdog_timeout_s).start()
    rec = events.get_recorder()
    cursor, _ = rec.events_after(0)
    migrations = [0] * n_requests
    kill_lock = threading.Lock()

    def on_chunk(i, rid):
        if migrations[i] >= 2:
            with kill_lock:
                if any(s["state"] == "dead"
                       for s in gw.pool.replica_states()):
                    return
                cur = faults.plan()
                if cur is not None and any(e.fired for e in cur.entries):
                    return
                preq = gw.pool._requests.get(rid)
                src = preq.replica if preq is not None else None
                if src is None:
                    return
                faults.arm(f"serve:dispatch:1:kill9:replica={src.idx}")
        if gw.pool.migrate(rid):
            migrations[i] += 1

    moved_bytes = 0
    results: list = []
    try:
        results = _run_clients(gw.port, reqs, sampling, timeout_s,
                               on_chunk)
        _parity_checks(checks, results, refs)
        checks["every_stream_migrated_twice"] = all(
            m >= 2 for m in migrations)
        _, evs = rec.events_after(cursor)
        moved_bytes = sum(e[5].get("bytes", 0) for e in evs
                          if e[0] == "request/migrate")
        checks["kv_bytes_moved"] = moved_bytes > 0
        # The death declaration can lag the last completion (a laneless
        # vanished replica is noticed by the watchdog's liveness scan).
        deadline = time.monotonic() + max(15.0, watchdog_timeout_s + 5)
        while time.monotonic() < deadline:
            states = gw.pool.replica_states()
            if any(s["state"] == "dead" for s in states):
                break
            time.sleep(0.25)
        n_dead = sum(s["state"] == "dead" for s in states)
        checks["replica_died"] = 1 <= n_dead <= replicas - 1
        checks["healthz_routable"] = _healthz_routable(gw.port)
    finally:
        faults.disarm()
        gw.drain(timeout=30)
    return _verdict(checks, results, mode="serving-migrate",
                    leg=("speculative" if speculative
                         else "sampled" if sampling else "greedy"),
                    migrations=migrations, migrated_kv_bytes=moved_bytes)


LEGS = {"serving": run_serving_chaos, "serving-procs": run_serving_chaos_procs,
        "serving-disagg": run_serving_chaos_disagg,
        "serving-migrate": run_serving_chaos_migrate}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(
        prog="chaos_check",
        description="serving chaos gate: kill, fail over and migrate a "
                    "fleet under load")
    p.add_argument("--serving", action="store_true",
                   help="kill one of two gateway replicas mid-stream "
                        "under load; accepted requests must complete on "
                        "the survivor token-equal to an uninterrupted "
                        "single-engine run (greedy + sampled legs)")
    p.add_argument("--procs", action="store_true",
                   help="with --serving: the replicas are worker "
                        "processes and one takes a real SIGKILL "
                        "mid-stream; the pool must respawn it")
    p.add_argument("--disagg", action="store_true",
                   help="with --serving: a 1-prefill + 2-decode dial-in "
                        "fleet loses the prefill worker mid-handoff and "
                        "a decode worker mid-stream (real SIGKILLs)")
    p.add_argument("--migrate", action="store_true",
                   help="with --serving: every stream on a 3-replica "
                        "gateway migrates twice mid-generation, one "
                        "replica dies mid-migration; plus a speculative "
                        "greedy run")
    p.add_argument("--device", default="cuda",
                   help="torch device of every engine (default cuda)")
    args = p.parse_args(argv)
    if not args.serving:
        p.error("only the serving legs (--serving) are ported; the "
                "training legs wait for ROADMAP Queue 1 step 8")
    if sum((args.procs, args.disagg, args.migrate)) > 1:
        p.error("--procs, --disagg and --migrate are separate serving "
                "legs; pick one")
    mode = ("serving-migrate" if args.migrate
            else "serving-disagg" if args.disagg
            else "serving-procs" if args.procs else "serving")
    run = LEGS[mode]
    greedy = run(sampling=False, device=args.device)
    sampled = run(sampling=True, device=args.device)
    verdict = {"ok": greedy["ok"] and sampled["ok"], "mode": mode,
               "greedy": greedy, "sampled": sampled}
    if args.migrate:
        spec = run(sampling=False, speculative=True, device=args.device)
        verdict["speculative"] = spec
        verdict["ok"] = verdict["ok"] and spec["ok"]
    print(json.dumps(verdict))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
