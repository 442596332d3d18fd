"""Closed-loop load generator for the HTTP serving gateway
(``serve_http.py``'s ``server/gateway.py``) over the port's engines.

    python -m tensorflow_train_distributed_torch.tools.bench_gateway \\
        [--preset llama_tiny] [--clients 8] [--requests-per-client 8] \\
        [--replicas N] [--replica-procs | --disagg | --migrate-drain |
         --mixed] [--base-url URL] [--device cuda|cpu]

``--clients`` closed-loop clients each send their next request only when
the previous one is answered.  Reported: p50/p99 request latency,
generated tokens/s, mean TTFT and inter-token time (the gateway's own
``/metrics`` histograms, net of a scrape taken before the timed window),
and the shed rate (429s an attempt; a shed client honours Retry-After).
In-process runs A/B the engine's overlapped decode (on: the headline;
off: ``no_overlap``); ``--no-ab`` skips the off leg.  Every in-process
record carries ``decode_bytes_per_step`` and ``mbu``
(``decode_mbu_fields``).

- ``--mixed``: streaming clients decode on most lanes while one long
  prompt is injected, interleaved prefill against its atomic-admission
  kill switch; the active lanes' client-observed p99 inter-token time
  during the admission and the injected TTFTs.
- ``--replica-procs``: subprocess workers (``server/procpool.py``)
  against in-process replicas on one workload, leg-order-alternating
  pairs (median of per-pair wall ratios), plus failover recovery (a real
  SIGKILL against the in-process kill9 vanish).
- ``--disagg``: a 1-prefill + N-decode TCP fleet (``serve_worker.py``
  daemons) against N+1 co-located workers, with the handoff bytes a
  request from ``/metrics``.
- ``--migrate-drain``: draining a replica with live lane migration
  against drain by failover: the p99 resume gap and the KV bytes moved.

Weights are random (``server.worker.llama_params``, the port's seeded
draw); the engines run on ``--device`` (the card by default, under the
card lock; ``--device cpu`` reports every device metric as null, and
worker processes get ``OMP_NUM_THREADS=1`` there).  ``--base-url``
targets a gateway launched elsewhere (engine flags ignored).  The last
line of standard output is one JSON record.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

from tensorflow_train_distributed_torch.runtime.lint.registry import (
    thread_role,
)
from tensorflow_train_distributed_torch.tools import bench_lm as B

# Load-generation threads carry the ``loadgen`` role, so the lock
# sanitizer and the flight recorder tell bench traffic from the
# gateway's own handler threads.
_loadgen_role = thread_role("loadgen")


def _requests_for(client: int, n: int, plo, phi, glo, ghi, vocab, seed):
    """Client ``client``'s seeded stream: ``n`` (prompt, max_new)."""
    import numpy as np

    rng = np.random.default_rng(seed + 1000 * client)
    return [([int(t) for t in
              rng.integers(1, vocab, int(rng.integers(plo, phi + 1)))],
             int(rng.integers(glo, ghi + 1))) for _ in range(n)]


def mean_context(reqs) -> float:
    """KV rows a lane reads in a decode step, averaged over a stream of
    (prompt, max_new): the prompt plus half the new tokens."""
    return sum(len(p) + m / 2 for p, m in reqs) / max(1, len(reqs))


def decode_mbu_fields(cfg, params, slots: int, context: float,
                      tokens_per_sec, device: str, scales=None) -> dict:
    """The decode byte bound and MBU of a serving record: ``tools/
    roofline.py``'s ``decode_bytes_per_step`` of ``slots`` lanes at
    ``context`` rows each, and steps/s = ``tokens_per_sec`` / ``slots``
    (a full step emits a token a lane) over the card's HBM rate.  ``mbu``
    is None on the CPU or with no rate: not measured."""
    from tensorflow_train_distributed_torch.tools import roofline

    nbytes = roofline.decode_bytes_per_step(cfg, params, scales, slots,
                                            context)["bytes"]
    out = {"decode_bytes_per_step": int(nbytes), "mbu": None}
    bw = B.hbm_bytes_per_sec(device)
    if bw and tokens_per_sec:
        out["mbu"] = nbytes * tokens_per_sec / slots / bw
    return out


def _post(base_url: str, body: dict, timeout: float):
    """(status, parsed_json, retry_after_s); a network failure is status
    0, so every request lands in exactly one of ok / shed / failed."""
    req = urllib.request.Request(
        base_url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), 0.0
    except urllib.error.HTTPError as e:
        retry = float(e.headers.get("Retry-After") or 1.0)
        with contextlib.suppress(OSError):
            e.read()
        return e.code, None, retry
    except OSError:       # URLError, socket timeout, connection reset
        return 0, None, 0.0


class _Client(threading.Thread):
    """One closed-loop client: request, wait for the answer, next."""

    def __init__(self, base_url, reqs, timeout, max_retries):
        super().__init__(daemon=True)
        self.base_url, self.reqs = base_url, reqs
        self.timeout, self.max_retries = timeout, max_retries
        self.latencies, self.gen_tokens = [], 0
        self.sheds = self.failures = 0

    @_loadgen_role
    def run(self):
        for prompt, max_new in self.reqs:
            body = {"prompt": prompt, "max_new": max_new}
            for _ in range(self.max_retries):
                t0 = time.perf_counter()
                status, obj, retry_after = _post(self.base_url, body,
                                                 self.timeout)
                if status == 200:
                    self.latencies.append(time.perf_counter() - t0)
                    self.gen_tokens += len(obj["tokens"]) - len(prompt)
                    break
                if status == 429:
                    self.sheds += 1
                    time.sleep(retry_after)
                    continue
                self.failures += 1
                break
            else:
                self.failures += 1


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * (len(sorted_vals) - 1) + 0.5))]


def _prom_sample(text: str, name: str) -> float:
    """One unlabelled sample from a Prometheus text body (0.0 if absent)."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _scrape(base_url: str) -> str:
    try:
        with urllib.request.urlopen(base_url + "/metrics", timeout=10) as r:
            return r.read().decode()
    except OSError:
        return ""


def _histogram_mean_ms(text: str, name: str, base: str = "") -> float:
    """Mean in ms of a cumulative histogram, net of an earlier scrape
    ``base`` (the timed window alone)."""
    count = (_prom_sample(text, f"{name}_count")
             - _prom_sample(base, f"{name}_count"))
    total = (_prom_sample(text, f"{name}_sum")
             - _prom_sample(base, f"{name}_sum"))
    return 1e3 * total / count if count > 0 else 0.0


def _run_closed_loop(base_url, clients, requests_per_client, prompt_range,
                     new_range, vocab, seed, timeout):
    """One warm-up request, then the closed-loop fleet against
    ``base_url``: the latency and throughput fields, and the gateway's
    TTFT, inter-token and overlap readings over the timed window."""
    status, _, _ = _post(base_url, {"prompt": [1, 2, 3], "max_new": 4},
                         timeout)
    if status != 200:
        raise RuntimeError(f"warmup request failed with HTTP {status}")
    prom_base = _scrape(base_url)
    workers = [_Client(base_url, _requests_for(
        c, requests_per_client, *prompt_range, *new_range, vocab, seed),
        timeout, max_retries=100) for c in range(clients)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    dt = time.perf_counter() - t0
    lats = sorted(x for w in workers for x in w.latencies)
    gen = sum(w.gen_tokens for w in workers)
    sheds = sum(w.sheds for w in workers)
    failures = sum(w.failures for w in workers)
    attempts = len(lats) + sheds + failures
    prom = _scrape(base_url)
    return {
        "tokens_per_sec": gen / dt if dt else 0.0,
        "wall_s": dt,
        "p50_latency_ms": 1e3 * _percentile(lats, 0.50),
        "p99_latency_ms": 1e3 * _percentile(lats, 0.99),
        "ttft_ms_mean": _histogram_mean_ms(
            prom, "ttd_gateway_ttft_seconds", prom_base),
        "inter_token_ms_mean": _histogram_mean_ms(
            prom, "ttd_gateway_inter_token_seconds", prom_base),
        "overlap_ratio": _prom_sample(prom, "ttd_engine_overlap_ratio"),
        "prefill_stall_s": (
            _prom_sample(prom, "ttd_engine_prefill_stall_seconds")
            - _prom_sample(prom_base, "ttd_engine_prefill_stall_seconds")),
        "shed_rate": sheds / attempts if attempts else 0.0,
        "n_ok": len(lats),
        "n_shed": sheds,
        "n_failed": failures,
        "gen_tokens": gen,
    }


# The timed fields of a record, which a CPU run leaves null.
TIMED = ("tokens_per_sec", "wall_s", "p50_latency_ms", "p99_latency_ms",
         "ttft_ms_mean", "inter_token_ms_mean", "overlap_ratio",
         "prefill_stall_s", "value", "p99_inter_token_ms_active",
         "max_gap_ms_active", "ttft_long_ms", "ttft_short_behind_long_ms",
         "p99_ms", "gaps_ms", "p99_resume_ms_median", "per_pair_p99_ms",
         "p99_ratio_median", "pair_p99_ratios", "wall_ratio_median",
         "pair_wall_ratios", "p99_improvement", "overlap_speedup",
         "failover_recovery_ms")


def _null_timed(obj, device: str, keys=TIMED):
    """``obj`` with every field of ``keys`` null, through nested legs, on
    the CPU: a CPU run measures no device."""
    if device != "cpu" or not isinstance(obj, dict):
        return obj
    return {k: (None if k in keys else _null_timed(v, device, keys))
            for k, v in obj.items()}


def _engine(cfg, params, device, **kw):
    from tensorflow_train_distributed_torch.serving import ServingEngine

    return ServingEngine(cfg, params, device=device, **kw)


def _warm(engines):
    for e in engines:                 # compile-free, but first allocations
        e.submit([1, 2, 3], 5)
        e.run()
    return engines


class _StreamLane(threading.Thread):
    """One streaming client: posts a ``stream`` request and records each
    NDJSON chunk's (arrival, token count)."""

    def __init__(self, base_url, prompt, max_new, timeout):
        super().__init__(daemon=True)
        self.base_url, self.prompt = base_url, prompt
        self.max_new, self.timeout = max_new, timeout
        self.events: list = []
        self.first_token_at = None
        self.error = None

    @_loadgen_role
    def run(self):
        req = urllib.request.Request(
            self.base_url + "/v1/generate",
            data=json.dumps({"prompt": self.prompt, "max_new": self.max_new,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                for raw in r:
                    obj = json.loads(raw)
                    if "tokens" in obj:
                        now = time.perf_counter()
                        if self.first_token_at is None:
                            self.first_token_at = now
                        self.events.append((now, len(obj["tokens"])))
                    elif "error" in obj:
                        self.error = obj["error"]
        except (OSError, http.client.HTTPException, ValueError) as e:
            self.error = f"{type(e).__name__}: {e}"


def _mixed_gateway_pass(base_url, lanes, active_new, long_prompt,
                        tail_prompt, vocab, seed, timeout):
    """Fill ``lanes`` streaming clients, wait until all decode, inject one
    long prompt then a short one, and measure the active clients'
    per-token gaps during the admission window."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lanes_t = [_StreamLane(base_url,
                           [int(t) for t in rng.integers(1, vocab, 8)],
                           active_new, timeout) for _ in range(lanes)]
    for w in lanes_t:
        w.start()
    deadline = time.perf_counter() + timeout
    while (any(w.first_token_at is None for w in lanes_t)
           and time.perf_counter() < deadline):
        if any(w.error for w in lanes_t):
            raise RuntimeError(
                f"active lane failed: {[w.error for w in lanes_t]}")
        time.sleep(0.002)
    if any(w.first_token_at is None for w in lanes_t):
        raise RuntimeError("an active lane produced no token before the "
                           "timeout: no truncated p99 is reported")
    t_inject = time.perf_counter()
    long_t = _StreamLane(base_url, long_prompt, 8, timeout)
    long_t.start()
    tail_t = _StreamLane(base_url, tail_prompt, 8, timeout)
    tail_t.start()
    for w in lanes_t + [long_t, tail_t]:
        w.join(timeout)
    failed = [w.error for w in lanes_t + [long_t, tail_t] if w.error]
    if failed:
        raise RuntimeError(f"mixed pass had failed requests: {failed}")
    if long_t.first_token_at is None or tail_t.first_token_at is None:
        raise RuntimeError("injected request produced no tokens")
    t_end = long_t.first_token_at
    gaps = []
    for w in lanes_t:
        prev = None
        for t, n in w.events:
            if prev is not None and t_inject <= t <= t_end and n:
                gaps.extend([(t - prev) / n] * n)
            prev = t
    gaps.sort()
    return {
        "p99_inter_token_ms_active": 1e3 * _percentile(gaps, 0.99),
        "max_gap_ms_active": 1e3 * gaps[-1] if gaps else 0.0,
        "ttft_long_ms": 1e3 * (long_t.first_token_at - t_inject),
        "ttft_short_behind_long_ms": 1e3 * (tail_t.first_token_at
                                            - t_inject),
    }


def _model(preset: str, device: str):
    from tensorflow_train_distributed_torch.server.worker import llama_params

    return llama_params(preset, 0, device)


def bench_gateway_mixed(preset, slots, chunk, max_queue, seed, timeout, *,
                        device, prefill_chunk=16, long_pieces=6, reps=3):
    """--mixed through HTTP streaming clients: what a user of the gateway
    observes, interleave on against ``prefill_budget=0``."""
    import numpy as np

    from tensorflow_train_distributed_torch.server import ServingGateway

    cfg, params = _model(preset, device)
    vocab = min(cfg.vocab_size, 30_000)
    rng = np.random.default_rng(seed + 1)
    lanes = max(1, slots - 2)
    long_len = prefill_chunk * long_pieces
    long_prompt = [int(t) for t in rng.integers(1, vocab, long_len)]
    tail_prompt = [int(t) for t in rng.integers(1, vocab, 8)]
    active_new = chunk * (long_pieces + 6)
    cache_len = max(long_len + 16, 8 + active_new + 8)

    def one_mode(interleave):
        eng = _engine(cfg, params, device, slots=slots, chunk=chunk,
                      cache_len=cache_len, prefill_chunk=prefill_chunk,
                      prefill_budget=None if interleave else 0)
        gw = ServingGateway(eng, host="127.0.0.1", port=0,
                            max_queue=max_queue).start()
        url = f"http://127.0.0.1:{gw.port}"
        try:
            args = (url, lanes, active_new, long_prompt, tail_prompt,
                    vocab, seed, timeout)
            _mixed_gateway_pass(*args)          # warm-up
            stall0 = eng.prefill_stall_s()
            best = None
            n = max(1, reps)
            for _ in range(n):
                rec = _mixed_gateway_pass(*args)
                if (best is None or rec["p99_inter_token_ms_active"]
                        < best["p99_inter_token_ms_active"]):
                    best = rec
            best["prefill_stall_s"] = (eng.prefill_stall_s() - stall0) / n
            return best
        finally:
            gw.drain(timeout=30)

    on, off = one_mode(True), one_mode(False)
    rec = {"metric": f"{preset}_gateway_mixed_p99_inter_token_ms",
           "value": on["p99_inter_token_ms_active"],
           "unit": "ms p99 active-lane inter-token during long admission",
           "slots": slots, "chunk": chunk, "prefill_chunk": prefill_chunk,
           "long_prompt_len": long_len, "long_pieces": long_pieces,
           "interleave": on, "no_interleave": off}
    if on["p99_inter_token_ms_active"]:
        rec["p99_improvement"] = (off["p99_inter_token_ms_active"]
                                  / on["p99_inter_token_ms_active"])
    return rec


def bench_gateway(base_url, preset, slots, chunk, max_queue, clients,
                  requests_per_client, prompt_range, new_range, cache_len,
                  seed, timeout, *, device="cuda", overlap_ab=True,
                  replicas=1):
    loop_args = (clients, requests_per_client, prompt_range, new_range)

    def finish(rec):
        out = {"metric": f"{preset}_gateway_tokens_per_sec",
               "value": rec.pop("tokens_per_sec"),
               "unit": "generated tokens/sec", "clients": clients,
               "requests_per_client": requests_per_client, "slots": slots,
               "chunk": chunk, "max_queue": max_queue, "replicas": replicas,
               "n_requests": clients * requests_per_client}
        out.update(rec)
        return out

    if base_url:
        # An external gateway's engine is whatever it was launched with.
        return finish(_run_closed_loop(base_url, *loop_args, 30_000, seed,
                                       timeout))
    from tensorflow_train_distributed_torch.server import ServingGateway

    cfg, params = _model(preset, device)
    vocab = min(cfg.vocab_size, 30_000)

    def one_mode(overlap):
        engines = _warm([_engine(cfg, params, device, slots=slots,
                                 chunk=chunk, cache_len=cache_len,
                                 overlap=overlap) for _ in range(replicas)])
        gw = ServingGateway(engines if replicas > 1 else engines[0],
                            host="127.0.0.1", port=0,
                            max_queue=max_queue).start()
        try:
            return _run_closed_loop(f"http://127.0.0.1:{gw.port}",
                                    *loop_args, vocab, seed, timeout)
        finally:
            gw.drain(timeout=30)

    context = mean_context([r for c in range(clients) for r in _requests_for(
        c, requests_per_client, *prompt_range, *new_range, vocab, seed)])
    rec = finish(one_mode(overlap=True))
    rec["mean_context"] = context
    rec.update(decode_mbu_fields(cfg, params, slots, context, rec["value"],
                                 device))
    if overlap_ab:
        off = one_mode(overlap=False)
        off.update(decode_mbu_fields(cfg, params, slots, context,
                                     off["tokens_per_sec"], device))
        rec["no_overlap"] = off
        if rec["value"] and off["tokens_per_sec"]:
            rec["overlap_speedup"] = rec["value"] / off["tokens_per_sec"]
    return rec


def _recovery_gap_ms(pool, kill, prompt, max_new, reps, timeout):
    """The widest client-observed inter-chunk gap of one streaming
    request whose replica ``kill`` takes after its first chunk (death
    detection, re-placement and resume); the median over ``reps``."""
    gaps = []
    for _ in range(reps):
        h = pool.submit(list(prompt), max_new, stream=True,
                        timeout_s=timeout)
        it = h.iter_tokens()
        next(it)
        rep = pool._requests[h.id].replica
        t_kill = time.perf_counter()
        kill(rep)
        prev, worst = t_kill, 0.0
        for _chunk in it:
            now = time.perf_counter()
            worst = max(worst, now - prev)
            prev = now
        gaps.append(worst)
    gaps.sort()
    return 1e3 * gaps[len(gaps) // 2]


def _worker_env(device: str) -> dict:
    """Worker processes' environment: the repository on their path; one
    intra-op thread each on the CPU, where N workers share the cores."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {"PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    return env


def bench_gateway_procs_ab(preset, slots, chunk, max_queue, clients,
                           requests_per_client, prompt_range, new_range,
                           cache_len, seed, timeout, *, device="cuda",
                           replicas=2, reps=3):
    """Subprocess workers against in-process replicas on one closed-loop
    workload (leg-order-alternating pairs, median of per-pair wall
    ratios), then failover recovery on each pool."""
    import signal

    from tensorflow_train_distributed_torch.runtime import faults
    from tensorflow_train_distributed_torch.server import (
        ProcPool,
        ServingGateway,
        WorkerSpec,
    )

    cfg, params = _model(preset, device)
    vocab = min(cfg.vocab_size, 30_000)
    cache_len = cache_len or min(256, cfg.max_positions)
    loop_args = (clients, requests_per_client, prompt_range, new_range)
    kw = dict(slots=slots, chunk=chunk, cache_len=cache_len)
    engines = _warm([_engine(cfg, params, device, **kw)
                     for _ in range(replicas)])
    gw_in = ServingGateway(engines, host="127.0.0.1", port=0,
                           max_queue=max_queue).start()
    spec = WorkerSpec(factory="llama", factory_json=dict(
        preset=preset, init_seed=0, device=device, **kw),
        env=_worker_env(device))
    pool = ProcPool(spec, replicas=replicas, max_queue=max_queue,
                    monitor_poll_s=0.02, restart_backoff_s=0.05)
    gw_proc = ServingGateway(pool, host="127.0.0.1", port=0).start()
    urls = {"in_process": f"http://127.0.0.1:{gw_in.port}",
            "procs": f"http://127.0.0.1:{gw_proc.port}"}
    try:
        if not pool.wait_ready(timeout=600.0):
            raise RuntimeError("subprocess workers failed to come up")
        best, ratios = {}, []
        for i in range(max(1, reps)):
            walls = {}
            for leg in (("in_process", "procs") if i % 2 == 0
                        else ("procs", "in_process")):
                rec = _run_closed_loop(urls[leg], *loop_args, vocab, seed,
                                       timeout)
                walls[leg] = rec["wall_s"]
                if leg not in best or rec["wall_s"] < best[leg]["wall_s"]:
                    best[leg] = rec
            ratios.append(walls["procs"] / walls["in_process"])
        ratios.sort()
        rec_prompt, rec_new = [1, 2, 3, 4], max(64, new_range[1])
        recovery = {"procs": _recovery_gap_ms(
            pool, lambda rep: os.kill(rep.driver.pid, signal.SIGKILL),
            rec_prompt, rec_new, reps, timeout)}
        gaps = []
        for _ in range(reps):
            # In-process replicas never come back: a fresh pool a run.
            gw3 = ServingGateway(_warm([_engine(cfg, params, device, **kw)
                                        for _ in range(replicas)]),
                                 host="127.0.0.1", port=0,
                                 max_queue=max_queue).start()
            try:
                gaps.append(_recovery_gap_ms(
                    gw3.pool, lambda rep: faults.arm(
                        f"serve:dispatch:1:kill9:replica={rep.idx}"),
                    rec_prompt, rec_new, 1, timeout))
            finally:
                faults.disarm()
                gw3.drain(timeout=30)
        gaps.sort()
        recovery["in_process"] = gaps[len(gaps) // 2]
    finally:
        gw_proc.drain(timeout=60)
        gw_in.drain(timeout=30)
    return {
        "metric": f"{preset}_gateway_proc_replicas_tokens_per_sec",
        "value": best["procs"]["tokens_per_sec"],
        "unit": "generated tokens/sec, subprocess workers "
                "(wall_ratio_median: procs/in-process, median of "
                "per-pair wall ratios)",
        "replicas": replicas, "slots": slots, "chunk": chunk,
        "cache_len": cache_len, "clients": clients,
        "requests_per_client": requests_per_client, "max_queue": max_queue,
        "reps": reps, "procs": best["procs"],
        "in_process": best["in_process"],
        "wall_ratio_median": ratios[len(ratios) // 2],
        "pair_wall_ratios": ratios,
        "failover_recovery_ms": recovery,
        "worker_restarts": pool.restarts_total()}


def bench_gateway_disagg_ab(preset, slots, chunk, max_queue, clients,
                            requests_per_client, prompt_range, new_range,
                            cache_len, seed, timeout, *, device="cuda",
                            decode_workers=2, reps=3):
    """A disaggregated TCP fleet (1 prefill + N decode ``serve_worker``
    daemons) against N+1 co-located workers on one closed-loop workload
    (leg-order-alternating pairs), with the handoffs and their bytes a
    request from the gateway's counters."""
    import subprocess

    from tensorflow_train_distributed_torch.server import (
        NetPool,
        ServingGateway,
    )

    cfg = _model_config(preset)
    vocab = min(cfg.vocab_size, 30_000)
    cache_len = cache_len or (prompt_range[1] + new_range[1] + 24)
    buckets = [8, 16, 32, 48]
    while buckets[-1] < prompt_range[1]:
        buckets.append(buckets[-1] * 2)
    loop_args = (clients, requests_per_client, prompt_range, new_range)
    spec_json = json.dumps(dict(preset=preset, init_seed=0, slots=slots,
                                chunk=chunk, cache_len=cache_len,
                                prompt_buckets=buckets, device=device))
    env = dict(os.environ, **_worker_env(device))

    def fleet(roles):
        pool = NetPool(host="127.0.0.1", port=0, scale_min=len(roles),
                       max_workers=len(roles), max_queue=max_queue,
                       monitor_poll_s=0.02)
        gw = ServingGateway(pool, host="127.0.0.1", port=0).start()
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "tensorflow_train_distributed_torch.serve_worker",
             "--dial", f"127.0.0.1:{pool.port}", "--factory", "llama",
             "--json", spec_json, "--replica-id", str(i), "--role", role],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for i, role in enumerate(roles)]
        return pool, gw, procs

    pool_d, gw_d, procs_d = fleet(["prefill"] + ["decode"] * decode_workers)
    pool_c, gw_c, procs_c = fleet(["both"] * (decode_workers + 1))
    urls = {"disagg": f"http://127.0.0.1:{gw_d.port}",
            "colocated": f"http://127.0.0.1:{gw_c.port}"}
    try:
        for pool, what in ((pool_d, "disagg"), (pool_c, "colocated")):
            if not pool.wait_ready(timeout=600.0):
                raise RuntimeError(f"{what} workers failed to come up")
        if pool_d.workers_by_role() != {"prefill": 1,
                                        "decode": decode_workers}:
            raise RuntimeError("disagg fleet lost its role split")
        best, ratios = {}, []
        handoffs_total = handoff_bytes_total = disagg_ok_total = 0
        for i in range(max(1, reps)):
            walls = {}
            for leg in (("disagg", "colocated") if i % 2 == 0
                        else ("colocated", "disagg")):
                base = _scrape(urls[leg])
                rec = _run_closed_loop(urls[leg], *loop_args, vocab, seed,
                                       timeout)
                prom = _scrape(urls[leg])
                if leg == "disagg":
                    rec["handoffs"] = int(
                        _prom_sample(prom, "ttd_gateway_handoff_seconds_count")
                        - _prom_sample(base,
                                       "ttd_gateway_handoff_seconds_count"))
                    handoffs_total += rec["handoffs"]
                    leg_bytes = int(
                        _prom_sample(prom, "ttd_gateway_handoff_bytes_total")
                        - _prom_sample(base,
                                       "ttd_gateway_handoff_bytes_total"))
                    handoff_bytes_total += leg_bytes
                    disagg_ok_total += rec["n_ok"]
                    rec["handoff_bytes_per_request"] = (
                        leg_bytes / max(1, rec["n_ok"]))
                walls[leg] = rec["wall_s"]
                if leg not in best or rec["wall_s"] < best[leg]["wall_s"]:
                    best[leg] = rec
            ratios.append(walls["disagg"] / walls["colocated"])
        ratios.sort()
        if handoffs_total == 0:
            raise RuntimeError(
                "the disagg legs never handed off: every prompt fits one "
                "KV block; widen --prompt-range")
    finally:
        gw_d.drain(timeout=60)
        gw_c.drain(timeout=60)
        for proc in procs_d + procs_c:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)
    return {
        "metric": f"{preset}_gateway_disagg_tokens_per_sec",
        "value": best["disagg"]["tokens_per_sec"],
        "unit": "generated tokens/sec, disaggregated prefill/decode TCP "
                "fleet (wall_ratio_median: disagg/colocated, median of "
                "per-pair wall ratios)",
        "prefill_workers": 1, "decode_workers": decode_workers,
        "colocated_workers": decode_workers + 1, "slots": slots,
        "chunk": chunk, "cache_len": cache_len, "prompt_buckets": buckets,
        "clients": clients, "requests_per_client": requests_per_client,
        "max_queue": max_queue, "reps": reps, "disagg": best["disagg"],
        "colocated": best["colocated"],
        "wall_ratio_median": ratios[len(ratios) // 2],
        "pair_wall_ratios": ratios, "handoffs_total": handoffs_total,
        "handoff_bytes_per_request": (handoff_bytes_total
                                      / max(1, disagg_ok_total))}


def _model_config(preset: str):
    from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS

    return LLAMA_PRESETS[preset]


def bench_gateway_migrate_drain_ab(preset, slots, chunk, max_queue,
                                   cache_len, seed, timeout, *,
                                   device="cuda", replicas=2, streams=4,
                                   max_new=64, reps=5):
    """Draining a replica that serves live streams: live lane migration
    (KV shipped, decode resumes warm) against failover (the kill9
    vanish: the streams re-prefill), leg-order-alternating pairs on fresh
    gateways; the p99 of the widest client-observed gap of the victim's
    streams, and the migrated KV bytes from the flight recorder."""
    import numpy as np

    from tensorflow_train_distributed_torch.runtime import events, faults
    from tensorflow_train_distributed_torch.server import ServingGateway

    cfg, params = _model(preset, device)
    vocab = min(cfg.vocab_size, 30_000)
    cache_len = cache_len or min(256, cfg.max_positions)
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(1, vocab, 24)]
               for _ in range(streams)]

    def one_leg(mode):
        gw = ServingGateway(_warm([_engine(cfg, params, device, slots=slots,
                                           chunk=chunk, cache_len=cache_len)
                                   for _ in range(replicas)]),
                            host="127.0.0.1", port=0,
                            max_queue=max_queue).start()
        pool = gw.pool
        rec_ = events.get_recorder()
        cursor, _ = rec_.events_after(0)
        arrivals = [[] for _ in range(streams)]
        first = [threading.Event() for _ in range(streams)]
        errs = [None] * streams

        def consume(i, it):
            try:
                for _chunk in it:
                    arrivals[i].append(time.perf_counter())
                    first[i].set()
            except (RuntimeError, TimeoutError) as e:
                errs[i] = e
            finally:
                first[i].set()

        try:
            handles = [pool.submit(list(p), max_new, stream=True,
                                   timeout_s=timeout) for p in prompts]
            threads = [threading.Thread(
                target=consume, args=(i, h.iter_tokens()), daemon=True)
                for i, h in enumerate(handles)]
            for t in threads:
                t.start()
            for ev in first:
                if not ev.wait(timeout):
                    raise RuntimeError("a stream never produced a chunk")
            if any(errs):
                raise RuntimeError(f"a stream died before the drain: {errs}")
            victim = pool._requests[handles[0].id].replica
            affected = [i for i, h in enumerate(handles)
                        if pool._requests[h.id].replica is victim]
            t0 = time.perf_counter()
            if mode == "migrate":
                pool._evacuate(victim)
                victim.driver.drain()
            else:
                faults.arm(f"serve:dispatch:1:kill9:replica={victim.idx}")
            for t in threads:
                t.join(timeout)
                if t.is_alive():
                    raise RuntimeError(f"{mode} leg: a stream wedged")
            if any(errs):
                raise RuntimeError(f"{mode} leg stream error: {errs}")
            gaps = []
            for i in affected:
                prev, worst = t0, 0.0
                for ts in arrivals[i]:
                    if ts <= t0:
                        continue
                    worst = max(worst, ts - prev)
                    prev = ts
                gaps.append(1e3 * worst)
            gaps.sort()
            _, evs = rec_.events_after(cursor)
            moves = [e[5] for e in evs if e[0] == "request/migrate"]
            return {"p99_ms": _percentile(gaps, 0.99), "gaps_ms": gaps,
                    "lanes_moved": len(moves),
                    "kv_bytes": sum(m.get("bytes", 0) for m in moves)}
        finally:
            faults.disarm()
            gw.drain(timeout=60)

    legs = {"migrate": [], "failover": []}
    ratios = []
    for i in range(max(1, reps)):
        pair = {}
        for leg in (("migrate", "failover") if i % 2 == 0
                    else ("failover", "migrate")):
            pair[leg] = one_leg(leg)
            legs[leg].append(pair[leg])
        ratios.append(max(1e-3, pair["migrate"]["p99_ms"])
                      / max(1e-3, pair["failover"]["p99_ms"]))
    ratios.sort()

    def med(leg):
        vals = sorted(r["p99_ms"] for r in legs[leg])
        return vals[len(vals) // 2]

    moved = sum(r["lanes_moved"] for r in legs["migrate"])
    kv_bytes = sum(r["kv_bytes"] for r in legs["migrate"])
    return {
        "metric": f"{preset}_gateway_migrate_drain_p99_resume_ms",
        "value": med("migrate"),
        "unit": "ms p99 client-observed resume gap, drain with live "
                "migration (p99_ratio_median: migrate/failover)",
        "replicas": replicas, "slots": slots, "chunk": chunk,
        "cache_len": cache_len, "streams": streams, "max_new": max_new,
        "reps": reps,
        "migrate": {"p99_resume_ms_median": med("migrate"),
                    "per_pair_p99_ms": [r["p99_ms"]
                                        for r in legs["migrate"]],
                    "lanes_moved_total": moved,
                    "kv_bytes_total": kv_bytes,
                    "kv_bytes_per_migrated_request": (
                        round(kv_bytes / moved) if moved else 0)},
        "failover": {"p99_resume_ms_median": med("failover"),
                     "per_pair_p99_ms": [r["p99_ms"]
                                         for r in legs["failover"]]},
        "p99_ratio_median": ratios[len(ratios) // 2],
        "pair_p99_ratios": ratios}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--base-url", default="",
                   help="target an externally launched gateway")
    p.add_argument("--preset", default="llama_tiny",
                   help="llama preset of the in-process engines (random "
                        "weights: a throughput and latency harness)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas behind the in-process gateway")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--replica-procs", action="store_true",
                      help="subprocess workers against in-process "
                           "replicas, and failover recovery (--replicas, "
                           "at least 2)")
    mode.add_argument("--disagg", action="store_true",
                      help="a 1-prefill + --replicas-decode TCP fleet "
                           "against a co-located one")
    mode.add_argument("--migrate-drain", action="store_true",
                      help="drain with live migration against drain by "
                           "failover (--replicas, at least 2)")
    mode.add_argument("--mixed", action="store_true",
                      help="one long prompt injected among streaming "
                           "lanes, interleaved prefill on against off")
    p.add_argument("--max-queue", type=int, default=16)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests-per-client", type=int, default=8)
    p.add_argument("--prompt-range", default="4,24",
                   help="lo,hi inclusive prompt lengths")
    p.add_argument("--new-range", default="8,32",
                   help="lo,hi inclusive max_new_tokens")
    p.add_argument("--cache-len", type=int, default=0,
                   help="0 -> config.max_positions")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="client-side HTTP timeout a request")
    p.add_argument("--no-ab", action="store_true",
                   help="skip the overlap-off leg")
    p.add_argument("--prefill-chunk", type=int, default=16,
                   help="--mixed: prefill piece size")
    p.add_argument("--long-pieces", type=int, default=6,
                   help="--mixed: pieces the long prompt spans")
    p.add_argument("--reps", type=int, default=3,
                   help="passes a leg (--mixed: best p99) or A/B pairs")
    p.add_argument("--seed", type=int, default=0)
    B.add_device_args(p)
    args = p.parse_args(argv)
    prompt_range = tuple(int(x) for x in args.prompt_range.split(","))
    new_range = tuple(int(x) for x in args.new_range.split(","))
    if args.base_url and (args.mixed or args.replica_procs or args.disagg
                          or args.migrate_drain):
        p.error("--base-url measures an external gateway; the A/B modes "
                "build their own")
    common = (args.slots, args.chunk, args.max_queue)
    loop = (args.clients, args.requests_per_client, prompt_range, new_range,
            args.cache_len or None, args.seed, args.timeout)

    def run(device):
        if args.migrate_drain:
            rec = bench_gateway_migrate_drain_ab(
                args.preset, *common, args.cache_len or None, args.seed,
                args.timeout, device=device,
                replicas=max(2, args.replicas), reps=args.reps)
        elif args.disagg:
            rec = bench_gateway_disagg_ab(
                args.preset, *common, *loop, device=device,
                decode_workers=max(2, args.replicas), reps=args.reps)
        elif args.replica_procs:
            rec = bench_gateway_procs_ab(
                args.preset, *common, *loop, device=device,
                replicas=max(2, args.replicas), reps=args.reps)
        elif args.mixed:
            rec = bench_gateway_mixed(
                args.preset, *common, args.seed, args.timeout,
                device=device, prefill_chunk=args.prefill_chunk,
                long_pieces=args.long_pieces, reps=args.reps)
        else:
            rec = bench_gateway(
                args.base_url, args.preset, *common, *loop, device=device,
                overlap_ab=not args.no_ab, replicas=max(1, args.replicas))
        rec = _null_timed(rec, device)
        rec.update(B.device_fields(device))
        return rec

    metric = (f"{args.preset}_gateway_mixed_p99_inter_token_ms"
              if args.mixed else f"{args.preset}_gateway_tokens_per_sec")
    return B.run_tool(args, metric, "generated tokens/sec", run)


if __name__ == "__main__":
    sys.exit(main())
