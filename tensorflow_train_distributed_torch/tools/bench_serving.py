"""Continuous-batching engine throughput (``serving.ServingEngine``)
against static batches through ``generate()``, and the engine's A/Bs.

    python -m tensorflow_train_distributed_torch.tools.bench_serving \\
        [--preset llama_125m] [--slots 8] [--chunk 8] [--requests 32] \\
        [--baseline] [--kv-int8] [--speculative-draft P|self] \\
        [--mixed | --shared-prefix | --trace-ab | --trace-fleet-ab |
         --spec-adaptive-ab | --fused-ab] [--device cuda|cpu]

A mixed-length request stream (numpy seed ``--seed``) through the
engine: generated tokens/s, p50 TTFT and mean inter-token time, by
default as an A/B of overlapped decode (on: the headline; off:
``no_overlap``, with each leg's ``overlap_ratio``).  ``--baseline`` also
times the same requests in arrival-order static batches of ``--slots``
through ``generate()``, each padded to its longest prompt and decoded
for its largest ``max_new``.  Every decode record carries
``decode_bytes_per_step`` and ``mbu`` (``bench_gateway.
decode_mbu_fields``).

- ``--mixed``: one long prompt injected among decoding lanes,
  interleaved prefill against ``prefill_budget=0``.
- ``--shared-prefix``: requests sharing a system prompt on the paged
  engine (radix hits) against the linear engine (``paged=False``), and a
  disjoint pair as the no-regression guard.
- ``--trace-ab``: the flight recorder (``runtime/events.py``) on against
  its ``TTD_NO_TRACE=1`` kill switch on one engine, median of per-pair
  wall ratios; ``--trace-fleet-ab``: the same over subprocess worker
  pools with clock sync and the crash-durable spool.
- ``--spec-adaptive-ab``: adaptive speculation depth against every fixed
  depth on an easy (self-drafting) and a hard (random draft) phase.
- ``--fused-ab``: refused.  The JAX A/B sets its fused paged-attention
  kernel against an XLA block-gather leg (the JAX package's
  fused-attention kill switch, which the port does not read); the
  port's paged engine always decodes through K4, and the linear engine
  (the ``--shared-prefix`` linear leg) is its only other path.

Weights are random (``server.worker.llama_params``: the port's seeded
draw).  Engines run on ``--device`` (the card by default, under the card
lock); ``--device cpu`` reports every device metric as null.  The last
line of standard output is one JSON record.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from tensorflow_train_distributed_torch.tools import bench_lm as B
from tensorflow_train_distributed_torch.tools.bench_gateway import (
    TIMED as GATEWAY_TIMED,
    _model,
    _null_timed,
    _percentile,
    decode_mbu_fields,
    mean_context,
)

FUSED_AB_REFUSAL = (
    "--fused-ab: no counterpart: the port's paged engine always decodes "
    "through its paged-attention kernel (K4), with no gather leg to set "
    "against it (the JAX package's fused-attention kill switch); the "
    "linear engine is the other path, timed by --shared-prefix's linear "
    "leg")


def _requests(n, plo, phi, glo, ghi, vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(list(rng.integers(1, vocab, int(rng.integers(plo, phi + 1)))),
             int(rng.integers(glo, ghi + 1))) for _ in range(n)]


def _engine(cfg, params, device, **kw):
    from tensorflow_train_distributed_torch.serving import ServingEngine

    return ServingEngine(cfg, params, device=device, **kw)


def _warm(eng, reqs):
    for p, m in reqs:
        eng.submit(p, m)
    eng.run()
    return eng


def _run_engine_timed(eng, reqs, device="cpu"):
    """One timed pass: submit everything, drive ``serve_step``, record
    each request's first-token and completion times.  Returns ``(wall_s,
    ttfts, itls, total_tokens_out)``; ``itls`` are each request's mean
    inter-token gap (requests of more than one generated token)."""
    ids = [eng.submit(p, m) for p, m in reqs]
    plens = {rid: len(p) for rid, (p, _) in zip(ids, reqs)}
    first, done_at, out = {}, {}, {}
    t0 = time.perf_counter()
    while eng.pending():
        done = eng.serve_step()
        now = time.perf_counter()
        for rid, toks in done.items():
            out[rid] = toks
            done_at[rid] = now
            if rid not in first and len(toks) > plens[rid]:
                first[rid] = now
        for rid, n in eng.progress().items():
            if rid not in first and n > plens[rid]:
                first[rid] = now
    B.sync(device)
    wall = time.perf_counter() - t0
    ttfts = sorted(first[r] - t0 for r in ids if r in first)
    itls = []
    for rid in ids:
        gen = len(out[rid]) - plens[rid]
        if rid in first and rid in done_at and gen > 1:
            itls.append((done_at[rid] - first[rid]) / (gen - 1))
    return wall, ttfts, itls, sum(len(v) for v in out.values())


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _mixed_pass(eng, active_prompts, active_new, long_prompt, long_new,
                tail_prompt, tail_new):
    """Fill the lanes, wait until every one decodes, inject one long
    prompt and one short behind it: the active lanes' per-token gaps
    during the long admission, both TTFTs and the prefill-stall delta."""
    ids = [eng.submit(p, active_new) for p in active_prompts]
    plens = {rid: len(p) for rid, p in zip(ids, active_prompts)}
    done: dict = {}
    while not all(rid in done or eng.progress().get(rid, 0) > plens[rid]
                  for rid in ids):
        done.update(eng.serve_step())
    stall0 = eng.prefill_stall_s()
    counts = {rid: (len(done[rid]) if rid in done
                    else eng.progress().get(rid, plens[rid]))
              for rid in ids}
    t_inject = time.perf_counter()
    long_id = eng.submit(long_prompt, long_new)
    tail_id = eng.submit(tail_prompt, tail_new)
    gaps: list = []
    ttft_long = ttft_tail = None
    last = t_inject
    while eng.pending():
        done.update(eng.serve_step())
        now = time.perf_counter()
        prog = eng.progress()
        admitting = ttft_long is None
        for rid in ids:
            n_now = (len(done[rid]) if rid in done
                     else prog.get(rid, counts[rid]))
            d = n_now - counts[rid]
            if d > 0 and admitting:
                gaps.extend([(now - last) / d] * d)
            counts[rid] = n_now
        for rid, prompt, which in ((long_id, long_prompt, "long"),
                                   (tail_id, tail_prompt, "tail")):
            n = len(done[rid]) if rid in done else prog.get(rid, 0)
            if n > len(prompt):
                if which == "long" and ttft_long is None:
                    ttft_long = now - t_inject
                elif which == "tail" and ttft_tail is None:
                    ttft_tail = now - t_inject
        last = now
    gaps.sort()
    return {"p99_inter_token_ms_active": 1e3 * _percentile(gaps, 0.99),
            "max_gap_ms_active": 1e3 * gaps[-1] if gaps else 0.0,
            "ttft_long_ms": 1e3 * ttft_long,
            "ttft_short_behind_long_ms": 1e3 * ttft_tail,
            "prefill_stall_s": eng.prefill_stall_s() - stall0}


def bench_serving_mixed(preset, slots, chunk, cache_len, seed, prefill_chunk,
                        long_pieces, *, device="cuda", reps=3):
    import numpy as np

    cfg, params = _model(preset, device)
    vocab = min(cfg.vocab_size, 30_000)
    rng = np.random.default_rng(seed)
    lanes = max(1, slots - 2)
    active_prompts = [list(rng.integers(1, vocab, 8)) for _ in range(lanes)]
    long_len = prefill_chunk * long_pieces
    long_prompt = list(rng.integers(1, vocab, long_len))
    tail_prompt = list(rng.integers(1, vocab, 8))
    active_new = chunk * (long_pieces + 6)
    cache_len = cache_len or max(long_len + 16, 8 + active_new + 8)
    if cache_len > cfg.max_positions:
        raise ValueError(f"the mixed workload needs cache_len {cache_len} "
                         f"> max_positions {cfg.max_positions}: shrink "
                         "--long-pieces/--prefill-chunk/--chunk")

    def one_mode(interleave):
        eng = _engine(cfg, params, device, slots=slots, chunk=chunk,
                      cache_len=cache_len, prefill_chunk=prefill_chunk,
                      prefill_budget=None if interleave else 0)
        args = (eng, active_prompts, active_new, long_prompt, 8,
                tail_prompt, 8)
        _mixed_pass(*args)                  # warm-up
        best = None
        for _ in range(max(1, reps)):
            rec = _mixed_pass(*args)
            if (best is None or rec["p99_inter_token_ms_active"]
                    < best["p99_inter_token_ms_active"]):
                best = rec
        return best

    on, off = one_mode(True), one_mode(False)
    rec = {"metric": f"{preset}_serving_mixed_p99_inter_token_ms",
           "value": on["p99_inter_token_ms_active"],
           "unit": "ms p99 active-lane inter-token during long admission",
           "slots": slots, "chunk": chunk, "prefill_chunk": prefill_chunk,
           "long_prompt_len": long_len, "long_pieces": long_pieces,
           "interleave": on, "no_interleave": off}
    if on["p99_inter_token_ms_active"]:
        rec["p99_improvement"] = (off["p99_inter_token_ms_active"]
                                  / on["p99_inter_token_ms_active"])
    if on["max_gap_ms_active"]:
        rec["max_gap_improvement"] = (off["max_gap_ms_active"]
                                      / on["max_gap_ms_active"])
    return rec


def bench_trace_ab(preset, slots, chunk, n_requests, prompt_range,
                   new_range, cache_len, seed, *, device="cuda", reps=3):
    """The flight recorder on against ``TTD_NO_TRACE=1`` on one engine,
    leg-order-alternating back-to-back pairs; the headline is the median
    of the per-pair wall ratios."""
    from tensorflow_train_distributed_torch.runtime import events

    cfg, params = _model(preset, device)
    reqs = _requests(n_requests, *prompt_range, *new_range,
                     min(cfg.vocab_size, 30_000), seed)
    gen_tokens = sum(m for _, m in reqs)
    eng = _warm(_engine(cfg, params, device, slots=slots, chunk=chunk,
                        cache_len=cache_len), reqs)
    had_kill = os.environ.get("TTD_NO_TRACE")
    best = {True: None, False: None}
    ratios = []
    try:
        for i in range(max(1, reps)):
            walls = {}
            for trace_on in ((True, False) if i % 2 == 0
                             else (False, True)):
                if trace_on:
                    os.environ.pop("TTD_NO_TRACE", None)
                else:
                    os.environ["TTD_NO_TRACE"] = "1"
                rec = _run_engine_timed(eng, reqs, device)
                walls[trace_on] = rec[0]
                if best[trace_on] is None or rec[0] < best[trace_on][0]:
                    best[trace_on] = rec
            ratios.append(walls[True] / walls[False])
    finally:
        if had_kill is None:
            os.environ.pop("TTD_NO_TRACE", None)
        else:
            os.environ["TTD_NO_TRACE"] = had_kill
    ratios.sort()
    return {
        "metric": f"{preset}_serving_trace_overhead_pct",
        "value": 100.0 * (_median(ratios) - 1.0),
        "unit": "% tok/s lost, flight recorder on vs TTD_NO_TRACE=1 "
                "(median of per-pair wall ratios)",
        "pair_wall_ratios": ratios,
        "trace_on_tokens_per_sec": gen_tokens / best[True][0],
        "trace_off_tokens_per_sec": gen_tokens / best[False][0],
        "trace_on_wall_s": best[True][0], "trace_off_wall_s": best[False][0],
        "events_in_ring": len(events.get_recorder()),
        "ring_capacity": events.get_recorder().capacity,
        "slots": slots, "chunk": chunk, "n_requests": n_requests,
        "gen_tokens": gen_tokens, "reps": reps}


def bench_trace_fleet_ab(preset, slots, chunk, n_requests, prompt_range,
                         new_range, cache_len, seed, *, device="cuda",
                         reps=3, replicas=2):
    """The fleet's observability over subprocess worker pools, three legs:
    ``off`` (``TTD_NO_TRACE=1``, ``TTD_NO_CLOCK_SYNC=1``, no spool),
    ``trace`` (the recorder and relay alone) and ``full`` (clock sync and
    the crash-durable spool in parent and workers).  The headline is the
    marginal cost full/trace, the median of per-round wall ratios; each
    leg is its own pool, its env set on its workers, and the parent's
    flipped around each pass."""
    import shutil
    import tempfile

    from tensorflow_train_distributed_torch.runtime import events
    from tensorflow_train_distributed_torch.server.procpool import (
        ProcPool,
        WorkerSpec,
    )
    from tensorflow_train_distributed_torch.tools.bench_gateway import (
        _model_config,
        _worker_env,
    )

    cfg = _model_config(preset)
    reqs = _requests(n_requests, *prompt_range, *new_range,
                     min(cfg.vocab_size, 30_000), seed)
    gen_tokens = sum(m for _, m in reqs)
    factory_json = dict(preset=preset, init_seed=0, slots=slots,
                        chunk=chunk, device=device)
    if cache_len:
        factory_json["cache_len"] = cache_len
    spool_dir = tempfile.mkdtemp(prefix="ttd-fleet-ab-spool-")
    worker_env = {
        "off": {"TTD_NO_TRACE": "1", "TTD_NO_CLOCK_SYNC": "1"},
        "trace": {"TTD_NO_CLOCK_SYNC": "1"},
        "full": {"TTD_TRACE_SPOOL": spool_dir},
    }
    saved = {k: os.environ.get(k) for k in
             ("TTD_NO_TRACE", "TTD_NO_CLOCK_SYNC", "TTD_TRACE_SPOOL")}
    for k in saved:          # a neutral parent: WorkerSpec.env overlays it
        os.environ.pop(k, None)

    def arm(leg):
        for k in saved:
            os.environ.pop(k, None)
        os.environ.update(worker_env[leg])
        if leg == "full":
            events.get_recorder().start_spool(spool_dir)
            events.get_recorder().flush_spool()
        else:
            events.get_recorder().stop_spool()

    def timed_pass(pool):
        t0 = time.perf_counter()
        hs = [pool.submit(p, m) for p, m in reqs]
        for h in hs:
            h.result(timeout=600)
        return time.perf_counter() - t0

    legs = ("off", "trace", "full")
    pools, best, rounds = {}, dict.fromkeys(legs), []
    try:
        for leg in legs:
            spec = WorkerSpec(factory="llama", factory_json=factory_json,
                              env=dict(_worker_env(device),
                                       **worker_env[leg]))
            pools[leg] = ProcPool(spec, replicas=replicas,
                                  max_queue=4 * n_requests,
                                  watchdog_timeout_s=300.0).start()
        for leg in legs:                    # warm-up passes
            if not pools[leg].wait_ready(timeout=600):
                raise RuntimeError("a fleet A/B pool never became ready")
            arm(leg)
            timed_pass(pools[leg])
        for i in range(max(1, reps)):
            walls = {}
            for leg in (legs if i % 2 == 0 else legs[::-1]):
                arm(leg)
                walls[leg] = w = timed_pass(pools[leg])
                if best[leg] is None or w < best[leg]:
                    best[leg] = w
            rounds.append(walls)
        sync_state = [s.get("clock") for s in pools["full"].replica_states()]
        events.get_recorder().flush_spool()
        spool_files = len([n for n in os.listdir(spool_dir)
                           if n.startswith("spool-")])
    finally:
        for pool in pools.values():
            try:
                pool.join(timeout=60)
            except Exception:   # noqa: BLE001 — teardown goes on
                pass
        events.get_recorder().stop_spool()
        shutil.rmtree(spool_dir, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {
        "metric": f"{preset}_serving_trace_fleet_overhead_pct",
        "value": 100.0 * (_median([w["full"] / w["trace"]
                                   for w in rounds]) - 1.0),
        "unit": "% tok/s lost to clock sync + spool on top of the flight "
                "recorder (full/trace, median of per-round wall ratios "
                "over a subprocess worker pool)",
        "fleet_total_overhead_pct": 100.0 * (_median(
            [w["full"] / w["off"] for w in rounds]) - 1.0),
        "trace_only_overhead_pct": 100.0 * (_median(
            [w["trace"] / w["off"] for w in rounds]) - 1.0),
        "round_wall_ratios_full_vs_trace": sorted(
            w["full"] / w["trace"] for w in rounds),
        "round_wall_ratios_full_vs_off": sorted(
            w["full"] / w["off"] for w in rounds),
        "fleet_full_tokens_per_sec": gen_tokens / best["full"],
        "fleet_off_tokens_per_sec": gen_tokens / best["off"],
        "fleet_full_wall_s": best["full"],
        "fleet_trace_wall_s": best["trace"],
        "fleet_off_wall_s": best["off"],
        "workers_synced": sum(1 for c in sync_state
                              if c and c.get("synced")),
        "spool_segments": spool_files, "replicas": replicas,
        "slots": slots, "chunk": chunk, "n_requests": n_requests,
        "gen_tokens": gen_tokens, "reps": reps}


def bench_paged_kv_ab(preset, slots, chunk, n_requests, prefix_len,
                      cache_len, seed, kv_block_size, *, device="cuda",
                      reps=3):
    """Requests sharing one system prompt on the paged engine (radix
    prefix hits) against the linear engine (``paged=False``), in
    leg-order-alternating pairs on two warm engines; then a disjoint pair
    of the same shapes, the no-regression guard.  Every pass serves fresh
    tails, so the radix credits the shared prefix alone."""
    import numpy as np

    cfg, params = _model(preset, device)
    vocab = min(cfg.vocab_size, 30_000)
    rng = np.random.default_rng(seed)
    tail, new = 8, 32
    prefix = list(rng.integers(1, vocab, prefix_len))
    cache_len = cache_len or min(cfg.max_positions,
                                 prefix_len + tail + new + 8)
    if prefix_len + tail + new > cache_len:
        raise ValueError(f"--prefix-len {prefix_len} + tail {tail} + {new} "
                         f"new exceeds cache_len {cache_len}")

    def shared_pass():
        return [(prefix + list(rng.integers(1, vocab, tail)), new)
                for _ in range(n_requests)]

    def disjoint_pass():
        return [(list(rng.integers(1, vocab, prefix_len + tail)), new)
                for _ in range(n_requests)]

    def ab(make_pass):
        eng = {paged: _warm(_engine(cfg, params, device, slots=slots,
                                    chunk=chunk, cache_len=cache_len,
                                    paged=paged,
                                    kv_block_size=kv_block_size),
                            make_pass())
               for paged in (True, False)}
        best, hits, ratios = {True: None, False: None}, {}, []
        for i in range(max(1, reps)):
            pass_reqs = make_pass()
            walls = {}
            for paged in ((True, False) if i % 2 == 0 else (False, True)):
                e = eng[paged]
                h0 = e.kv_prefix_hit_tokens()
                rec = _run_engine_timed(e, pass_reqs, device)
                walls[paged] = rec[0]
                if best[paged] is None or rec[0] < best[paged][0]:
                    best[paged] = rec
                    hits[paged] = e.kv_prefix_hit_tokens() - h0
            ratios.append(walls[False] / walls[True])
        ratios.sort()
        return best, hits, ratios

    context = prefix_len + tail + new / 2
    gen_tokens = n_requests * new

    def leg(best, hits):
        wall, ttfts, itls, _ = best
        out = {"tokens_per_sec": gen_tokens / wall, "wall_s": wall,
               "ttft_ms_p50": 1e3 * _percentile(ttfts, 0.5),
               "inter_token_ms_mean": (1e3 * sum(itls) / len(itls)
                                       if itls else 0.0),
               "prefix_hit_tokens": hits}
        out.update(decode_mbu_fields(cfg, params, slots, context,
                                     out["tokens_per_sec"], device))
        return out

    s_best, s_hits, s_ratios = ab(shared_pass)
    n_best, n_hits, n_ratios = ab(disjoint_pass)
    on, off = leg(s_best[True], s_hits[True]), leg(s_best[False],
                                                    s_hits[False])
    return {
        "metric": f"{preset}_serving_paged_kv_shared_prefix_"
                  "ttft_improvement",
        "value": (off["ttft_ms_p50"] / on["ttft_ms_p50"]
                  if on["ttft_ms_p50"] else 0.0),
        "unit": "x TTFT p50, shared-prefix paged vs linear "
                "(leg-order-alternating pairs, best-of-reps)",
        "slots": slots, "chunk": chunk, "n_requests": n_requests,
        "prefix_len": prefix_len, "tail_len": tail, "max_new": new,
        "kv_block_size": kv_block_size,
        "prompt_tokens_per_pass": n_requests * (prefix_len + tail),
        "shared": {"paged": on, "linear": off},
        "nonshared": {"paged": leg(n_best[True], n_hits[True]),
                      "linear": leg(n_best[False], n_hits[False])},
        "shared_wall_ratio_median": _median(s_ratios),
        "shared_pair_wall_ratios": s_ratios,
        "nonshared_tokens_per_sec_ratio": _median(n_ratios),
        "nonshared_pair_wall_ratios": n_ratios}


def bench_serving(preset, slots, chunk, n_requests, prompt_range, new_range,
                  cache_len, baseline, seed, *, device="cuda",
                  draft_preset="", speculative_k=0, overlap_ab=True,
                  kv_int8=False, reps=3):
    import numpy as np

    from tensorflow_train_distributed_torch.models.generate import generate
    from tensorflow_train_distributed_torch.server.worker import llama_params

    cfg, params = _model(preset, device)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    reqs = _requests(n_requests, *prompt_range, *new_range,
                     min(cfg.vocab_size, 30_000), seed)
    gen_tokens = sum(m for _, m in reqs)
    draft_cfg = draft_params = None
    if draft_preset == "self":
        # The acceptance ceiling: the target drafts for itself.
        draft_cfg, draft_params = cfg, params
    elif draft_preset:
        # A random draft (seed 1): the acceptance floor.
        draft_cfg, draft_params = llama_params(draft_preset, 1, device)
        if kv_int8:
            draft_cfg = dataclasses.replace(draft_cfg, kv_cache_int8=True)

    def warm(overlap):
        eng = _engine(cfg, params, device, slots=slots, chunk=chunk,
                      cache_len=cache_len, draft_config=draft_cfg,
                      draft_params=draft_params,
                      speculative_k=speculative_k if draft_cfg else 0,
                      overlap=overlap)
        return _warm(eng, reqs)

    def one_pass(e):
        for k in e.overlap_stats:       # the best pass's window alone
            e.overlap_stats[k] = type(e.overlap_stats[k])(0)
        rec = _run_engine_timed(e, reqs, device)
        return rec + (dict(e.overlap_stats), e.overlap_ratio())

    def summarize(best):
        wall, ttfts, itls, total, stats, ratio = best
        return {"tokens_per_sec": gen_tokens / wall, "wall_s": wall,
                "ttft_ms_p50": 1e3 * _percentile(ttfts, 0.5),
                "inter_token_ms_mean": (1e3 * sum(itls) / len(itls)
                                        if itls else 0.0),
                "overlap_ratio": ratio,
                "overlapped_harvests": stats["overlapped_harvests"]}, total

    # Best of ``reps``, the legs interleaved (on, off, on, off, ...).
    eng = warm(overlap=True)
    eng_off = warm(overlap=False) if overlap_ab else None
    best_on = best_off = None
    for _ in range(max(1, reps)):
        rec = one_pass(eng)
        if best_on is None or rec[0] < best_on[0]:
            best_on = rec
        if eng_off is not None:
            rec = one_pass(eng_off)
            if best_off is None or rec[0] < best_off[0]:
                best_off = rec
    on_rec, total_out = summarize(best_on)
    context = mean_context(reqs)
    name = (f"{preset}_serving_engine_spec_{draft_preset}" if draft_preset
            else f"{preset}_serving_engine")
    if kv_int8:
        name += "_kv8"
    rec = {"metric": f"{name}_tokens_per_sec",
           "value": on_rec["tokens_per_sec"],
           "unit": "generated tokens/sec", **on_rec,
           "slots": slots, "chunk": chunk, "n_requests": n_requests,
           "gen_tokens": gen_tokens, "total_tokens_out": total_out,
           "paged": eng.paged, "mean_context": context}
    del rec["tokens_per_sec"]
    rec.update(decode_mbu_fields(cfg, params, slots, context, rec["value"],
                                 device))
    if kv_int8:
        rec["kv_cache"] = "int8"
        rec["kv_pool_bytes"] = eng.kv_pool_bytes()
    if overlap_ab:
        off_rec, _ = summarize(best_off)
        off_rec.update(decode_mbu_fields(cfg, params, slots, context,
                                         off_rec["tokens_per_sec"], device))
        rec["no_overlap"] = off_rec
        if off_rec["wall_s"] and on_rec["wall_s"]:
            rec["overlap_speedup"] = off_rec["wall_s"] / on_rec["wall_s"]
    if draft_preset:
        rec["draft_preset"] = draft_preset
        rec["speculative_k"] = speculative_k
        s = eng.spec_stats
        if s["slot_rounds"] and speculative_k:
            rec["acceptance_rate"] = (s["drafted_accepted"]
                                      / (s["slot_rounds"] * speculative_k))
    if baseline:
        def run_static():
            done = 0
            for i in range(0, len(reqs), slots):
                grp = reqs[i:i + slots]
                plen = max(len(p) for p, _ in grp)
                mnew = max(m for _, m in grp)
                if mnew == 0:
                    continue
                batch = np.zeros((len(grp), plen), np.int32)
                for j, (p, _) in enumerate(grp):
                    # Left-padded: the pad zeros count as context, so the
                    # outputs are timing-equivalent only.
                    batch[j, plen - len(p):] = p
                out = generate(cfg, params, batch, mnew, device=device)
                done += int(out.shape[1]) * len(grp)
            B.sync(device)
            return done

        run_static()                               # warm-up
        t0 = time.perf_counter()
        run_static()
        dt_static = time.perf_counter() - t0
        rec["static_batch_wall_s"] = dt_static
        rec["static_batch_tokens_per_sec"] = gen_tokens / dt_static
        rec["engine_speedup"] = dt_static / on_rec["wall_s"]
    return rec


def bench_spec_adaptive_ab(preset, draft_preset, slots, chunk, n_requests,
                           prompt_range, new_range, cache_len, seed, *,
                           device="cuda", depths=(0, 2, 4, 8), reps=3,
                           wide_d_model=0):
    """Adaptive speculation depth (``spec_depths`` and the depth
    controller) against every fixed depth of ``depths`` on a mixed
    workload: an easy phase (the draft is the target's first quarter
    sharing its weights: the target is the preset deepened 4x with its
    upper blocks' output projections zeroed, exact identities) and a
    hard one (a random draft).  The headline is the median over rounds
    of adaptive / best-fixed wall."""
    import torch

    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS

    draft_cfg = LLAMA_PRESETS[draft_preset or preset]
    if wide_d_model:
        # The CPU leg's sizing: weights past the last-level cache, so a
        # multi-position verify costs about one step.
        draft_cfg = dataclasses.replace(
            draft_cfg, d_model=wide_d_model, ffn_size=wide_d_model * 11 // 4,
            num_heads=8, num_kv_heads=4)
    cfg = dataclasses.replace(draft_cfg, num_layers=4 * draft_cfg.num_layers)
    gen = torch.Generator(device=device).manual_seed(0)
    params = convert.init_params(cfg, gen, device=device)
    for name, w in params.items():
        parts = name.split(".")
        if (parts[0] == "layers" and int(parts[1]) >= draft_cfg.num_layers
                and parts[-2] in ("out", "wo")):
            w.zero_()
    easy_draft = {k: v for k, v in params.items()
                  if not k.startswith("layers.")
                  or int(k.split(".")[1]) < draft_cfg.num_layers}
    hard_draft = convert.init_params(
        draft_cfg, torch.Generator(device=device).manual_seed(7),
        device=device)
    vocab = min(cfg.vocab_size, 30_000)
    easy_reqs = _requests(n_requests, *prompt_range, *new_range, vocab, seed)
    hard_reqs = _requests(n_requests, *prompt_range, *new_range, vocab,
                          seed + 1)
    gen_tokens = sum(m for _, m in easy_reqs + hard_reqs)
    deepest = max(depths)

    def make(policy, regime):
        d_params = easy_draft if regime == "easy" else hard_draft
        d_cfg = draft_cfg
        if policy == "adaptive":
            kw = dict(speculative_k=deepest, spec_depths=depths)
        elif policy == 0:
            d_cfg = d_params = None               # plain decode
            kw = dict(speculative_k=0)
        else:
            kw = dict(speculative_k=policy)
        eng = _engine(cfg, params, device, slots=slots, chunk=chunk,
                      cache_len=cache_len, draft_config=d_cfg,
                      draft_params=d_params, **kw)
        return _warm(eng, easy_reqs if regime == "easy" else hard_reqs)

    policies = ["adaptive"] + [int(k) for k in depths]
    engines = {p: {r: make(p, r) for r in ("easy", "hard")}
               for p in policies}
    walls = {p: [] for p in policies}
    for i in range(max(1, reps)):
        for pol in (policies if i % 2 == 0 else policies[::-1]):
            walls[pol].append(
                _run_engine_timed(engines[pol]["easy"], easy_reqs,
                                  device)[0]
                + _run_engine_timed(engines[pol]["hard"], hard_reqs,
                                    device)[0])
    fixed = {k: _median(walls[k]) for k in depths}
    best_k, worst_k = min(fixed, key=fixed.get), max(fixed, key=fixed.get)
    vs_best = sorted(a / b for a, b in zip(walls["adaptive"],
                                           walls[best_k]))
    vs_worst = sorted(b / a for a, b in zip(walls["adaptive"],
                                            walls[worst_k]))
    tele = {r: engines["adaptive"][r].spec_telemetry()
            for r in ("easy", "hard")}
    return {
        "metric": f"{preset}_serving_spec_adaptive_wall_ratio",
        "value": _median(vs_best),
        "unit": "x wall, adaptive depth vs best fixed depth on the mixed "
                "easy/hard workload (median of per-round wall ratios)",
        "vs_worst_fixed_speedup": _median(vs_worst),
        "best_fixed_k": best_k, "worst_fixed_k": worst_k,
        "depths": list(depths), "pair_wall_ratios_vs_best": vs_best,
        "pair_wall_ratios_vs_worst": vs_worst,
        "per_policy": {str(p): {"wall_s_median": _median(walls[p]),
                                "tokens_per_sec": gen_tokens
                                / _median(walls[p])} for p in policies},
        "adaptive_depth_rounds": {
            r: {str(d): v["rounds"]
                for d, v in tele[r].get("per_depth", {}).items()}
            for r in tele},
        "adaptive_switches": {r: tele[r].get("switches", 0) for r in tele},
        "slots": slots, "chunk": chunk, "n_requests_per_phase": n_requests,
        "gen_tokens": gen_tokens, "reps": reps, "wide_d_model": wide_d_model,
        "target_layers": cfg.num_layers, "draft_layers": draft_cfg.num_layers}


# The timed fields of the serving records, null on the CPU.
TIMED = GATEWAY_TIMED + ("ttft_ms_p50", "trace_on_tokens_per_sec",
          "trace_off_tokens_per_sec", "trace_on_wall_s", "trace_off_wall_s",
          "fleet_total_overhead_pct", "trace_only_overhead_pct",
          "round_wall_ratios_full_vs_trace", "round_wall_ratios_full_vs_off",
          "fleet_full_tokens_per_sec", "fleet_off_tokens_per_sec",
          "fleet_full_wall_s", "fleet_trace_wall_s", "fleet_off_wall_s",
          "shared_wall_ratio_median", "shared_pair_wall_ratios",
          "nonshared_tokens_per_sec_ratio", "nonshared_pair_wall_ratios",
          "static_batch_wall_s", "static_batch_tokens_per_sec",
          "engine_speedup", "max_gap_improvement",
          "vs_worst_fixed_speedup", "pair_wall_ratios_vs_best",
          "pair_wall_ratios_vs_worst", "wall_s_median")


# The metric and unit of each mode's failure record.
_METRICS = {
    "mixed": ("serving_mixed_p99_inter_token_ms",
              "ms p99 active-lane inter-token during long admission"),
    "shared_prefix": ("serving_paged_kv_shared_prefix_ttft_improvement",
                      "x TTFT p50, shared-prefix paged vs linear"),
    "trace_ab": ("serving_trace_overhead_pct",
                 "% tok/s lost, flight recorder on vs TTD_NO_TRACE=1"),
    "trace_fleet_ab": ("serving_trace_fleet_overhead_pct",
                       "% tok/s lost to clock sync + spool"),
    "spec_adaptive_ab": ("serving_spec_adaptive_wall_ratio",
                         "x wall, adaptive depth vs best fixed depth"),
    "fused_ab": ("serving_fused_attn_wall_ratio", "refused")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="llama_125m")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--prompt-range", default="16,120",
                   help="lo,hi inclusive prompt lengths")
    p.add_argument("--new-range", default="16,128",
                   help="lo,hi inclusive max_new_tokens")
    p.add_argument("--cache-len", type=int, default=0,
                   help="0 -> config.max_positions")
    p.add_argument("--baseline", action="store_true",
                   help="also time static batches through generate()")
    p.add_argument("--speculative-draft", default="",
                   help="a llama preset as a random draft (the acceptance "
                        "floor), or 'self' (the ceiling)")
    p.add_argument("--speculative-k", type=int, default=4)
    p.add_argument("--no-ab", action="store_true",
                   help="skip the overlap-off leg")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--mixed", action="store_true",
                      help="a long prompt among decoding lanes, "
                           "interleaved prefill on against off")
    mode.add_argument("--shared-prefix", action="store_true",
                      help="a shared system prompt, paged (radix) against "
                           "linear")
    mode.add_argument("--trace-ab", action="store_true",
                      help="the flight recorder on against TTD_NO_TRACE=1")
    mode.add_argument("--trace-fleet-ab", action="store_true",
                      help="clock sync and the spool over subprocess "
                           "worker pools")
    mode.add_argument("--spec-adaptive-ab", action="store_true",
                      help="adaptive speculation depth against each fixed "
                           "depth of --spec-depths")
    mode.add_argument("--fused-ab", action="store_true",
                      help="refused (the module docstring)")
    p.add_argument("--prefix-len", type=int, default=96,
                   help="--shared-prefix: the shared prompt's length")
    p.add_argument("--kv-block-size", type=int, default=16,
                   help="--shared-prefix: the paged KV block size")
    p.add_argument("--sweep-slots", default="",
                   help="--fused-ab's sweep (refused with it)")
    p.add_argument("--kv-int8", action="store_true",
                   help="the int8 KV cache (metric suffix _kv8)")
    p.add_argument("--fleet-replicas", type=int, default=2,
                   help="--trace-fleet-ab: workers a pool leg")
    p.add_argument("--spec-depths", default="0,2,4,8",
                   help="--spec-adaptive-ab: the depth buckets")
    p.add_argument("--spec-d-model", type=int, default=0,
                   help="--spec-adaptive-ab: widen the preset to this "
                        "d_model (0 = as it is)")
    p.add_argument("--prefill-chunk", type=int, default=16,
                   help="--mixed: prefill piece size")
    p.add_argument("--long-pieces", type=int, default=6,
                   help="--mixed: pieces the long prompt spans")
    p.add_argument("--reps", type=int, default=3,
                   help="timed passes a leg (best wall) or A/B pairs")
    p.add_argument("--seed", type=int, default=0)
    B.add_device_args(p)
    args = p.parse_args(argv)
    pr = tuple(int(x) for x in args.prompt_range.split(","))
    nr = tuple(int(x) for x in args.new_range.split(","))
    cache_len = args.cache_len or None
    common = (args.preset, args.slots, args.chunk)

    def run(device):
        if args.fused_ab or args.sweep_slots:
            raise B.Refused(FUSED_AB_REFUSAL)
        if args.mixed:
            rec = bench_serving_mixed(*common, cache_len, args.seed,
                                      args.prefill_chunk, args.long_pieces,
                                      device=device, reps=args.reps)
        elif args.shared_prefix:
            rec = bench_paged_kv_ab(*common, args.requests, args.prefix_len,
                                    cache_len, args.seed,
                                    args.kv_block_size, device=device,
                                    reps=args.reps)
        elif args.trace_ab:
            rec = bench_trace_ab(*common, args.requests, pr, nr, cache_len,
                                 args.seed, device=device, reps=args.reps)
        elif args.trace_fleet_ab:
            rec = bench_trace_fleet_ab(*common, args.requests, pr, nr,
                                       cache_len, args.seed, device=device,
                                       reps=args.reps,
                                       replicas=args.fleet_replicas)
        elif args.spec_adaptive_ab:
            draft = (args.speculative_draft
                     if args.speculative_draft != "self" else "")
            rec = bench_spec_adaptive_ab(
                args.preset, draft, args.slots, args.chunk, args.requests,
                pr, nr, cache_len, args.seed, device=device,
                depths=tuple(int(x) for x in args.spec_depths.split(",")),
                reps=args.reps, wide_d_model=args.spec_d_model)
        else:
            rec = bench_serving(*common, args.requests, pr, nr, cache_len,
                                args.baseline, args.seed, device=device,
                                draft_preset=args.speculative_draft,
                                speculative_k=args.speculative_k,
                                overlap_ab=not args.no_ab,
                                kv_int8=args.kv_int8, reps=args.reps)
        rec = _null_timed(rec, device, TIMED)
        rec.update(B.device_fields(device))
        return rec

    metric, unit = next((m for mode, m in _METRICS.items()
                         if getattr(args, mode)),
                        ("serving_engine_tokens_per_sec",
                         "generated tokens/sec"))
    return B.run_tool(args, f"{args.preset}_{metric}", unit, run)


if __name__ == "__main__":
    sys.exit(main())
