"""Stdlib Prometheus metrics for the serving gateway.

The scrape surface of ``server.gateway`` (``GET /metrics``): counters,
gauges, and cumulative-bucket histograms rendered in the Prometheus
text exposition format (0.0.4) — no client library in this image, and
the needed subset is small enough that baking one in would be pure
dependency weight.  Everything is threading.Lock-guarded: the HTTP
frontend observes from handler threads while the engine driver observes
from its own loop, and a scrape may land mid-update.

Conventions (the names README documents):
- counters end in ``_total``;
- histograms expose ``_bucket{le=...}`` (cumulative, ``+Inf`` last),
  ``_sum`` and ``_count`` — quantiles are the scraper's job (PromQL
  ``histogram_quantile``), keeping the server side O(buckets);
- gauges may be backed by a callable, sampled AT SCRAPE TIME, so queue
  depth / slot occupancy never need a writer to stay fresh.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Optional, Sequence

from tensorflow_train_distributed_torch.runtime.lint import (
    compilecheck,
    memcheck,
)
from tensorflow_train_distributed_torch.runtime.lint.registry import (
    concurrency_guarded,
)

# Prometheus's default latency ladder, extended to 60 s: a serving
# deadline default lives in seconds-to-a-minute territory and a bucket
# past it keeps the histogram's tail observable.
LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Inter-token latency lives well below the request ladder (sub-ms on a
# warm accelerator): extend downward so the histogram resolves it.
INTER_TOKEN_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                       0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare (no exponent)."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _labels(pairs: dict) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(pairs.items()))
    return "{" + inner + "}"


@concurrency_guarded
class Counter:
    """Monotonic counter, optionally split by ONE label (``status``)."""

    # inc() lands from handler threads, the driver loop, and pool
    # pumps while scrapes render — every access locks.
    _GUARDED_BY = {"_values": ("_lock",)}

    def __init__(self, name: str, help_: str, label: Optional[str] = None):
        self.name, self.help, self.label = name, help_, label
        self._lock = threading.Lock()
        self._values: dict = {}          # label value (or None) -> float

    def inc(self, n: float = 1, label_value: Optional[str] = None) -> None:
        if n < 0:
            raise ValueError(f"counters only go up, got {n}")
        if (label_value is None) != (self.label is None):
            raise ValueError(f"{self.name}: label mismatch "
                             f"(declared {self.label!r})")
        with self._lock:
            self._values[label_value] = self._values.get(label_value, 0) + n

    def value(self, label_value: Optional[str] = None) -> float:
        with self._lock:
            return self._values.get(label_value, 0)

    def render(self) -> list:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items(),
                           key=lambda kv: kv[0] or "")
            if not items:
                items = [(None, 0)]
            for lv, v in items:
                lab = _labels({self.label: lv} if lv is not None else {})
                lines.append(f"{self.name}{lab} {_fmt(v)}")
        return lines


class FnCounter(Counter):
    """Counter whose value lives elsewhere (an engine's cumulative
    stat), sampled at scrape time like a callable-backed gauge but
    rendered with counter TYPE (and held to counter naming) — for
    monotonic engine-side totals the driver never observes directly."""

    def __init__(self, name: str, help_: str,
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help_)
        self._fn = fn

    def inc(self, n: float = 1, label_value: Optional[str] = None):
        raise TypeError(f"{self.name} is sampled from its source "
                        f"callable; nothing to inc")

    def value(self, label_value: Optional[str] = None) -> float:
        return 0.0 if self._fn is None else float(self._fn())

    def render(self) -> list:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} counter",
                f"{self.name} {_fmt(self.value())}"]


@concurrency_guarded
class Gauge:
    """Set-anytime value, or a callable sampled at scrape time."""

    _GUARDED_BY = {"_value": ("_lock",)}

    def __init__(self, name: str, help_: str,
                 fn: Optional[Callable[[], float]] = None):
        self.name, self.help, self._fn = name, help_, fn
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value

    def render(self) -> list:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {_fmt(self.value())}"]


class LabeledGauge:
    """Callable-backed gauge split by ONE label: the callable returns
    ``{label_value: value}`` sampled at scrape time (the per-worker
    rss gauge — workers spawn and drain under the elastic pool, so
    the label set is live, not declared).  Renders nothing but
    HELP/TYPE when the source has no series (e.g. in-process replicas,
    which share the gateway's own rss and truthfully report none)."""

    def __init__(self, name: str, help_: str, label: str,
                 fn: Optional[Callable[[], dict]] = None):
        self.name, self.help, self.label = name, help_, label
        self._fn = fn

    def values(self) -> dict:
        return dict(self._fn() or {}) if self._fn is not None else {}

    def value(self, label_value) -> float:
        return float(self.values().get(str(label_value), 0.0))

    def render(self) -> list:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        for lv, v in sorted(self.values().items()):
            lines.append(
                f"{self.name}{_labels({self.label: lv})} {_fmt(v)}")
        return lines


@concurrency_guarded
class Histogram:
    """Cumulative-bucket histogram (observe in seconds)."""

    # The driver observes per committed chunk while scrapes render
    # cumulative buckets: both sides lock (monotonic-bucket hammer
    # test pins the visible invariant).
    _GUARDED_BY = {"_counts": ("_lock",), "_sum": ("_lock",)}

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(
                tuple(buckets)):
            raise ValueError(f"{name}: buckets must be sorted and unique")
        self.name, self.help = name, help_
        self._uppers = tuple(buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self._uppers) + 1)   # last = +Inf
        self._sum = 0.0

    def observe(self, v: float) -> None:
        # bisect_left: first upper with v <= upper (== len(_uppers) →
        # the +Inf bucket).  O(log buckets) — this sits on the driver's
        # per-chunk commit path (inter_token observes every chunk).
        i = bisect.bisect_left(self._uppers, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    def render(self) -> list:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            acc = 0
            for u, c in zip(self._uppers + (math.inf,), self._counts):
                acc += c
                lines.append(
                    f'{self.name}_bucket{{le="{_fmt(u)}"}} {acc}')
            lines.append(f"{self.name}_sum {_fmt(self._sum)}")
            lines.append(f"{self.name}_count {acc}")
        return lines


class Registry:
    """Ordered metric collection → one scrape body."""

    def __init__(self):
        self._metrics: list = []

    def counter(self, name, help_, label=None) -> Counter:
        return self._add(Counter(name, help_, label))

    def fn_counter(self, name, help_, fn=None) -> FnCounter:
        return self._add(FnCounter(name, help_, fn))

    def gauge(self, name, help_, fn=None) -> Gauge:
        return self._add(Gauge(name, help_, fn))

    def labeled_gauge(self, name, help_, label, fn=None) -> LabeledGauge:
        return self._add(LabeledGauge(name, help_, label, fn))

    def histogram(self, name, help_, buckets=LATENCY_BUCKETS) -> Histogram:
        return self._add(Histogram(name, help_, buckets))

    def _add(self, m):
        if any(x.name == m.name for x in self._metrics):
            raise ValueError(f"duplicate metric {m.name}")
        self._metrics.append(m)
        return m

    def render(self) -> str:
        lines = []
        for m in self._metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


class GatewayMetrics:
    """The gateway's full scrape surface, wired in one place so the
    driver and the HTTP frontend share instances (and README's metric
    list has a single source of truth).

    ``ttd_gateway_requests_total{status=...}`` statuses: ``ok``
    (served), ``shed`` (admission queue full → 429), ``invalid``
    (rejected body/ids → 400), ``expired`` (deadline freed the slot →
    504), ``error`` (internal failure → 500).
    """

    def __init__(self, queue_depth_fn: Callable[[], int],
                 slots_in_use_fn: Callable[[], int], slots_total: int,
                 driver_alive_fn: Optional[Callable[[], bool]] = None,
                 replicas_alive_fn: Optional[Callable[[], int]] = None,
                 overlap_ratio_fn: Optional[Callable[[], float]] = None,
                 prefill_stall_fn: Optional[Callable[[], float]] = None,
                 kv_blocks_in_use_fn: Optional[Callable[[], int]] = None,
                 kv_blocks_total_fn: Optional[Callable[[], int]] = None,
                 kv_prefix_hit_tokens_fn: Optional[
                     Callable[[], int]] = None,
                 kv_evictions_fn: Optional[Callable[[], int]] = None,
                 kv_pool_bytes_fn: Optional[Callable[[], int]] = None,
                 slots_total_fn: Optional[Callable[[], int]] = None,
                 replica_rss_fn: Optional[Callable[[], dict]] = None,
                 hbm_bytes_fn: Optional[Callable[[], dict]] = None,
                 workers_by_role_fn: Optional[
                     Callable[[], dict]] = None,
                 spec_depth_fn: Optional[Callable[[], float]] = None,
                 spec_accepted_fn: Optional[Callable[[], int]] = None,
                 spec_drafted_fn: Optional[Callable[[], int]] = None,
                 hbm_autosized_fn: Optional[
                     Callable[[], int]] = None,
                 mfu_fn: Optional[Callable[[], dict]] = None,
                 mbu_fn: Optional[Callable[[], dict]] = None):
        self.registry = Registry()
        r = self.registry
        self.requests = r.counter(
            "ttd_gateway_requests_total",
            "Requests by terminal status (ok|shed|invalid|expired|error).",
            label="status")
        self.tokens = r.counter(
            "ttd_gateway_tokens_generated_total",
            "Generated (non-prompt) tokens committed to responses.")
        self.queue_depth = r.gauge(
            "ttd_gateway_queue_depth",
            "Admitted requests waiting for a slot.", fn=queue_depth_fn)
        self.slots_in_use = r.gauge(
            "ttd_gateway_slots_in_use",
            "Engine slots currently decoding.", fn=slots_in_use_fn)
        # Callable-backed under the elastic proc pool (capacity is
        # live: workers spawn and drain), a set-once constant
        # otherwise.
        self.slots_total = r.gauge(
            "ttd_gateway_slots_total", "Engine slot capacity.",
            fn=slots_total_fn)
        if slots_total_fn is None:
            self.slots_total.set(slots_total)
        # Sampled at scrape time like the occupancy gauges: 1 while the
        # engine-driver thread can make progress, 0 once it died or
        # drained — the alert line for "listener up, engine dead".
        self.driver_alive = r.gauge(
            "ttd_gateway_driver_alive",
            "1 if the engine driver loop is running, else 0.",
            fn=(None if driver_alive_fn is None
                else (lambda: 1.0 if driver_alive_fn() else 0.0)))
        if driver_alive_fn is None:
            self.driver_alive.set(1.0)
        # Multi-replica serving: how many engine replicas can take work
        # (a single-engine gateway truthfully scrapes its driver's
        # aliveness — 1 or 0), and the pool's robustness counters: how
        # often a dying replica's requests were re-admitted on a
        # survivor, and how often a transient placement refusal was
        # retried with backoff instead of shed.
        self.replicas_alive = r.gauge(
            "ttd_gateway_replicas_alive",
            "Engine replicas currently able to accept work.",
            fn=(replicas_alive_fn if replicas_alive_fn is not None
                else (None if driver_alive_fn is None
                      else (lambda: 1 if driver_alive_fn() else 0))))
        if replicas_alive_fn is None and driver_alive_fn is None:
            self.replicas_alive.set(1)
        self.failovers = r.counter(
            "ttd_gateway_failovers_total",
            "Requests re-admitted on a survivor replica after their "
            "replica died mid-flight.")
        self.retries = r.counter(
            "ttd_gateway_retries_total",
            "Placement retries after transient admission refusals "
            "(pool pressure backoff, not client-visible sheds).")
        # Out-of-process replicas (server.procpool): how many dead
        # workers the elastic pool respawned (a climbing counter is a
        # crash-looping engine; the restart budget bounds it), and
        # each live worker's resident set from its stats frames — the
        # per-replica memory signal an in-process pool cannot have
        # (all replicas share one rss there, and this gauge truthfully
        # renders no series).
        self.replica_restarts = r.counter(
            "ttd_gateway_replica_restarts_total",
            "Dead subprocess workers respawned by the elastic pool's "
            "scaler (under its restart budget).")
        self.replica_rss = r.labeled_gauge(
            "ttd_gateway_replica_rss_bytes",
            "Resident-set bytes per subprocess replica worker, from "
            "its latest stats frame (no series for in-process "
            "replicas).", "replica", fn=replica_rss_fn)
        # Disaggregated serving (server.netpool + role-split routing):
        # fleet composition by HELLO-declared role (every worker reads
        # "both" under TTD_NO_DISAGG=1 or pre-role deployments), and
        # the prefill→decode KV handoff's volume/latency — bytes of
        # serialized int8 rows+scales shipped between workers, and the
        # export→install wall time per successful handoff.  All three
        # render trivially (no series / zeros) for in-process and
        # co-located pools.
        self.workers_alive = r.labeled_gauge(
            "ttd_gateway_workers_alive",
            "Usable worker replicas per disaggregated-serving role "
            "(prefill|decode|both), from their HELLO frames.",
            "role", fn=workers_by_role_fn)
        self.handoff_bytes = r.counter(
            "ttd_gateway_handoff_bytes_total",
            "Serialized KV bytes shipped prefill→decode in successful "
            "handoffs (int8 pool rows + scales).")
        self.handoff_seconds = r.histogram(
            "ttd_gateway_handoff_seconds",
            "Prefill-export-to-decode-install wall time per "
            "successful KV handoff.")
        # Live mid-stream migration (drain/rebalance/defragment): how
        # often lanes move between replicas without re-prefill, how
        # long each move takes end to end (export → install →
        # re-placed), and the serialized KV volume it ships.  All
        # three stay flat under TTD_NO_MIGRATION=1 and for
        # single-replica pools (nothing to move to).
        self.migrations = r.counter(
            "ttd_gateway_migrations_total",
            "Active lanes live-migrated between replicas (drain "
            "evacuation, explicit migrate(), defragmentation) "
            "without re-prefilling.")
        self.migration_seconds = r.histogram(
            "ttd_gateway_migration_seconds",
            "Source-export-to-target-install wall time per "
            "successful lane migration.")
        self.migrated_kv_bytes = r.counter(
            "ttd_gateway_migrated_kv_bytes_total",
            "Serialized KV bytes (int8 pool rows + scales) shipped in "
            "successful lane migrations.")
        # Fraction of the engine's host harvest/refill time hidden
        # under device compute by async decode pipelining — the
        # driver-visible proof the overlap path engages (0 under the
        # TTD_NO_OVERLAP kill switch, or for engines without the
        # lookahead, e.g. test stubs).
        self.engine_overlap_ratio = r.gauge(
            "ttd_engine_overlap_ratio",
            "Host harvest time overlapped with device decode, as a "
            "fraction of total harvest time (0 = synchronous path).",
            fn=overlap_ratio_fn)
        # Cumulative head-of-line admission time: seconds decode lanes
        # spent blocked behind a new prompt's prefill.  Grows with
        # every long admission under atomic admission
        # (prefill_budget=0 / TTD_NO_INTERLEAVE=1); collapses to ~0
        # with the engine's interleaved prefill scheduler on — the
        # driver-visible proof the scheduler engages.
        self.engine_prefill_stall = r.gauge(
            "ttd_engine_prefill_stall_seconds",
            "Cumulative seconds decode lanes spent stalled behind "
            "admission prefill (~0 with interleaved prefill on).",
            fn=prefill_stall_fn)
        # Paged-KV cache economics (serving.ServingEngine paged mode;
        # all four scrape 0 for linear-cache engines and test stubs —
        # the truthful constant).  Occupancy pair: admission is keyed
        # on FREE BLOCKS, so in_use/total is the real capacity gauge
        # where slots_in_use no longer binds; the counters are the
        # prefix-cache win (prompt tokens whose prefill was skipped via
        # radix hits) and its cost under memory pressure (blocks
        # LRU-evicted from the retired-prefix cache).
        self.kv_blocks_in_use = r.gauge(
            "ttd_engine_kv_blocks_in_use",
            "Paged-KV physical blocks referenced by live lanes or the "
            "radix prefix cache (0 = linear cache).",
            fn=kv_blocks_in_use_fn)
        self.kv_blocks_total = r.gauge(
            "ttd_engine_kv_blocks_total",
            "Paged-KV pool capacity in blocks (0 = linear cache).",
            fn=kv_blocks_total_fn)
        self.kv_prefix_hit_tokens = r.fn_counter(
            "ttd_engine_prefix_hit_tokens_total",
            "Prompt tokens whose prefill was skipped via radix "
            "prefix-cache hits.",
            fn=kv_prefix_hit_tokens_fn)
        self.kv_evictions = r.fn_counter(
            "ttd_engine_kv_evictions_total",
            "Paged-KV blocks LRU-evicted from the retired-prefix "
            "cache under allocation pressure.",
            fn=kv_evictions_fn)
        # Device bytes the paged pools pin (int8 scale pools included,
        # target + draft; constant per engine — the pool never grows).
        # The --kv-pool-blocks oversizing lever budgets against this:
        # int8 halves it, and the freed HBM buys more blocks/slots.
        self.kv_pool_bytes = r.gauge(
            "ttd_engine_kv_pool_bytes",
            "Device bytes held by the paged KV block pools "
            "(0 = linear cache).",
            fn=kv_pool_bytes_fn)
        # Acceptance-adaptive speculation (the telemetry loop closed):
        # the draft depth the NEXT round dispatches at — constant for
        # fixed-k engines, moving with measured acceptance under
        # --spec-depth adaptive (a fleet mean over replicas) — and the
        # accepted/drafted token pair whose ratio is the fleet
        # acceptance rate the controller steers by.  All three scrape
        # 0 for engines without a draft model.
        self.spec_depth = r.gauge(
            "ttd_engine_spec_depth",
            "Draft depth the next speculative round runs at (fleet "
            "mean; 0 = plain decode).",
            fn=spec_depth_fn)
        self.spec_accepted_tokens = r.fn_counter(
            "ttd_engine_spec_accepted_tokens_total",
            "Draft tokens accepted by target verification across "
            "speculative rounds.",
            fn=spec_accepted_fn)
        self.spec_drafted_tokens = r.fn_counter(
            "ttd_engine_spec_drafted_tokens_total",
            "Draft tokens proposed across speculative rounds (the "
            "acceptance-rate denominator).",
            fn=spec_drafted_fn)
        # Device-HBM autosizing: the byte budget the construction-time
        # solve installed from the device's reported memory (0 when
        # the engine was hand-sized or TTD_NO_HBM_AUTOSIZE=1 killed
        # the solve) — compare against ttd_engine_hbm_bytes to see
        # headroom actually held.
        self.hbm_autosized_bytes = r.gauge(
            "ttd_engine_hbm_autosized_bytes",
            "HBM budget installed by kv_pool_blocks='auto' at engine "
            "construction (0 = hand-sized).",
            fn=hbm_autosized_fn)
        # Memory discipline (memcheck, the third lint vertical): live
        # bytes per DECLARED pool — the @memory_budget ledger sampled
        # at scrape time, labeled by pool name (kv_pool, draft_pool,
        # prefill_cache, prefix_cache, trainer_state; under
        # --replica-procs each subprocess worker's pools render as
        # "<replica>/<pool>", so fleet memory is visible per worker).
        # No series unless TTD_MEMCHECK=1 arms the sanitizer — the
        # truthful constant, like ttd_engine_compiles_total.
        self.hbm_bytes = r.labeled_gauge(
            "ttd_engine_hbm_bytes",
            "Live device bytes per declared @memory_budget pool "
            "(no series unless TTD_MEMCHECK=1).", "pool",
            fn=(hbm_bytes_fn if hbm_bytes_fn is not None
                else memcheck.live_by_pool))
        # Compile discipline: in the JAX package, XLA compilations at
        # @compile_site-instrumented jit sites, process-wide (flat after
        # warmup is healthy; a climbing counter is a recompile storm).
        # The port's eager engine compiles nothing per signature, so
        # the counter scrapes 0 (runtime/lint/compilecheck.py); name,
        # HELP and TYPE stay JAX's.
        self.compiles = r.fn_counter(
            "ttd_engine_compiles_total",
            "XLA compilations observed at instrumented jit sites "
            "(0 unless TTD_COMPILECHECK=1 arms the sanitizer).",
            fn=compilecheck.total_compiles)
        # Live roofline per instrumented program (no series in the
        # port, whose ledger is empty): XLA's cost analysis
        # (captured once per compiled signature) times the dispatch
        # rate, against the device's datasheet peaks — the always-on
        # version of the bench harness's decode_mbu_fields.  Labeled by
        # jit site (under a replica pool, "<replica>/<site>" from each
        # worker's relayed program stats).  No series unless
        # TTD_COMPILECHECK=1 armed the dispatch wrapper AND a peak is
        # known (datasheet TPU entry, or the TTD_PEAK_FLOPS /
        # TTD_PEAK_HBM_BYTES overrides) — never a made-up percentage.
        self.mfu_pct = r.labeled_gauge(
            "ttd_engine_mfu_pct",
            "Achieved model flops as % of device peak, per "
            "instrumented jit program over a trailing window (no "
            "series unless TTD_COMPILECHECK=1 and the peak is known).",
            "program",
            fn=(mfu_fn if mfu_fn is not None
                else compilecheck.mfu_by_program))
        self.mbu_pct = r.labeled_gauge(
            "ttd_engine_mbu_pct",
            "Achieved HBM bytes as % of device peak bandwidth, per "
            "instrumented jit program over a trailing window (no "
            "series unless TTD_COMPILECHECK=1 and the peak is known).",
            "program",
            fn=(mbu_fn if mbu_fn is not None
                else compilecheck.mbu_by_program))
        # The queue-depth gauge's latency companion: how long admission
        # actually COSTS (admission → engine slot granted), observed by
        # the driver when engine.submit succeeds — queue depth alone
        # cannot distinguish a deep-but-fast queue from a shallow
        # stuck one.
        self.queue_wait = r.histogram(
            "ttd_gateway_queue_wait_seconds",
            "Admission-to-slot-granted wait per request (observed, "
            "chunk-granular, when the request first holds an engine "
            "lane — staged prefill counts, the lane is reserved).")
        self.ttft = r.histogram(
            "ttd_gateway_ttft_seconds",
            "Submit-to-first-generated-token latency (chunk-granular: "
            "tokens commit per decode chunk).")
        self.inter_token = r.histogram(
            "ttd_gateway_inter_token_seconds",
            "Per-token generation latency: commit-to-commit gap "
            "divided by the tokens it delivered (observed per "
            "committed chunk after a request's first).",
            buckets=INTER_TOKEN_BUCKETS)
        self.latency = r.histogram(
            "ttd_gateway_request_latency_seconds",
            "Submit-to-completion latency per served request.")

    def render(self) -> str:
        return self.registry.render()
