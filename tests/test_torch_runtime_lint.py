"""The port's runtime lint pieces (``runtime/lint/registry``, ``lockcheck``,
``memcheck``) and flight recorder (``runtime/events``) against the JAX
package's on the CPU.

- The registry's declarations are free when no sanitizer is armed (the
  function or class comes back untouched), ``compile_site`` is a
  declaration even when armed, and the refusals carry JAX's words.
- memcheck over torch tensors: a storage is counted once whatever views of
  it a tree holds; a leaf charge goes when the tensor owning the storage
  dies, an owner charge when a same-site allocation replaces it; an
  allocation over budget raises ``MemoryBudgetError`` before it runs,
  with the live set listed in the JAX message.
- lockcheck and events: the cases of JAX ``tests/test_lockcheck.py`` and
  ``tests/test_events.py`` that need no JAX engine, run on both packages'
  modules (parametrized), with the same outcomes.

The suite's conftest arms ``TTD_LOCKCHECK`` and ``TTD_MEMCHECK``.
"""

import gc
import json
import re
import threading
import time

import jax.numpy as jnp
import pytest
import torch

from tensorflow_train_distributed_tpu.runtime import events as jevents
from tensorflow_train_distributed_tpu.runtime.lint import (
    lockcheck as jlockcheck,
    memcheck as jmemcheck,
    registry as jregistry,
)
from tensorflow_train_distributed_torch.models.layers import KVCache
from tensorflow_train_distributed_torch.runtime import events as tevents
from tensorflow_train_distributed_torch.runtime.lint import (
    lockcheck as tlockcheck,
    memcheck,
    registry as tregistry,
)

PACKAGES = {"jax": (jevents, jlockcheck, jregistry),
            "port": (tevents, tlockcheck, tregistry)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """(events, lockcheck, registry) of one package, its lock-order
    graph fresh."""
    ev, lc, reg = PACKAGES[request.param]
    lc.reset_graph()
    yield ev, lc, reg
    lc.reset_graph()


# -- the registry -------------------------------------------------------------


def test_declarations_are_free_when_unarmed(monkeypatch):
    monkeypatch.setenv("TTD_NO_LOCKCHECK", "1")
    monkeypatch.setenv("TTD_NO_MEMCHECK", "1")

    def fn(self, x):
        return x

    assert tregistry.thread_role("driver", "main")(fn) is fn
    assert fn.__ttd_thread_roles__ == ("driver", "main")
    assert tregistry.memory_budget(pool="p", budget_bytes=1)(fn) is fn
    assert fn.__ttd_memory_pool__ == "p"
    assert tregistry.dispatch_critical(fn) is fn
    assert tregistry.locks_held("_lk")(fn) is fn

    class Guarded:
        _GUARDED_BY = {"x": ("_lk",)}

    assert tregistry.concurrency_guarded(Guarded) is Guarded
    assert "x" not in vars(Guarded)            # no guard descriptor


def test_compile_site_is_a_declaration_even_when_armed(monkeypatch):
    """Eager PyTorch has no compile to watch: the site's arguments are
    recorded on the function, which comes back untouched."""
    monkeypatch.setenv("TTD_COMPILECHECK", "1")

    def prog(self, cache, tokens):
        return tokens

    out = tregistry.compile_site(buckets="prompt_buckets", donates=(2,),
                                 statics=(0,), max_compiles=32)(prog)
    assert out is prog
    assert prog.__ttd_compile_site__ == dict(
        site=prog.__qualname__, buckets="prompt_buckets", donates=(2,),
        statics=(0,), static_names=(), max_compiles=32)


@pytest.mark.parametrize("call", [
    lambda r: r.thread_role("nobody"),
    lambda r: r.thread_role(),
    lambda r: r.locks_held(),
    lambda r: r.guard_specs(type("C", (), {"_GUARDED_BY": {"a": (None,)}})),
    lambda r: r.guard_specs(type("C", (), {"_GUARDED_BY": {"a": 3}})),
    lambda r: r.guard_specs(type("C", (), {"_GUARDED_BY": {"a": (
        "_lk", "nobody")}})),
])
def test_registry_refusals_carry_jaxs_words(call):
    msgs = []
    for reg in (jregistry, tregistry):
        with pytest.raises((ValueError, TypeError)) as e:
            call(reg)
        msgs.append((type(e.value), str(e.value)))
    assert msgs[0] == msgs[1]
    assert tregistry.THREAD_ROLES == jregistry.THREAD_ROLES


# -- memcheck over torch tensors ------------------------------------------------


@pytest.fixture
def ledger():
    assert memcheck.armed(), "conftest arms TTD_MEMCHECK"
    memcheck.reset()
    yield
    memcheck.reset()


def test_tree_bytes_counts_a_storage_once():
    a = torch.zeros(10, 8)                      # 320 bytes
    tree = {"whole": a, "rows": a[2:5], "view": a.view(80),
            "t": [a.t(), (torch.zeros(3, dtype=torch.int8),)]}
    assert memcheck.tree_bytes(tree) == 320 + 3
    # A view counts its whole storage: it pins all of it.
    assert memcheck.tree_bytes(a[:1]) == 320
    meta = torch.empty(4, 4, device="meta", dtype=torch.bfloat16)
    assert memcheck.tree_bytes([meta, meta[1:], torch.empty(
        2, device="meta")]) == 32 + 8
    cache = KVCache(layers=[{"key_cache": torch.zeros(2, 3)}],
                    index=torch.zeros(2, dtype=torch.int32), cache_len=3)
    assert memcheck.tree_bytes(cache) == 24 + 8


class _Owner:
    budget = None

    @tregistry.memory_budget(pool=lambda self, n, tag="": "pool_" + tag,
                             budget_fn=lambda self, *a, **k: self.budget,
                             lifetime="leaf")
    def leaf(self, n, tag=""):
        t = torch.zeros(n, dtype=torch.float32)
        return {"t": t, "v": t[1:], "w": t.view(1, n)}

    @tregistry.memory_budget(pool="grid",
                             budget_fn=lambda self, *a, **k: self.budget,
                             project_fn=lambda self, n: 4 * n)
    def owned(self, n):
        self.calls = getattr(self, "calls", 0) + 1
        return torch.zeros(n)


def test_leaf_charge_is_released_when_the_storage_dies(ledger):
    o = _Owner()
    out = o.leaf(64, "a")
    assert memcheck.live_bytes(owner=o) == 256          # views once
    assert memcheck.live_by_pool() == {"pool_a": 256.0}
    keep = out["v"]                  # a view keeps the storage alive
    del out
    gc.collect()
    assert memcheck.live_bytes(owner=o) == 256
    del keep
    gc.collect()
    assert memcheck.live_bytes(owner=o) == 0
    assert memcheck.peak_by_pool() == {"pool_a": 256.0}


def test_owner_charge_is_replaced_by_the_same_site(ledger):
    o = _Owner()
    o.owned(16)
    o.owned(32)                      # a rebuilt pool: replaces, not adds
    assert memcheck.live_bytes(owner=o, pool="grid") == 128
    o2 = _Owner()
    o2.owned(16)
    assert memcheck.live_bytes() == 128 + 64            # per owner
    del o2
    gc.collect()
    assert memcheck.live_bytes() == 128                 # purged with it


def test_owner_collected_inside_a_locked_section_does_not_deadlock(ledger):
    """An owner's finalizer can run at any allocation, also inside a
    ledger section that holds the (non-reentrant) state lock: it queues
    its purge, which the next reader applies."""
    o = _Owner()
    o.owned(16)
    tok = memcheck._owner_token(o)
    done = threading.Event()

    def collect_while_locked():
        with memcheck._STATE_LOCK:
            memcheck._purge_owner(tok)
        done.set()

    t = threading.Thread(target=collect_while_locked, daemon=True)
    t.start()
    t.join(timeout=10)
    assert done.is_set() and not t.is_alive()
    assert memcheck.live_bytes() == 0


def test_over_budget_raises_before_the_allocation(ledger):
    o = _Owner()
    o.budget = 300
    o.owned(32)                      # 128 live
    keep = o.leaf(32, "b")           # 128 more
    with pytest.raises(memcheck.MemoryBudgetError) as e:
        o.leaf(32, "c")
    msg = str(e.value)
    assert "allocator 'test_torch_runtime_lint._Owner.leaf'" in msg
    assert "live grid/test_torch_runtime_lint._Owner.owned" in msg
    assert "live pool_b/test_torch_runtime_lint._Owner.leaf#" in msg
    # The projection stops an owner allocation before its body runs.
    o.budget = 200
    calls = o.calls
    with pytest.raises(memcheck.MemoryBudgetError):
        o.owned(64)
    assert o.calls == calls
    del keep


def test_track_charges_a_stored_tree_and_the_veto_disarms(ledger,
                                                          monkeypatch):
    o = _Owner()
    pair = (torch.zeros(8), torch.zeros(8))
    memcheck.track(o, "prefix_cache", pair, label="prefix8")
    assert memcheck.live_bytes(owner=o, pool="prefix_cache") == 64
    with pytest.raises(memcheck.MemoryBudgetError, match="prefix_cache"):
        memcheck.track(o, "prefix_cache", (torch.zeros(8),), label="p",
                       budget=70)
    del pair
    gc.collect()
    monkeypatch.setenv("TTD_NO_MEMCHECK", "1")
    assert not memcheck.armed()
    o.budget = 1
    o.leaf(64, "d")                  # vetoed live: no charge, no raise
    assert memcheck.live_bytes(owner=o, pool="pool_d") == 0


def test_budget_error_reads_as_jaxs(ledger):
    """The same allocations through both packages' sanitizers raise the
    same text (sites and bytes equal; leaf labels end in an allocation
    count of their own)."""
    jmemcheck.reset()
    msgs = []
    for mc, reg, zeros in (
            (jmemcheck, jregistry, lambda n: jnp.zeros((n,), jnp.float32)),
            (memcheck, tregistry, lambda n: torch.zeros(n))):

        class Owner:
            @reg.memory_budget(pool="kv_pool", budget_bytes=1536)
            def grid(self, n):
                return zeros(n)

            @reg.memory_budget(pool="prefill_cache", budget_bytes=1536,
                               lifetime="leaf")
            def prefill(self, n):
                return zeros(n)

        o = Owner()
        o.grid(256)
        with pytest.raises(mc.MemoryBudgetError) as e:
            o.prefill(256)
        # Allocation ids count each process's allocations.
        msgs.append(re.sub(r"#\d+", "#N", str(e.value)))
    jmemcheck.reset()
    assert msgs[0] == msgs[1]


# -- lockcheck (JAX tests/test_lockcheck.py's cases, both packages) -------------


def test_inverted_acquisition_raises_lock_order_error(pkg):
    _, lc, _ = pkg
    a, b = lc.make_lock("test:A"), lc.make_lock("test:B")
    with a:
        with b:
            pass
    with pytest.raises(lc.LockOrderError, match="A"):
        with b:
            with a:
                pass


def test_consistent_order_never_raises(pkg):
    _, lc, _ = pkg
    a, b, c = lc.make_lock("t:A"), lc.make_lock("t:B"), lc.make_lock("t:C")
    for _ in range(50):
        with a:
            with b:
                with c:
                    pass
        with b:
            with c:
                pass


def test_transitive_cycle_detected(pkg):
    _, lc, _ = pkg
    a, b, c = (lc.make_lock(f"tt:{x}") for x in "ABC")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(lc.LockOrderError, match="potential ABBA deadlock"):
        with c:
            with a:
                pass


def test_sibling_instances_nested_raises(pkg):
    _, lc, _ = pkg
    x, y = lc.make_lock("sib:same"), lc.make_lock("sib:same")
    with pytest.raises(lc.LockOrderError, match="sibling"):
        with x:
            with y:
                pass


def test_failed_acquire_releases_inner_lock(pkg):
    _, lc, _ = pkg
    a, b = lc.make_lock("rel:A"), lc.make_lock("rel:B")
    with a:
        with b:
            pass
    with pytest.raises(lc.LockOrderError):
        with b:
            with a:
                pass
    assert not a._inner.locked() and not b._inner.locked()


def test_cross_thread_inversion_detected(pkg):
    _, lc, _ = pkg
    a, b = lc.make_lock("x:A"), lc.make_lock("x:B")
    errs = []

    def leg1():
        with a:
            with b:
                pass

    def leg2():
        try:
            with b:
                with a:
                    pass
        except lc.LockOrderError as e:
            errs.append(e)

    for leg in (leg1, leg2):
        t = threading.Thread(target=leg)
        t.start()
        t.join()
    assert len(errs) == 1


def test_condition_wait_notify_and_reentrant_counts(pkg):
    _, lc, _ = pkg
    lk = lc.make_rlock("cond:lk")
    cond = threading.Condition(lk)
    ready = []

    def waiter():
        with cond:
            while not ready:
                cond.wait(timeout=5.0)
        assert not lk.held_by_current()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        ready.append(1)
        cond.notify()
    t.join(timeout=5.0)
    assert not t.is_alive() and not lk.held_by_current()
    with lk:
        with lk:
            assert lk.held_by_current()
        assert lk.locked()
    assert not lk.locked()


def _guarded(lc, reg):
    class Guarded:
        _GUARDED_BY = {"shared": ("_lk",), "stat": ("_lk", "driver"),
                       "flag": (None, "watchdog")}

        def __init__(self):
            self._lk = lc.make_lock("g:lk")
            self.shared = 0
            self.stat = 0
            self.flag = False

    lc.install_attr_guards(Guarded, reg.guard_specs(Guarded))
    roles = {r: reg.thread_role(r)(lambda fn: fn())
             for r in ("handler", "driver", "watchdog")}
    return Guarded(), roles


def test_guarded_attributes_enforced_live(pkg):
    _, lc, reg = pkg
    g, as_role = _guarded(lc, reg)
    with pytest.raises(lc.GuardViolation, match="shared"):
        as_role["handler"](lambda: g.shared)

    def locked_read():
        with g._lk:
            return g.shared

    assert as_role["handler"](locked_read) == 0
    assert as_role["driver"](lambda: g.stat) == 0    # owner: lock-free
    with pytest.raises(lc.GuardViolation, match="stat"):
        as_role["handler"](lambda: g.stat)
    assert as_role["handler"](lambda: g.flag) is False

    def set_flag():
        g.flag = True

    as_role["watchdog"](set_flag)
    with pytest.raises(lc.GuardViolation, match="flag"):
        as_role["handler"](set_flag)
    g.shared = 5                     # untagged threads pass through
    assert g.shared == 5


def test_no_lockcheck_escape_hatch(pkg, monkeypatch):
    _, lc, reg = pkg
    monkeypatch.setenv("TTD_NO_LOCKCHECK", "1")
    assert not lc.armed() and not reg._sanitizer_armed()
    monkeypatch.delenv("TTD_NO_LOCKCHECK")
    assert lc.armed()


# -- events (JAX tests/test_events.py's cases, both packages) -------------------


REQUIRED_KEYS = {"name", "ph", "ts", "pid", "tid"}


@pytest.fixture(autouse=True)
def _trace_on(monkeypatch):
    monkeypatch.delenv("TTD_NO_TRACE", raising=False)


def _validate_chrome(trace: dict) -> None:
    assert isinstance(trace["traceEvents"], list)
    json.dumps(trace)
    for ev in trace["traceEvents"]:
        assert REQUIRED_KEYS <= set(ev), ev
        assert ev["ph"] in ("X", "i", "B", "E"), ev
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0


def test_ring_is_bounded_and_spans_carry_attrs(pkg):
    ev = pkg[0]
    rec = ev.Recorder(capacity=8)
    for i in range(20):
        rec.instant("tick", i=i)
    assert [e[5]["i"] for e in rec.events()] == list(range(12, 20))
    rec = ev.Recorder(capacity=16)
    with rec.span("work/unit", k="v"):
        pass
    rec.instant("mark", n=3)
    (name, ph, t0, dur, tid, attrs), (n2, ph2, *_rest) = rec.events()
    assert (name, ph, attrs) == ("work/unit", "X", {"k": "v"})
    assert dur >= 0 and tid == threading.get_ident()
    assert (n2, ph2) == ("mark", "i")


def test_kill_switch_records_nothing(pkg, monkeypatch):
    ev = pkg[0]
    rec = ev.Recorder(capacity=16)
    monkeypatch.setenv("TTD_NO_TRACE", "1")
    assert not rec.enabled
    with rec.span("dead"):
        rec.instant("dead/too")
    assert len(rec) == 0
    assert rec.export_chrome_trace()["otherData"]["killed"] is True
    monkeypatch.delenv("TTD_NO_TRACE")
    with rec.span("live"):
        pass
    assert [e[0] for e in rec.events()] == ["live"]


def test_last_s_window_and_export_schema(pkg):
    ev = pkg[0]
    rec = ev.Recorder(capacity=16)
    rec._buf.append(("old", "i", -1e9, 0.0, 1, None))
    rec.instant("new")
    assert [e[0] for e in rec.events(last_s=60.0)] == ["new"]
    rec = ev.Recorder(capacity=16)
    with rec.span("a/b", x=1):
        rec.instant("c/d")
    trace = rec.export_chrome_trace()
    _validate_chrome(trace)
    by_name = {e["name"]: e for e in trace["traceEvents"]}
    assert by_name["a/b"]["args"] == {"x": 1}
    assert by_name["a/b"]["cat"] == "a"
    assert by_name["c/d"]["s"] == "t"


def test_request_timeline_joins_latest_life_only(pkg):
    rec = pkg[0].Recorder(capacity=64)
    rec.instant("request/admitted", request_id=0)
    rec.instant("request/engine_submit", request_id=0, rid=7)
    rec.instant("prefill/old", rid=7)
    rec.instant("request/retire", request_id=0, status="expired")
    rec.instant("request/admitted", request_id=1)
    rec.instant("request/admitted", request_id=0)
    rec.instant("request/engine_submit", request_id=0, rid=12)
    rec.instant("slot/insert", rid=12, slot=0)
    rec.instant("request/commit", request_id=0, tokens=2)
    rec.instant("request/retire", request_id=0, status="ok")
    rec.instant("decode/later", rid=12)
    assert [e[0] for e in rec.request_timeline(0)] == [
        "request/admitted", "request/engine_submit", "slot/insert",
        "request/commit", "request/retire"]


def test_concurrent_appends_and_reads_are_safe(pkg):
    rec = pkg[0].Recorder(capacity=1024)
    stop = threading.Event()
    errs = []

    def writer():
        try:
            while not stop.is_set():
                with rec.span("w"):
                    rec.instant("i")
        except BaseException as e:          # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(100):
            _validate_chrome(rec.export_chrome_trace())
            rec.events(last_s=1.0)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errs and len(rec) == 1024
