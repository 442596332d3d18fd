"""ttd-lint over the port (``tensorflow_train_distributed_torch/runtime/lint``
and ``tools/ttd_lint.py``) against the JAX package's checkers.

- the gate: the port's package and ``chip_smoke.py`` lint clean;
- parity: on the shared fixtures (``tests/lint_fixtures/``) the port's
  concurrency, kill-switch and prometheus checkers report the JAX
  checkers' (checker, line) findings;
- seeded mutation: torch fixtures plant every dispatch and memcheck
  hazard, and each must be flagged, their clean twins not;
- mechanics: the suppression audit (JAX's cases), spec validation, the
  CLI's exit bits and JSON;
- the switches the kill-switch checker found untested, each exercised.
"""

import fcntl
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter

import pytest

from tensorflow_train_distributed_torch.runtime.lint import core, run_lint
from tensorflow_train_distributed_torch.tools import ttd_lint

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(os.path.dirname(__file__), "lint_fixtures")


def _messages(findings):
    return [f"{f.line}:{f.message}" for f in findings]


def _write(tmp_path, name, source):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return str(path)


# -- the gate ----------------------------------------------------------------


def test_port_tree_lints_clean():
    """The port's package and chip_smoke.py, every checker, zero findings
    (suppressions are visible exceptions with their reasons)."""
    findings = run_lint(root=ROOT)
    assert findings == [], "\n" + "\n".join(
        f.format(root=ROOT) for f in findings)


def test_default_scope_is_the_port_and_chip_smoke():
    paths = core.default_paths(ROOT)
    assert paths == [os.path.join(ROOT, "tensorflow_train_distributed_torch"),
                     os.path.join(ROOT, "chip_smoke.py")]
    files = core.iter_source_files(paths)
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert not any("tensorflow_train_distributed_tpu" in f for f in files)
    assert not any("lint_fixtures" in f for f in files)


# -- parity with the JAX checkers on the shared fixtures --------------------


@pytest.mark.parametrize("checker,fixture", [
    ("concurrency", "fixture_concurrency.py"),
    ("kill-switch", "fixture_flags.py"),
    ("prometheus", "fixture_prometheus.py"),
])
def test_fixture_findings_equal_jax(checker, fixture):
    from tensorflow_train_distributed_tpu.runtime.lint import (
        run_lint as jax_run_lint,
    )

    path = os.path.join(FIXTURES, fixture)
    port = run_lint(paths=[path], checkers=[checker], root=ROOT)
    ref = jax_run_lint(paths=[path], checkers=[checker], root=ROOT)
    assert ref, "the fixture plants findings"
    assert Counter((f.checker, f.line) for f in port) == \
        Counter((f.checker, f.line) for f in ref)


def test_concurrency_fixture_messages():
    path = os.path.join(FIXTURES, "fixture_concurrency.py")
    msgs = "\n".join(_messages(run_lint(paths=[path],
                                        checkers=["concurrency"], root=ROOT)))
    assert "BuggyDriver.harvest: write to '_inflight'" in msgs
    assert "BuggyDriver.status: read of '_inflight'" in msgs
    assert "BuggyDriver.scrape: read of 'stats'" in msgs
    assert "BuggyDriver.bump: write to 'stats'" in msgs
    assert "BuggyDriver.kill: write to atomic-publish attribute 'dead'" \
        in msgs
    assert "BuggyDriver.rogue calls _admit()" in msgs
    assert "CleanDriver" not in msgs


def test_flags_fixture_undocumented_var_flagged():
    path = os.path.join(FIXTURES, "fixture_flags.py")
    findings = run_lint(paths=[path], checkers=["kill-switch"], root=ROOT)
    assert [f.message for f in findings] == [
        "env flag TTD_FIXTURE_UNDOCUMENTED is not documented in "
        "README.md's port section"]


def test_prometheus_fixture_every_plant_flagged():
    path = os.path.join(FIXTURES, "fixture_prometheus.py")
    msgs = "\n".join(_messages(run_lint(paths=[path],
                                        checkers=["prometheus"], root=ROOT)))
    assert "counter 'ttd_fixture_requests' must end in _total" in msgs
    assert "histogram 'ttd_fixture_latency_ms' must end in _seconds" in msgs
    assert "metric 'ttd_fixture_mystery_gauge' missing from README" in msgs
    assert "ttd_gateway_requests_total" not in msgs


# -- concurrency mechanics ---------------------------------------------------


def test_concurrency_checker_validates_guard_specs(tmp_path):
    bad = _write(tmp_path, "bad_spec.py", """\
        class C:
            _GUARDED_BY = {'x': (None,), 'y': ('_lock', 'no_such_role')}
            def __init__(self):
                self.x = 1
                self.y = 2
        """)
    msgs = "\n".join(_messages(run_lint(paths=[bad],
                                        checkers=["concurrency"], root=ROOT)))
    assert "needs an owner role" in msgs
    assert "unknown owner role 'no_such_role'" in msgs


def test_concurrency_checker_flags_typod_lock_name(tmp_path):
    bad = _write(tmp_path, "typo_lock.py", """\
        class C:
            _GUARDED_BY = {'x': ('_lok',)}
            def __init__(self):
                import threading
                self._lock = threading.Lock()
                self.x = 1
            def read(self):
                with self._lock:
                    return self.x
        """)
    msgs = "\n".join(_messages(run_lint(paths=[bad],
                                        checkers=["concurrency"], root=ROOT)))
    assert "never assigned on self" in msgs
    assert "read of 'x' without holding self._lok" in msgs


# -- seeded mutation: dispatch purity ----------------------------------------

_DISPATCH_FIXTURE = """\
import os
import random
import time

import numpy as np
import torch


def dispatch_critical(fn):
    return fn


@dispatch_critical
def planted(self, x):
    a = x.item()
    b = x.tolist()
    c = x.cpu()
    d = x.numpy()
    e = float(x)
    f = int(x.sum())
    g = bool(x)
    torch.cuda.synchronize()
    h = np.asarray(x)
    m = torch.zeros(3)
    if m.any():
        pass
    while m:
        break
    k = os.environ.get("HOME")
    t = time.time()
    r = random.random()
    z = torch.rand(3)
    return a, b, c, d, e, f, g, h, k, t, r, z


@dispatch_critical
def clean(self, x, gen):
    t = time.perf_counter()
    y = torch.rand(3, generator=gen)
    if self._flag and self._slots:
        y = y + 1
    n = int(-1)
    return y, n, time.monotonic() - t


def undeclared(x):
    return x.item(), float(x), time.time()
"""


def test_dispatch_fixture_every_plant_flagged(tmp_path):
    path = _write(tmp_path, "dispatch_fixture.py", _DISPATCH_FIXTURE)
    findings = run_lint(paths=[path], checkers=["dispatch"], root=ROOT)
    msgs = "\n".join(_messages(findings))
    for plant in (".item() host sync", ".tolist() host sync",
                  ".cpu() host sync", ".numpy() host sync",
                  "float() on a non-constant", "int() on a non-constant",
                  "bool() on a non-constant",
                  "torch.cuda.synchronize() host sync",
                  "np.asarray() device-value materialization",
                  "tensor in a branch test, .any()",
                  "tensor in a branch test, 'm'",
                  "os.environ.get(): slow env read",
                  "time.time(): wall clock",
                  "random.random(): host-side randomness",
                  "torch.rand() without generator="):
        assert f"planted: {plant}" in msgs, plant
    assert len(findings) == 15
    assert "clean" not in msgs
    assert "undeclared" not in msgs


def test_engine_dispatch_window_is_declared():
    """The port's engine declares the JAX engine's four dispatch-critical
    functions, so the checker holds the same window."""
    from tensorflow_train_distributed_torch.serving import ServingEngine

    for name in ("_flush_stale_lanes", "_carry_arrays", "_dispatch_chunk",
                 "_skip_eager_dispatch"):
        assert getattr(getattr(ServingEngine, name),
                       "__ttd_dispatch_critical__", False), name


# -- seeded mutation: memory discipline --------------------------------------

_MEMCHECK_FIXTURE = """\
import torch


def memory_budget(**kw):
    def deco(fn):
        return fn
    return deco


class Engine:
    @memory_budget(pool="kv_pool", budget_fn=lambda self, n: None)
    def clean_allocator(self, n):
        return self._helper(n)

    def _helper(self, n):
        return torch.zeros(n, device=self.device)

    def rogue_allocator(self, n):
        return torch.empty(n, device=self.device)

    def rogue_copy(self, x):
        return x.cuda()

    def host_only(self, n):
        a = torch.zeros(n, device="cpu")
        b = torch.empty(n, device="meta")
        c = torch.ones(n, device=torch.device("cpu"))
        return a, b, c, torch.full((n,), 1.0)

    @memory_budget(pool="scratch")
    def unbudgeted_allocator(self, n):
        return torch.full((n,), 0.0, device=self.device)

    @memory_budget(budget_bytes=1024)
    def poolless_allocator(self, n):
        return torch.zeros_like(torch.empty(n), device=self.device)
"""


def test_memcheck_fixture_every_plant_flagged(tmp_path):
    path = _write(tmp_path, "memcheck_fixture.py", _MEMCHECK_FIXTURE)
    findings = run_lint(paths=[path], checkers=["memcheck"], root=ROOT)
    msgs = "\n".join(_messages(findings))
    assert ("un-annotated device allocation: torch.empty(...) in "
            "'rogue_allocator'") in msgs
    assert "un-annotated device allocation: x.cuda(...) in 'rogue_copy'" \
        in msgs
    assert ("'unbudgeted_allocator': @memory_budget declares a pool but no "
            "budget") in msgs
    assert "'poolless_allocator': @memory_budget without pool=" in msgs
    assert len(findings) == 4
    assert "_helper" not in msgs and "host_only" not in msgs


def test_memcheck_hot_module_rule_is_opt_in(tmp_path):
    cold = _write(tmp_path, "cold.py", """\
        import torch
        def anything(n, device):
            return torch.zeros(n, device=device)
        """)
    assert run_lint(paths=[cold], checkers=["memcheck"], root=ROOT) == []
    # The engine's module must declare a pool.
    engine = _write(tmp_path, os.path.join(
        "tensorflow_train_distributed_torch", "serving.py"), "X = 1\n")
    findings = run_lint(paths=[engine], checkers=["memcheck"], root=ROOT)
    assert [(f.line, "declares no @memory_budget pool" in f.message)
            for f in findings] == [(1, True)]


# -- kill switches -----------------------------------------------------------


def test_flags_checker_requires_port_docs_and_port_tests(tmp_path):
    # Assembled so this file never holds the name: the tests corpus
    # includes this file.
    var = "TTD_NEVER_" + "EXERCISED_ANYWHERE"
    mod = _write(tmp_path, "flagged.py",
                 f"import os\nV = os.environ.get({var!r})\n")
    msgs = "\n".join(_messages(run_lint(paths=[mod],
                                        checkers=["kill-switch"], root=ROOT)))
    assert "is not exercised by any test under tests/test_torch_*.py" in msgs
    assert "is not documented in README.md's port section" in msgs


def test_flags_corpus_is_the_ports_tests_and_readme_section():
    ctx = core.LintContext(ROOT)
    corpus = ctx.tests_corpus()
    assert "def test_port_tree_lints_clean" in corpus
    # JAX's suite (assembled: this file is in the corpus).
    assert "def test_whole_tree_" + "lints_clean" not in corpus
    section = ctx.port_readme().splitlines()
    assert section[0] == core.PORT_README_HEADING
    assert not [line for line in section[1:] if line.startswith("## ")]


def test_flags_family_glob_satisfies_documentation():
    from tensorflow_train_distributed_torch.runtime.lint.flags import (
        _family_documented,
    )

    assert _family_documented("TTD_K8S_COORDINATOR",
                              "docs: `TTD_K8S_*` family")
    assert not _family_documented("TTD_OTHER_THING",
                                  "docs: `TTD_K8S_*` family")


# -- suppressions (the JAX suite's cases) ------------------------------------

_REGISTRY_STUB = """\
class R:
    def counter(self, n, h):
        return n
r = R()
"""


def test_suppression_format_silences_exactly_the_named_checker(tmp_path):
    mod = _write(tmp_path, "suppressed.py", _REGISTRY_STUB
                 + "a = r.counter('bad_name', 'x')  # ttd-lint: "
                   "disable=prometheus -- fixture metric, not scraped\n"
                 + "b = r.counter('also_bad', 'x')\n")
    findings = run_lint(paths=[mod], checkers=["prometheus"], root=ROOT)
    msgs = "\n".join(_messages(findings))
    assert "also_bad" in msgs
    assert "bad_name" not in msgs
    assert "suppression" not in {f.checker for f in findings}


def test_suppression_without_reason_is_a_finding(tmp_path):
    mod = _write(tmp_path, "reasonless.py", _REGISTRY_STUB
                 + "a = r.counter('bad_name', 'x')  # ttd-lint: "
                   "disable=prometheus\n")
    msgs = "\n".join(_messages(run_lint(paths=[mod],
                                        checkers=["prometheus"], root=ROOT)))
    assert "bad_name" not in msgs
    assert "missing a reason" in msgs


def test_unused_suppression_is_a_finding(tmp_path):
    mod = _write(tmp_path, "unused.py",
                 "x = 1  # ttd-lint: disable=prometheus -- stale: moved\n")
    msgs = "\n".join(_messages(run_lint(paths=[mod],
                                        checkers=["prometheus"], root=ROOT)))
    assert "unused suppression for checker 'prometheus'" in msgs


def test_suppression_audit_scoped_to_checkers_that_ran(tmp_path):
    mod = _write(tmp_path, "scoped.py",
                 "x = 1  # ttd-lint: disable=concurrency\n")
    assert run_lint(paths=[mod], checkers=["prometheus"], root=ROOT) == []


def test_docstring_suppression_examples_not_audited():
    core_py = os.path.join(ROOT, "tensorflow_train_distributed_torch",
                           "runtime", "lint", "core.py")
    findings = run_lint(paths=[core_py], root=ROOT)
    assert [f for f in findings if f.checker == "suppression"] == []


# -- the CLI -----------------------------------------------------------------


def test_cli_lists_and_exits_per_checker_bits(capsys, tmp_path):
    assert ttd_lint.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()
    assert listed == ["concurrency", "dispatch", "kill-switch", "memcheck",
                      "prometheus"]
    rc = ttd_lint.main(["--checker", "prometheus",
                        os.path.join(FIXTURES, "fixture_prometheus.py")])
    assert rc == 32 == core.CHECKER_EXIT_BITS["prometheus"]
    assert "fixture_prometheus.py" in capsys.readouterr().out
    rc = ttd_lint.main(["--checker", "concurrency",
                        os.path.join(FIXTURES, "fixture_concurrency.py")])
    assert rc == 4
    capsys.readouterr()
    # memcheck's bit (256) folds into bit 1: the shell would read 0.
    mem = _write(tmp_path, "memcheck_fixture.py", _MEMCHECK_FIXTURE)
    assert ttd_lint.main(["--checker", "memcheck", mem]) == 1
    capsys.readouterr()
    assert ttd_lint.main(["--checker", "nope"]) == 2
    assert ttd_lint.main(["--checker", "compilecheck"]) == 2


def test_cli_json_output_is_structured(capsys, tmp_path):
    dis = _write(tmp_path, "dispatch_fixture.py", _DISPATCH_FIXTURE)
    rc = ttd_lint.main(["--json", "--checker", "dispatch", dis])
    payload = json.loads(capsys.readouterr().out)
    assert rc == payload["exit_code"] == 8
    assert payload["counts"] == {"dispatch": 15}
    f = payload["findings"][0]
    assert set(f) == {"checker", "path", "line", "message"}
    assert f["path"].endswith("dispatch_fixture.py")
    assert payload["exit_bits"]["memcheck"] == 256
    mem = _write(tmp_path, "memcheck_fixture.py", _MEMCHECK_FIXTURE)
    rc = ttd_lint.main(["--json", "--checker", "memcheck", mem])
    payload = json.loads(capsys.readouterr().out)
    assert rc == payload["exit_code"] == 1
    assert payload["counts"]["memcheck"] == 4
    metrics = os.path.join(ROOT, "tensorflow_train_distributed_torch",
                           "server", "metrics.py")
    rc = ttd_lint.main(["--json", "--checker", "prometheus", metrics])
    payload = json.loads(capsys.readouterr().out)
    assert rc == payload["exit_code"] == 0
    assert payload["findings"] == []


def test_cli_module_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch.tools."
         "ttd_lint", "--list"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "kill-switch" in out.stdout.split()


# -- the switches the kill-switch checker found untested ---------------------


def test_chip_lock_held_inherits_the_lock(tmp_path, monkeypatch):
    from tensorflow_train_distributed_torch.runtime import chip_lock as CL

    path = tmp_path / "card.lock"
    monkeypatch.setenv("TTD_CHIP_LOCK_PATH", str(path))
    monkeypatch.delenv("TTD_CHIP_LOCK_HELD", raising=False)
    with open(path, "a+") as holder:
        fcntl.flock(holder, fcntl.LOCK_EX | fcntl.LOCK_NB)
        with pytest.raises(TimeoutError):
            with CL.chip_lock(timeout=0.05, poll=0.01):
                pass
        monkeypatch.setenv("TTD_CHIP_LOCK_HELD", "1")
        with CL.chip_lock(timeout=0.05, poll=0.01) as how:
            assert how == "inherited"
    monkeypatch.delenv("TTD_CHIP_LOCK_HELD")
    with CL.chip_lock(timeout=1.0, poll=0.01) as how:
        assert how == "acquired"
        assert os.environ["TTD_CHIP_LOCK_HELD"] == "1"
    assert "TTD_CHIP_LOCK_HELD" not in os.environ


def test_no_clock_sync_switch(monkeypatch):
    from tensorflow_train_distributed_torch.server import procpool

    monkeypatch.delenv("TTD_NO_CLOCK_SYNC", raising=False)
    assert procpool.clock_sync_killed() is False
    monkeypatch.setenv("TTD_NO_CLOCK_SYNC", "1")
    assert procpool.clock_sync_killed() is True
    monkeypatch.setenv("TTD_NO_CLOCK_SYNC", "0")
    assert procpool.clock_sync_killed() is False


def test_no_elastic_switch_vetoes_the_constructor(tmp_path, monkeypatch):
    from tensorflow_train_distributed_torch.runtime.supervisor import (
        TrainSupervisor,
    )

    def make():
        return TrainSupervisor(["true"], elastic=True, handle_signals=False,
                          journal_path=str(tmp_path / "journal.jsonl"))

    monkeypatch.delenv("TTD_NO_ELASTIC", raising=False)
    assert make().elastic is True
    monkeypatch.setenv("TTD_NO_ELASTIC", "1")
    assert make().elastic is False


def _child(env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **env_extra)
    env.pop("TF_CONFIG", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch.testing."
         "_child", "_torch_dist_workers:child_env", "0", "{}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    tagged = [line for line in out.stdout.splitlines()
              if line.startswith("TTD_RESULT:")]
    assert len(tagged) == 1, out.stdout
    return json.loads(tagged[0][len("TTD_RESULT:"):])


def test_runner_child_reads_threads_and_init_switches():
    from tensorflow_train_distributed_torch.testing.multiprocess import (
        free_ports,
    )

    res = _child({"TTD_TEST_THREADS": "3", "TTD_TEST_INIT_DISTRIBUTED": "0"})
    assert res == {"rank": 0, "threads": 3, "distributed": False,
                   "world": 1}
    res = _child({"TTD_TEST_THREADS": "1", "TTD_TEST_INIT_DISTRIBUTED": "1",
                  "TTD_COORDINATOR": f"127.0.0.1:{free_ports(1)[0]}",
                  "TTD_NUM_PROCESSES": "1", "TTD_PROCESS_ID": "0"})
    assert res == {"rank": 0, "threads": 1, "distributed": True,
                   "world": 1}


def test_trace_capacity_switch():
    code = ("from tensorflow_train_distributed_torch.runtime import events; "
            "print(events.get_recorder().capacity)")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, TTD_TRACE_CAPACITY="123", PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["123"]


def test_trace_spool_switches(tmp_path, monkeypatch):
    from tensorflow_train_distributed_torch.runtime import events

    spool = tmp_path / "spool"
    monkeypatch.setenv("TTD_TRACE_SPOOL", str(spool))
    monkeypatch.setenv("TTD_TRACE_SPOOL_BYTES", str(8 << 20))
    rec = events.Recorder(64)           # arms from the env
    try:
        assert rec.spool_info()["dir"] == str(spool)
        assert rec._spool["cap"] == 8 << 20
        assert rec._spool["seg_cap"] == 2 << 20
        for i in range(10):
            rec.instant("lint/switch", i=i)
    finally:
        rec.stop_spool()
    lines = [json.loads(line) for p in sorted(spool.iterdir())
             for line in p.read_text().splitlines() if line.strip()]
    names = [e[0] if isinstance(e, list) else e.get("name")
             for line in lines for e in line.get("b", [])]
    assert names.count("lint/switch") == 10
