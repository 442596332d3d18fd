"""Multi-process localhost clusters for distributed tests (counterpart
of the JAX package's ``testing/multiprocess.py``).

Real subprocesses, each running a named worker function, joined into
one gloo process group through a TCP store on localhost: collectives
run their true code paths.  The contract of the reference's
``MultiProcessRunner``: per-task env injection (``TF_CONFIG`` included,
via ``tf_config_env``), captured stdout/stderr, timeout detection, and
fault injection by killing workers.

Worker functions are addressed as ``"module:function"`` and must be
importable in the child (test modules are put on ``PYTHONPATH``
automatically); each is called ``fn(rank, **payload)`` and its JSON
return comes back as ``ProcessResult.value``.  Children run torch on
``threads`` intra-op threads (1 by default: a test suite runs many
clusters side by side) and each collective gives up after the
cluster's ``timeout`` (``TTD_DIST_TIMEOUT``), so a dead peer ends the
others rather than hanging them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Any, Optional, Sequence

_RESULT_TAG = "TTD_RESULT:"


class UnexpectedExitError(RuntimeError):
    """A worker died (crash or injected kill)."""

    def __init__(self, results):
        self.results = results
        detail = "\n".join(
            f"--- rank {r.rank} rc={r.returncode} ---\n{r.stderr[-2000:]}"
            for r in results if r.returncode != 0)
        super().__init__(f"worker process(es) failed:\n{detail}")


class TimeoutError_(RuntimeError):
    """The cluster did not finish in time."""


@dataclasses.dataclass
class ProcessResult:
    rank: int
    returncode: Optional[int]
    stdout: str
    stderr: str
    value: Any = None  # the worker fn's JSON-serializable return


def free_ports(n: int) -> list[int]:
    """Reserve n distinct free TCP ports (bind-then-release)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def tf_config_env(cluster: dict[str, Sequence[str]], task_type: str,
                  task_index: int) -> dict[str, str]:
    """A ``TF_CONFIG`` env var for one task, built per child so the real
    process env is never mutated."""
    return {"TF_CONFIG": json.dumps({
        "cluster": {k: list(v) for k, v in cluster.items()},
        "task": {"type": task_type, "index": task_index},
    })}


class MultiProcessRunner:
    """Launch N workers; join them; deliver per-rank results.

    With ``init_distributed`` (default) the children form one gloo group
    of N ranks before the worker runs."""

    def __init__(
        self,
        target: str,
        num_processes: int,
        *,
        payload: Optional[dict] = None,
        env_per_rank: Optional[Sequence[dict[str, str]]] = None,
        init_distributed: bool = True,
        threads: int = 1,
        timeout: float = 120.0,
    ):
        self.target = target
        self.num_processes = num_processes
        self.payload = payload or {}
        self.env_per_rank = env_per_rank or [{} for _ in range(num_processes)]
        self.init_distributed = init_distributed
        self.threads = threads
        self.timeout = timeout
        self._procs: list[subprocess.Popen] = []
        self._coordinator = f"127.0.0.1:{free_ports(1)[0]}"

    def start(self) -> "MultiProcessRunner":
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        for rank in range(self.num_processes):
            env = dict(os.environ)
            env.update(self.env_per_rank[rank])
            if self.init_distributed and "TF_CONFIG" not in env:
                env.update(
                    TTD_COORDINATOR=self._coordinator,
                    TTD_NUM_PROCESSES=str(self.num_processes),
                    TTD_PROCESS_ID=str(rank),
                )
            env["TTD_TEST_INIT_DISTRIBUTED"] = (
                "1" if self.init_distributed else "0")
            env["TTD_TEST_THREADS"] = str(self.threads)
            env["OMP_NUM_THREADS"] = str(self.threads)
            env.setdefault("TTD_DIST_TIMEOUT", str(self.timeout))
            extra_path = [repo_root] + [
                p for p in sys.path if p.endswith("tests")]
            env["PYTHONPATH"] = os.pathsep.join(
                extra_path + [env.get("PYTHONPATH", "")])
            self._procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "tensorflow_train_distributed_torch.testing._child",
                 self.target, str(rank), json.dumps(self.payload)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env, cwd=repo_root,
            ))
        return self

    def terminate(self, rank: int, sig: int = signal.SIGKILL) -> None:
        """Fault injection: kill one worker."""
        self._procs[rank].send_signal(sig)

    def join(self, *, expect_failure: bool = False) -> list[ProcessResult]:
        deadline = time.monotonic() + self.timeout
        results: list[ProcessResult] = []
        for rank, p in enumerate(self._procs):
            remaining = max(0.1, deadline - time.monotonic())
            try:
                out, err = p.communicate(timeout=remaining)
            except subprocess.TimeoutExpired:
                for q in self._procs:
                    if q.poll() is None:
                        q.kill()
                out, err = p.communicate()
                results.append(ProcessResult(rank, None, out, err))
                raise TimeoutError_(
                    f"rank {rank} exceeded {self.timeout}s; stderr tail:\n"
                    f"{err[-2000:]}")
            value = None
            for line in out.splitlines():
                if line.startswith(_RESULT_TAG):
                    value = json.loads(line[len(_RESULT_TAG):])
            results.append(ProcessResult(rank, p.returncode, out, err, value))
        if not expect_failure and any(r.returncode != 0 for r in results):
            raise UnexpectedExitError(results)
        return results

    def run(self, *, expect_failure: bool = False) -> list[ProcessResult]:
        return self.start().join(expect_failure=expect_failure)
