"""Online serving gateway: HTTP frontend over the continuous-batching
engine (the scheduling/frontend layer ``serving.ServingEngine`` is the
compute layer of).  A copy of the JAX package's ``server/`` over the
port's engine: the frames, metric names and behaviors are JAX's.

- ``server.driver`` — the engine-owning background thread + thread-safe
  submission bridge (futures, bounded admission, deadlines, streaming);
- ``server.replicas`` — N drivers behind one admission layer:
  load/KV-affinity routing, per-replica health + hung-dispatch
  watchdog, deterministic request failover, staged drain;
- ``server.proto`` / ``server.worker`` / ``server.procpool`` — the
  out-of-process face of the same pool: subprocess engine workers
  speaking a versioned length-prefixed frame protocol, true-SIGKILL
  fault isolation, elastic scale/respawn;
- ``server.netpool`` — the multi-host face: TCP dial-in worker
  daemons (``serve_worker.py``) join the same pool with a
  declared ``prefill|decode|both`` role, and dedicated prefill
  workers hand finished KV to decode workers over binary KV_HANDOFF
  frames (disaggregated serving; ``TTD_NO_DISAGG=1`` collapses the
  role split);
- ``server.gateway`` — stdlib threaded HTTP frontend
  (``/v1/generate``, ``/healthz``, ``/metrics``) and drain lifecycle;
- ``server.metrics`` — stdlib Prometheus text-format registry.

Launchers: ``serve_http.py`` and ``serve_worker.py``; chaos gate:
``chaos_check.py --serving``; load generator:
``tools/bench_gateway.py`` (the JAX one's counterpart).
"""

from tensorflow_train_distributed_torch.server.driver import (  # noqa: F401
    AdmissionFull,
    DeadlineExceeded,
    Draining,
    EngineDriver,
    RequestError,
    RequestHandle,
)
from tensorflow_train_distributed_torch.server.gateway import (  # noqa: F401
    ServingGateway,
)
from tensorflow_train_distributed_torch.server.metrics import (  # noqa: F401
    GatewayMetrics,
    Registry,
)
from tensorflow_train_distributed_torch.server.netpool import (  # noqa: F401
    NetDriver,
    NetPool,
)
from tensorflow_train_distributed_torch.server.procpool import (  # noqa: F401
    ProcPool,
    WorkerSpec,
)
from tensorflow_train_distributed_torch.server.proto import (  # noqa: F401
    ProtocolError,
)
from tensorflow_train_distributed_torch.server.replicas import (  # noqa: F401
    NoReplicas,
    Replica,
    ReplicaPool,
)
