"""Cluster resolution and process-group initialization (counterpart of
the JAX package's ``runtime/distributed.py``).

Resolution order (first match wins), the JAX package's:

1. Explicit arguments (``--coordinator-address``, ``--num-processes``,
   ``--process-id``).
2. ``TTD_COORDINATOR`` / ``TTD_NUM_PROCESSES`` / ``TTD_PROCESS_ID``.
3. ``TF_CONFIG`` (the reference harness's cluster spec): coordinator =
   the first chief or worker, process id = the task's place; a
   parameter-server job is refused.
4. Slurm (``SLURM_PROCID`` / ``SLURM_NTASKS`` / ``SLURM_STEP_NODELIST``).
5. A Kubernetes Indexed Job (``JOB_COMPLETION_INDEX`` +
   ``TTD_K8S_REPLICAS``).
6. GCE metadata through ``TTD_GCE_METADATA`` (inline JSON or ``@file``).
7. One process.

Every resolver reads the environment only: no network at resolve time.
``initialize_distributed`` joins the job: ``init_process_group`` on a TCP
store at the coordinator address, ``nccl`` (with the rank's
``device_id``) on CUDA and ``gloo`` on the CPU.  One process with a
coordinator address makes a world-size-1 group, so that path runs the
code many processes run; one process with none joins nothing (a
``runtime.mesh.Mesh`` of one rank needs no group).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from typing import Optional

logger = logging.getLogger(__name__)

_DEFAULT_PORT = 8476


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Where this process sits in the cluster.

    ``num_processes == 1`` means single-process: ``initialize_distributed``
    joins nothing unless a coordinator address is given, matching the
    reference's default of
    MirroredStrategy on one worker.
    """

    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0
    source: str = "default"

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1

    @property
    def is_coordinator(self) -> bool:
        """Chief semantics (reference: ``multi_worker_util.is_chief``)."""
        return self.process_id == 0


def _from_env_native() -> Optional[DistributedConfig]:
    coord = os.environ.get("TTD_COORDINATOR")
    nproc = os.environ.get("TTD_NUM_PROCESSES")
    pid = os.environ.get("TTD_PROCESS_ID")
    if not (coord and nproc and pid):
        return None
    return DistributedConfig(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(pid),
        source="env:TTD_*",
    )


def _from_tf_config() -> Optional[DistributedConfig]:
    """Parse the reference harness's ``TF_CONFIG`` cluster spec.

    Mirrors ``TFConfigClusterResolver`` semantics: the ``worker`` job list
    orders processes; ``chief`` (if present) is process 0 and workers follow.
    Parameter-server jobs are rejected — the PS path is re-expressed as
    synchronous SPMD in this framework (SURVEY.md §2.4 "Async PS").
    """
    raw = os.environ.get("TF_CONFIG")
    if not raw:
        return None
    try:
        cfg = json.loads(raw)
        cluster = cfg.get("cluster", {})
        task = cfg.get("task", {})
        if "ps" in cluster:
            raise ValueError(
                "TF_CONFIG declares parameter-server tasks; this framework is "
                "SPMD-only (the reference's ParameterServerStrategy path maps "
                "to a synchronous data/tensor-parallel mesh — launch every "
                "task as a 'worker')."
            )
        chiefs = list(cluster.get("chief", []))
        workers = list(cluster.get("worker", []))
        ordered = chiefs + workers
        if not ordered:
            return None
        ttype = task.get("type", "worker")
        tindex = int(task.get("index", 0))
        if ttype == "chief":
            process_id = tindex
        elif ttype == "worker":
            process_id = len(chiefs) + tindex
        elif ttype == "evaluator":
            # Reference treats the evaluator as outside the training cluster.
            return DistributedConfig(source="tf_config:evaluator")
        else:
            raise ValueError(f"Unsupported TF_CONFIG task type: {ttype!r}")
        return DistributedConfig(
            coordinator_address=ordered[0],
            num_processes=len(ordered),
            process_id=process_id,
            source="env:TF_CONFIG",
        )
    except (json.JSONDecodeError, KeyError) as e:
        raise ValueError(f"Malformed TF_CONFIG: {e}") from e


def _expand_first_slurm_node(nodelist: str) -> str:
    """First hostname from a Slurm nodelist like ``host[3-5,9],other``."""
    m = re.match(r"([^\[,]+)(\[([^\]]+)\])?", nodelist)
    if not m:
        return nodelist.split(",")[0]
    prefix, _, body = m.groups()
    if not body:
        return prefix
    first = body.split(",")[0].split("-")[0]
    return prefix + first


def _from_slurm() -> Optional[DistributedConfig]:
    if "SLURM_PROCID" not in os.environ or "SLURM_NTASKS" not in os.environ:
        return None
    nproc = int(os.environ["SLURM_NTASKS"])
    pid = int(os.environ["SLURM_PROCID"])
    nodelist = os.environ.get(
        "SLURM_STEP_NODELIST", os.environ.get("SLURM_JOB_NODELIST", "localhost")
    )
    coord = f"{_expand_first_slurm_node(nodelist)}:{_DEFAULT_PORT}"
    return DistributedConfig(
        coordinator_address=coord,
        num_processes=nproc,
        process_id=pid,
        source="env:SLURM",
    )


def _from_kubernetes() -> Optional[DistributedConfig]:
    """Kubernetes Indexed-Job resolution (reference
    ``KubernetesClusterResolver``, ``kubernetes_cluster_resolver.py:42``).

    The reference lists pods through the cluster API server; this
    spelling needs no API access: an Indexed Job already gives every pod
    ``JOB_COMPLETION_INDEX`` (standard k8s env), the pod spec passes the
    replica count as ``TTD_K8S_REPLICAS``, and the coordinator address is
    either ``TTD_K8S_COORDINATOR`` or derived from the Indexed-Job +
    headless-service DNS convention ``<job>-0.<subdomain>`` via
    ``TTD_K8S_JOB_NAME`` / ``TTD_K8S_SUBDOMAIN``.
    """
    idx = os.environ.get("JOB_COMPLETION_INDEX")
    nproc = os.environ.get("TTD_K8S_REPLICAS")
    if idx is None or nproc is None:
        return None
    coord = os.environ.get("TTD_K8S_COORDINATOR")
    if not coord:
        job = os.environ.get("TTD_K8S_JOB_NAME")
        subdomain = os.environ.get("TTD_K8S_SUBDOMAIN")
        if not (job and subdomain):
            raise ValueError(
                "Kubernetes cluster env (JOB_COMPLETION_INDEX + "
                "TTD_K8S_REPLICAS) needs a coordinator: set "
                "TTD_K8S_COORDINATOR, or TTD_K8S_JOB_NAME + "
                "TTD_K8S_SUBDOMAIN for the <job>-0.<subdomain> headless-"
                "service convention")
        coord = f"{job}-0.{subdomain}:{_DEFAULT_PORT}"
    return DistributedConfig(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(idx),
        source="env:kubernetes",
    )


def _from_gce_metadata() -> Optional[DistributedConfig]:
    """GCE instance-group resolution (reference ``GCEClusterResolver``).

    The reference asks the GCE metadata server for the instance group's
    members per resolve; here a boot-time script does that fetch ONCE and
    injects the result as ``TTD_GCE_METADATA`` — inline JSON or ``@/path``
    to a JSON file — of the shape::

        {"instances": ["host-a", "host-b", ...],   # group members, ordered
         "self": "host-b",                         # this VM's name
         "port": 8476}                             # optional

    Resolution is pure env/file parsing: no egress, fully unit-testable.
    """
    raw = os.environ.get("TTD_GCE_METADATA")
    if not raw:
        return None
    try:
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        meta = json.loads(raw)
        instances = list(meta["instances"])
        self_name = meta["self"]
        port = int(meta.get("port", _DEFAULT_PORT))
        process_id = instances.index(self_name)
    except (json.JSONDecodeError, KeyError, ValueError, TypeError,
            OSError) as e:
        raise ValueError(
            f"Malformed TTD_GCE_METADATA (need a JSON object with an "
            f"instances list containing self, or @path to one): {e}") from e
    return DistributedConfig(
        coordinator_address=f"{instances[0]}:{port}",
        num_processes=len(instances),
        process_id=process_id,
        source="env:gce_metadata",
    )


def resolve_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> DistributedConfig:
    """Resolve this process's cluster position (see module docstring order)."""
    if any(v is not None for v in (coordinator_address, num_processes, process_id)):
        nproc = 1 if num_processes is None else num_processes
        pid = process_id or 0
        if not 0 <= pid < nproc:
            raise ValueError(
                f"process_id={pid} out of range for num_processes={nproc}; "
                "pass num_processes alongside process_id"
            )
        return DistributedConfig(
            coordinator_address=coordinator_address,
            num_processes=nproc,
            process_id=pid,
            source="explicit",
        )
    for probe in (_from_env_native, _from_tf_config, _from_slurm,
                  _from_kubernetes, _from_gce_metadata):
        cfg = probe()
        if cfg is not None:
            return cfg
    return DistributedConfig()


_initialized = False

#: Seconds a collective may wait on a peer before the job fails (c10d's
#: default is 30 minutes; a dead rank should end its peers sooner).
#: ``TTD_DIST_TIMEOUT`` overrides it.
DEFAULT_TIMEOUT_S = 600.0


def _split_address(address: str) -> tuple[str, int]:
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        return address, _DEFAULT_PORT
    return host.strip("[]") or "127.0.0.1", int(port)


def initialize_distributed(config: Optional[DistributedConfig] = None, *,
                           device: str = "cpu",
                           timeout_s: Optional[float] = None
                           ) -> DistributedConfig:
    """Join the job's process group, once.

    ``device`` "cuda" (or "cuda:N") picks ``nccl`` bound to the rank's
    card (``cuda:<process_id % cards>`` unless an index is given), "cpu"
    picks ``gloo``.  The store is a TCP store at the coordinator
    address, hosted by process 0.  A config of one process with no
    coordinator address joins nothing."""
    global _initialized
    import datetime

    import torch
    import torch.distributed as dist

    cfg = config or resolve_cluster()
    if _initialized or dist.is_initialized():
        return cfg
    if not cfg.is_multiprocess and not cfg.coordinator_address:
        return cfg
    if not cfg.coordinator_address:
        raise ValueError(
            f"{cfg.num_processes} processes need a coordinator address "
            "(--coordinator-address host:port, TTD_COORDINATOR, TF_CONFIG, "
            "Slurm, Kubernetes or GCE metadata)")
    if timeout_s is None:
        timeout_s = float(os.environ.get("TTD_DIST_TIMEOUT",
                                         DEFAULT_TIMEOUT_S))
    timeout = datetime.timedelta(seconds=timeout_s)
    host, port = _split_address(cfg.coordinator_address)
    store = dist.TCPStore(host, port, cfg.num_processes,
                          is_master=cfg.process_id == 0, timeout=timeout)
    kwargs = {}
    dev = torch.device(device)
    if dev.type == "cuda":
        backend = "nccl"
        index = (dev.index if dev.index is not None
                 else cfg.process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    else:
        backend = "gloo"
    dist.init_process_group(backend, store=store, rank=cfg.process_id,
                            world_size=cfg.num_processes, timeout=timeout,
                            **kwargs)
    _initialized = True
    logger.info("torch.distributed (%s) initialized: process %d/%d via %s "
                "(source=%s)", backend, cfg.process_id, cfg.num_processes,
                cfg.coordinator_address, cfg.source)
    return cfg


def shutdown_distributed() -> None:
    """Leave the process group ``initialize_distributed`` joined (a
    launcher run in a longer-lived process joins afresh next time)."""
    global _initialized
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
