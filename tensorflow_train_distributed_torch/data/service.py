"""Out-of-process input workers: the tf.data service on one host (the
counterpart of the JAX package's ``data/service.py``).

``DataServiceDispatcher`` spawns N worker processes; worker w of host h
runs a ``HostDataLoader`` as process ``h*N + w`` of ``H*N`` and serves
its slice of every batch over a local TCP socket.  ``DataServiceClient``
asks every worker for its next slice, reads the replies and concatenates
them in worker order into this host's batch, so the trainer sees what a
loader of ``global_batch_size / host_count`` rows would give (the rows
come from the workers' shards instead of this host's stride).

The frame is the JAX package's, byte for byte: a little-endian u64
length and a JSON header, then a u64 length and the raw buffers (one
per array, in sorted key order, each described in the header by name,
dtype string, shape, offset and size).  No pickle crosses the socket.

Workers are started with the ``spawn`` context, so a parent that already
holds a CUDA context is never forked; a worker imports torch on the CPU
(the port's data modules import it) but builds numpy batches only and
never touches the card.  A worker that dies mid-run closes its socket,
and the client raises ``ConnectionError``: the trainer fails, it never
falls back to reading in-process.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import queue as queue_lib
import socket
import struct
from typing import Iterator

import numpy as np

from tensorflow_train_distributed_torch.data.pipeline import DataConfig

_LEN = struct.Struct("<Q")
# Seconds a worker may take to build its source and report its port.
STARTUP_TIMEOUT_S = 60.0


def _send_frame(sock: socket.socket, header: dict, payload: bytes = b""):
    hdr = json.dumps(header).encode()
    sock.sendall(_LEN.pack(len(hdr)) + hdr + _LEN.pack(len(payload)))
    if payload:     # the same bytes, without copying the payload again
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("input worker closed the connection")
        got += k
    return buf


def _recv_frame(sock: socket.socket) -> tuple[dict, bytearray]:
    hdr_len = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    header = json.loads(_recv_exact(sock, hdr_len))
    pay_len = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    return header, _recv_exact(sock, pay_len) if pay_len else b""


def _encode_batch(batch: dict[str, np.ndarray]) -> tuple[dict, bytes]:
    fields, chunks, offset = [], [], 0
    for name in sorted(batch):
        arr = np.ascontiguousarray(batch[name])
        fields.append({"name": name, "dtype": arr.dtype.str,
                       "shape": arr.shape, "offset": offset,
                       "nbytes": arr.nbytes})
        chunks.append(arr.tobytes())
        offset += arr.nbytes
    return {"kind": "batch", "fields": fields}, b"".join(chunks)


def _decode_batch(header: dict, payload) -> dict[str, np.ndarray]:
    # Views into the received buffer: the client's concatenation copies
    # them once.
    return {f["name"]: np.frombuffer(
                payload, dtype=np.dtype(f["dtype"]), count=int(np.prod(
                    f["shape"], dtype=np.int64)), offset=f["offset"])
            .reshape(f["shape"]) for f in header["fields"]}


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """Picklable description of a dataset: a ``datasets.get_dataset``
    name and its keyword arguments."""

    dataset: str
    kwargs: dict = dataclasses.field(default_factory=dict)

    def build(self):
        from tensorflow_train_distributed_torch.data.datasets import (
            get_dataset,
        )

        return get_dataset(self.dataset, **self.kwargs)


def _worker_main(spec: SourceSpec, config: DataConfig, shard_index: int,
                 shard_count: int, port_queue):
    """Worker process: serve this shard's batches over a local socket."""
    from tensorflow_train_distributed_torch.data.pipeline import (
        HostDataLoader,
    )

    loader = HostDataLoader(spec.build(), config, process_index=shard_index,
                            process_count=shard_count)
    server = socket.socket()
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    port_queue.put(server.getsockname()[1])
    conn, _ = server.accept()
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    it = iter(loader)
    try:
        while True:
            header, _ = _recv_frame(conn)
            cmd = header.get("cmd")
            if cmd == "NEXT":
                try:
                    batch = next(it)
                except StopIteration:
                    _send_frame(conn, {"kind": "end"})
                    continue
                _send_frame(conn, *_encode_batch(batch))
            elif cmd == "STOP":
                _send_frame(conn, {"kind": "bye"})
                return
            else:
                _send_frame(conn, {"kind": "error",
                                   "message": f"unknown cmd {cmd!r}"})
    except (ConnectionError, BrokenPipeError):
        pass
    finally:
        conn.close()
        server.close()


class DataServiceDispatcher:
    """Owns this host's worker fleet and hands out a connected client.

    Each of ``num_workers`` workers serves ``global_batch_size /
    (host_count * num_workers)`` rows a step; worker w of host h reads
    the corpus as process ``h*W + w`` of ``H*W``, so the fleets of all
    hosts cover each epoch once and every host draws the same number of
    batches."""

    def __init__(self, spec: SourceSpec, config: DataConfig,
                 num_workers: int = 2, *, host_index: int = 0,
                 host_count: int = 1):
        shards = host_count * num_workers
        if config.global_batch_size % shards:
            raise ValueError(
                f"global_batch_size={config.global_batch_size} not "
                f"divisible by host_count*num_workers={shards}")
        if not 0 <= host_index < host_count:
            raise ValueError(
                f"host_index={host_index} outside [0, {host_count})")
        self.spec = spec
        self.config = config
        self.num_workers = num_workers
        self.host_index = host_index
        self.host_count = host_count
        self._procs: list = []
        self.ports: list[int] = []

    def start(self) -> "DataServiceDispatcher":
        ctx = mp.get_context("spawn")   # never fork a live CUDA context
        queues = [ctx.Queue() for _ in range(self.num_workers)]
        for w in range(self.num_workers):
            p = ctx.Process(
                target=_worker_main,
                args=(self.spec, self.config,
                      self.host_index * self.num_workers + w,
                      self.host_count * self.num_workers, queues[w]),
                daemon=True)
            p.start()
            self._procs.append(p)
        self.ports = []
        for w, (q, p) in enumerate(zip(queues, self._procs)):
            # Poll liveness while waiting: a worker that fails to build
            # its source raises here, not after the whole timeout.
            waited = 0.0
            while True:
                try:
                    self.ports.append(q.get(timeout=0.5))
                    break
                except queue_lib.Empty:
                    waited += 0.5
                    if not p.is_alive():
                        rc = p.exitcode
                        self.stop()
                        raise RuntimeError(
                            f"input worker {w} died during startup (exit "
                            f"code {rc}): bad SourceSpec or DataConfig?"
                        ) from None
                    if waited >= STARTUP_TIMEOUT_S:
                        self.stop()
                        raise TimeoutError(
                            f"input worker {w} did not report a port")
        return self

    def client(self) -> "DataServiceClient":
        return DataServiceClient(self.ports)

    def stop(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
        self._procs.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class DataServiceClient:
    """Iterates this host's batches, each the concatenation of its
    workers' slices in worker order.  Single use: the sockets close when
    iteration ends."""

    def __init__(self, ports: list[int], host: str = "127.0.0.1"):
        self._socks = []
        self._consumed = False
        for port in ports:
            s = socket.create_connection((host, port), timeout=60)
            # The timeout is for the connect: building a slice (decode,
            # augment) may take longer, so reads block without one.
            s.settimeout(None)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks.append(s)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        if self._consumed:
            raise RuntimeError(
                "DataServiceClient is single-use (its sockets close when "
                "iteration ends); call .client() on the dispatcher for a "
                "fresh iterator")
        self._consumed = True
        try:
            while True:
                # Ask every worker first, then read: the workers build
                # their slices concurrently.
                for s in self._socks:
                    _send_frame(s, {"cmd": "NEXT"})
                shards, ended = [], False
                for s in self._socks:
                    header, payload = _recv_frame(s)
                    if header["kind"] == "end":
                        ended = True
                    elif header["kind"] == "batch":
                        shards.append(_decode_batch(header, payload))
                    else:
                        raise RuntimeError(f"input worker error: {header}")
                if ended:
                    return
                yield {k: np.concatenate([sh[k] for sh in shards])
                       for k in shards[0]}
        finally:
            self.close()

    def close(self) -> None:
        for s in self._socks:
            try:
                _send_frame(s, {"cmd": "STOP"})
                s.close()
            except OSError:
                pass
        self._socks = []
