"""The port's dial-in serving fleet (``server.netpool``, ``serve_worker.py``).

The cases of JAX ``tests/test_netpool.py`` over the port's modules: the
binary KV_HANDOFF framing, and the ``NetPool`` over real TCP sockets on
loopback, where stub worker daemons dial in and serve with closed-form
parity, raw-socket peers speak deliberately broken bytes and fail exactly
one replica, a daemon SIGKILLed mid-stream reads "disconnected" and its
stream fails over token-equal, a live lane migrates between daemons, and
the re-dial counts against the restart budget.  The port's engine behind
the same transport, disaggregated, is ``tests/test_torch_disagg.py``.
"""

import io
import json
import os
import socket
import struct
import subprocess
import sys
import time

import pytest

from tensorflow_train_distributed_torch.server import proto
from tensorflow_train_distributed_torch.server.netpool import NetPool
from tensorflow_train_distributed_torch.server.replicas import NoReplicas
from tensorflow_train_distributed_torch.server.worker import (
    StubWorkerEngine,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_WORKER = ["-m", "tensorflow_train_distributed_torch.serve_worker"]
#: Dial-in workers run one torch thread (a fleet of full-width pools
#: oversubscribes the host under the parallel test run).
WORKER_ENV = dict(os.environ, OMP_NUM_THREADS="1")


# ── the binary KV_HANDOFF framing (pure functions) ─────────────────────


def test_binary_frame_roundtrip_blob_bit_identical():
    """The handoff contract: the blob crosses the wire VERBATIM (no
    base64, no escaping), the JSON header rides alongside, and the
    reader delivers the bytes under the reserved "blob" key."""
    header = {"id": 7, "tokens": [1, 2, 3], "n": 16,
              "leaves": [{"path": "key_cache", "dtype": "int8"}]}
    blob = bytes(range(256)) * 33            # every byte value, odd len
    frame = proto.encode_binary_frame(proto.KV_HANDOFF, header, blob)
    ftype, body = proto.read_frame(io.BytesIO(frame))
    assert ftype == proto.KV_HANDOFF
    assert body.pop(proto.BLOB_KEY) == blob
    assert body == header
    # An empty blob is a legal frame too (zero-block export).
    frame = proto.encode_binary_frame(proto.KV_HANDOFF, {"id": 1}, b"")
    _, body = proto.read_frame(io.BytesIO(frame))
    assert body[proto.BLOB_KEY] == b""


def test_binary_frame_hardening():
    with pytest.raises(proto.ProtocolError, match="not a binary"):
        proto.encode_binary_frame(proto.STATS, {}, b"x")
    with pytest.raises(proto.ProtocolError, match="reserved"):
        proto.encode_binary_frame(proto.KV_HANDOFF,
                                  {proto.BLOB_KEY: 1}, b"x")
    # A header length claiming more bytes than the payload holds.
    payload = (bytes([proto.KV_HANDOFF]) + struct.pack("!I", 4096)
               + b"{}")
    frame = struct.pack("!I", len(payload)) + payload
    with pytest.raises(proto.ProtocolError, match="header length"):
        proto.read_frame(io.BytesIO(frame))
    # A non-JSON header inside a well-framed binary payload.
    hdr = b"\xff\xfe nope"
    payload = (bytes([proto.KV_HANDOFF])
               + struct.pack("!I", len(hdr)) + hdr)
    frame = struct.pack("!I", len(payload)) + payload
    with pytest.raises(proto.ProtocolError, match="not JSON"):
        proto.read_frame(io.BytesIO(frame))


def test_oversized_handoff_refused_without_poisoning_the_stream():
    """An oversized outgoing KV_HANDOFF returns False with NOTHING
    written — the stream stays healthy and the worker degrades that
    one request to a local prefill (KV_ACK n=0), it never tears the
    replica down."""
    buf = io.BytesIO()
    sender = proto.FrameSender(buf, max_frame=256)
    assert not sender.send_binary(proto.KV_HANDOFF, {"id": 1},
                                  b"\x00" * 1024)
    assert not sender.gone
    assert buf.getvalue() == b""
    assert sender.send(proto.KV_ACK, {"id": 1, "n": 0})


# ── the TCP pool over dial-in stub daemons ─────────────────────────────


def _pool(scale_min=1, max_workers=4, **kw):
    kw.setdefault("watchdog_timeout_s", 10.0)
    kw.setdefault("monitor_poll_s", 0.02)
    return NetPool(host="127.0.0.1", port=0, scale_min=scale_min,
                   max_workers=max_workers, **kw).start()


def _worker(port, *, rid, role=None, spec=None, redials=8):
    cmd = [sys.executable, *SERVE_WORKER,
           "--dial", f"127.0.0.1:{port}", "--factory", "stub",
           "--replica-id", str(rid), "--redials", str(redials),
           "--redial-backoff", "0.1", "--stats-interval", "0.05"]
    if role:
        cmd += ["--role", role]
    if spec:
        cmd += ["--json", json.dumps(spec)]
    return subprocess.Popen(cmd, cwd=REPO_ROOT, env=WORKER_ENV,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _reap(procs, timeout=15):
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    return rcs


def _wait_dead(pool, n=1, timeout=15):
    deadline = time.monotonic() + timeout
    dead = []
    while time.monotonic() < deadline:
        dead = [s for s in pool.replica_states()
                if s["state"] == "dead" and s.get("reason")]
        if len(dead) >= n:
            return dead
        time.sleep(0.02)
    return dead


def test_dialin_fleet_serves_parity_and_drains_clean():
    """Two daemons dial in over real TCP, the pool routes with
    closed-form parity, /healthz-shaped state carries the transport
    facts (addr, tcp, worker pid), and a drain tells the daemons to
    EXIT (rc 0) instead of re-dialing their own scale-down."""
    pool = _pool(scale_min=2)
    procs = []
    try:
        procs = [_worker(pool.port, rid=i) for i in range(2)]
        assert pool.wait_ready(30)
        hs = [pool.submit([10 * (i + 1)], 3 + i % 4) for i in range(8)]
        for i, h in enumerate(hs):
            assert h.result(timeout=30) == StubWorkerEngine.expected(
                [10 * (i + 1)], 3 + i % 4)
        for s in pool.replica_states():
            assert s["state"] == "alive"
            assert s["transport"] == "tcp"
            assert s["addr"].startswith("127.0.0.1:")
            assert s["pid"] in [p.pid for p in procs]
        assert not pool.degraded()
    finally:
        assert pool.join(timeout=30)
    # DRAIN → BYE → exit 0: an orderly scale-down must not crash-loop
    # against the gateway's restart budget.
    assert _reap(procs) == [0, 0]


def test_hello_reassembled_across_recv_boundaries():
    """Framing owns reassembly: a valid HELLO dribbled one byte per
    send still parses into a ready replica — and the same peer
    closing WITHOUT a BYE is classified 'disconnected', the
    SIGKILL-across-hosts symptom."""
    pool = _pool(scale_min=1, max_workers=2)
    try:
        frame = proto.encode_frame(proto.HELLO, {
            "proto": proto.PROTO_VERSION, "pid": 12345,
            "replica": None, "role": "decode", "mono": 0.0,
            "engine": {"slots": 1, "kv_block_size": 16,
                       "cache_len": 64, "paged": False,
                       "pool_blocks": None, "buckets": None}})
        with socket.create_connection(("127.0.0.1", pool.port),
                                      timeout=10) as sock:
            for i in range(len(frame)):
                sock.sendall(frame[i:i + 1])
                if i % 8 == 0:
                    time.sleep(0.001)       # force tiny recv windows
            assert pool.wait_ready(10), "dribbled HELLO never parsed"
            states = pool.replica_states()
            assert states[0]["role"] == "decode"
            assert states[0]["pid"] == 12345
        # ...context exit = abrupt close, no BYE.
        dead = _wait_dead(pool)
        assert len(dead) == 1, dead
        assert dead[0]["failure_class"] == "disconnected"
        assert "no BYE" in dead[0]["reason"]
    finally:
        pool.join(timeout=30)


def _corrupt_bytes(mode):
    hello = proto.encode_frame(proto.HELLO, {
        "proto": proto.PROTO_VERSION, "pid": 1, "replica": None,
        "role": "prefill", "mono": 0.0, "engine": {"slots": 1}})
    if mode == "badversion":
        return proto.encode_frame(proto.HELLO, {"proto": 999, "pid": 1})
    if mode == "oversize":
        return struct.pack("!I", proto.MAX_FRAME_BYTES + 1) + b"\x00" * 64
    if mode == "garbage":
        payload = b"\x01\xff\xfe not json"
        return struct.pack("!I", len(payload)) + payload
    if mode == "truncate":
        return struct.pack("!I", 4096) + b"\x07" + b"x" * 9
    if mode == "midhandoff":
        # A healthy prefill-role HELLO, then death in the MIDDLE of a
        # binary KV_HANDOFF — a remote prefill worker torn down while
        # streaming rows.
        frame = proto.encode_binary_frame(
            proto.KV_HANDOFF,
            {"id": 1, "tokens": [1, 2], "n": 2, "leaves": []},
            b"\x00" * 4096)
        return hello + frame[:len(frame) // 2]
    if mode == "midmigrate":
        # A healthy hello, then EOF in the middle of a binary MIGRATE
        # payload — a source worker torn down while exporting a lane.
        frame = proto.encode_binary_frame(
            proto.MIGRATE,
            {"id": 1, "v": proto.MIGRATE_VERSION, "kind": "lane",
             "tokens": [1, 2], "remaining": 4, "last_token": 2,
             "seed": None, "count": 2, "done": False, "kv": None},
            b"\x00" * 4096)
        return hello + frame[:len(frame) // 2]
    raise AssertionError(mode)


@pytest.mark.parametrize("mode", ["badversion", "oversize", "garbage",
                                  "truncate", "midhandoff",
                                  "midmigrate"])
def test_hostile_peer_fails_one_replica_never_the_pool(mode):
    """Every hostile-peer failure mode over a REAL TCP socket — stale
    HELLO version, oversized length prefix from the remote side,
    garbage payload, frame truncated by a close, disconnect in the
    middle of a binary KV_HANDOFF — fails exactly the speaking
    replica with a classified ProtocolError while the healthy daemon
    keeps serving."""
    pool = _pool(scale_min=1, max_workers=4)
    procs = []
    try:
        procs = [_worker(pool.port, rid=0)]
        assert pool.wait_ready(30)
        with socket.create_connection(("127.0.0.1", pool.port),
                                      timeout=10) as sock:
            sock.sendall(_corrupt_bytes(mode))
            if mode in ("truncate", "midhandoff", "midmigrate"):
                sock.shutdown(socket.SHUT_WR)   # EOF mid-frame
            deadline = time.monotonic() + 15
            dead = []
            while time.monotonic() < deadline:
                dead = [s for s in pool.replica_states()
                        if s["state"] == "dead"]
                if dead:
                    break
                time.sleep(0.02)
        assert len(dead) == 1, f"{mode}: hostile peer not declared"
        assert dead[0]["failure_class"] == "protocol", dead[0]
        assert "ProtocolError" in dead[0]["reason"]
        # Never the pool: the healthy daemon still serves.
        assert pool.alive_count() == 1
        h = pool.submit([7], 4)
        assert h.result(timeout=30) == StubWorkerEngine.expected([7], 4)
    finally:
        pool.join(timeout=30)
        _reap(procs)


def test_sigkill_midstream_disconnect_failover_and_redial_respawn():
    """THE transport headline: a daemon SIGKILLed mid-stream is an
    EOF-without-BYE — classified 'disconnected', the stream fails
    over token-equal via resume-from-token, and the REPLACEMENT
    dial-in is the respawn: counted against the restart budget, then
    serving."""
    pool = _pool(scale_min=2, max_workers=4)
    procs = []
    try:
        procs = [_worker(pool.port, rid=i,
                         spec={"slots": 2, "step_delay": 0.05})
                 for i in range(2)]
        assert pool.wait_ready(30)
        h = pool.submit([5, 6, 7], 30, stream=True)
        it = h.iter_tokens()
        toks = list(next(it))               # placed and streaming
        victim = pool._requests[h.id].replica
        pid = next(s["pid"] for s in pool.replica_states()
                   if s["replica"] == victim.idx)
        next(p for p in procs if p.pid == pid).kill()
        for chunk in it:
            toks.extend(chunk)
        assert [5, 6, 7] + toks == StubWorkerEngine.expected(
            [5, 6, 7], 30)
        dead = _wait_dead(pool)
        assert len(dead) == 1
        assert dead[0]["failure_class"] == "disconnected"
        assert dead[0]["replica"] == victim.idx
        assert "no BYE" in dead[0]["reason"]
        assert pool.degraded()              # 1 usable < scale_min 2
        # The re-dial IS the respawn: counted, then serving.
        assert pool.restarts_total() == 0
        procs.append(_worker(pool.port, rid=2,
                             spec={"slots": 2, "step_delay": 0.05}))
        deadline = time.monotonic() + 20
        while pool.alive_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pool.alive_count() == 2
        assert pool.restarts_total() == 1
        assert not pool.degraded()
        h2 = pool.submit([42], 4)
        assert h2.result(timeout=30) == StubWorkerEngine.expected(
            [42], 4)
    finally:
        pool.join(timeout=30)
        _reap(procs)


def test_live_migration_over_tcp_bitwise():
    """A live lane crosses HOSTS: mid-stream ``pool.migrate`` exports
    the lane from one dial-in daemon and installs it on the other over
    real TCP MIGRATE frames, and the stream stays token-for-token
    equal to the closed form — no re-prefill, no gap."""
    pool = _pool(scale_min=2, max_workers=4)
    procs = []
    try:
        procs = [_worker(pool.port, rid=i,
                         spec={"slots": 2, "step_delay": 0.05})
                 for i in range(2)]
        assert pool.wait_ready(30)
        h = pool.submit([5, 6, 7], 30, stream=True)
        it = h.iter_tokens()
        toks = list(next(it))               # placed and streaming
        preq = pool._requests[h.id]
        src = preq.replica
        assert pool.migrate(h.id)
        for chunk in it:
            toks.extend(chunk)
        assert [5, 6, 7] + toks == StubWorkerEngine.expected(
            [5, 6, 7], 30)
        assert preq.migrations == 1
        assert preq.replica is not src
        # Nobody died for this: both daemons still serve.
        assert pool.alive_count() == 2
        h2 = pool.submit([42], 4)
        assert h2.result(timeout=30) == StubWorkerEngine.expected(
            [42], 4)
    finally:
        pool.join(timeout=30)
        _reap(procs)


def test_fleet_full_refuses_dialin():
    """Dial-ins beyond ``max_workers`` usable replicas are refused at
    accept: the connection closes before any frame is read and the
    fleet is untouched."""
    pool = _pool(scale_min=1, max_workers=1)
    procs = []
    try:
        procs = [_worker(pool.port, rid=0)]
        assert pool.wait_ready(30)
        with socket.create_connection(("127.0.0.1", pool.port),
                                      timeout=10) as sock:
            sock.settimeout(10)
            assert sock.recv(1) == b""      # refused: closed, no frame
        assert pool.alive_count() == 1
        assert len(pool.replicas) == 1
        h = pool.submit([3], 4)
        assert h.result(timeout=30) == StubWorkerEngine.expected([3], 4)
    finally:
        pool.join(timeout=30)
        _reap(procs)


def test_restart_budget_exhaustion_refuses_redials_and_placement():
    """With the re-dial budget spent, a dead fleet stops resurrecting:
    replacement dial-ins are refused at accept and placement fails
    NoReplicas instead of waiting for capacity that is never allowed
    back in."""
    pool = _pool(scale_min=1, max_workers=2, max_restarts=0)
    procs = []
    try:
        procs = [_worker(pool.port, rid=0)]
        assert pool.wait_ready(30)
        procs[0].kill()
        deadline = time.monotonic() + 15
        while pool.alive_count() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pool.alive_count() == 0
        # A re-dial would REPLACE dead capacity — a respawn with no
        # budget left, refused before reading a byte.
        with socket.create_connection(("127.0.0.1", pool.port),
                                      timeout=10) as sock:
            sock.settimeout(10)
            assert sock.recv(1) == b""
        assert pool.restarts_total() == 0
        assert len(pool.replicas) == 1      # the corpse, kept listed
        with pytest.raises(NoReplicas):
            pool.submit([1], 3)
    finally:
        pool.join(timeout=30)
        _reap(procs)
