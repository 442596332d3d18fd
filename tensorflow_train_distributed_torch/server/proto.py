"""Length-prefixed frame protocol between the gateway and its
subprocess replica workers.

One frame = a 4-byte big-endian unsigned payload length, then the
payload: 1 type byte + a UTF-8 JSON object.  The length prefix is the
whole framing story — no delimiters in the payload, no resync
heuristics: a reader either gets a complete frame or a
``ProtocolError``, and a bounded ``max_frame`` means a corrupt or
hostile length prefix can never make the parent allocate or block on
an unbounded read.  JSON bodies keep every frame printable in a log
line while the framing itself stays binary (token-id lists are small;
the one exception is ``KV_HANDOFF``, the reserved binary payload type:
its payload is ``type byte + 4-byte header length + JSON header + raw
row bytes``, so quantized KV pool rows ship verbatim without a base64
detour — the JSON header still makes the frame log-printable).

The stream is VERSIONED at the hello: the worker's first frame is
``HELLO`` carrying ``proto=PROTO_VERSION`` plus the engine's static
shape (slots, cache_len, paged-pool geometry) — a parent that sees any
other version (or any other first frame) fails that one replica with a
classified ``ProtocolError`` instead of guessing at field meanings.

Frame types (direction):

- ``HELLO``   worker → parent: version, pid, engine info, clock anchor.
- ``SUBMIT``  parent → worker: request id, prompt, max_new, seed,
  deadline, ``resume_from`` (the failover re-admission contract rides
  the protocol unchanged — the resumed tail is part of the prompt).
- ``CHUNK``   worker → parent: newly committed generated tokens.
- ``RETIRE``  worker → parent: terminal status
  (``ok|expired|invalid|error``) + error text.
- ``CANCEL``  parent → worker: collapse one request's deadline
  (streaming client went away).
- ``DRAIN``   parent → worker: stop admitting, finish in-flight, send
  ``BYE``, exit.
- ``STATS``   worker → parent: the heartbeat — queue/slot occupancy,
  kv gauges, rss bytes, step progress (the hung-dispatch watchdog's
  feed), and a batch of relayed flight-recorder events.
- ``BYE``     worker → parent: drain complete, exiting cleanly.
- ``DIED``    worker → parent: the worker's driver loop died with
  error propagation (the corpse the parent's ``failure()`` reports).
- ``PREFILL`` parent → prefill worker: run the staged per-piece
  prefill for one prompt and export the finished KV (disaggregated
  serving — the worker answers with a ``KV_HANDOFF`` or a ``KV_ACK``
  carrying the refusal).
- ``KV_HANDOFF``  the binary frame, both directions: prefill worker →
  parent carries the exported block rows; parent → decode worker
  carries the same bytes for installation.  Header keys: request id,
  token ids, leaf manifest (path/dtype/shape per pool leaf); the blob
  is the concatenated row bytes, bit-identical to the pool contents.
- ``KV_ACK``  worker → parent: terminal answer to ``PREFILL`` (export
  refused) or ``KV_HANDOFF`` (rows installed / install skipped), with
  the matched-token count so routing knows how warm the prefix is.
- ``MIGRATE``  the second binary frame, both directions: live
  mid-stream request migration.  A header with ``op="export"`` (empty
  blob) asks the worker to serialize one live lane — KV block rows
  (the exact ``KV_HANDOFF`` byte recipe), generated-token history,
  rng counter, staged-prefill cursor — which comes back as a MIGRATE
  whose header is the lane manifest and whose blob is the row bytes;
  the parent forwards that frame to the target worker (``op`` absent)
  for installation, answered by a ``KV_ACK`` with the warm-token
  count.  Every header carries ``v=MIGRATE_VERSION``: a mismatch is a
  classified ``ProtocolError`` that fails ONE replica, and a worker
  that predates the frame ignores it (the exchange times out into the
  resume-from-token failover fallback — no migration is ever
  load-bearing for correctness).
- ``PING``  parent → worker / ``PONG``  worker → parent: the NTP-style
  clock-sync exchange.  A PING carries the parent's monotonic send
  stamp ``t``; the worker echoes it back in a PONG together with its
  own monotonic ``mono`` stamped at the reply.  The parent computes
  ``rtt = t_recv - t`` and the midpoint offset estimate
  ``(t + t_recv)/2 - mono`` whose error is bounded by ``rtt/2`` —
  min-RTT samples replace the HELLO's one-way offset guess, which
  silently absorbs the full transport latency.  Both frames are
  stateless (the worker keeps nothing, the parent needs no pending
  table) and OPTIONAL: a worker that predates them ignores PING, the
  parent keeps the HELLO offset — no version bump.

Everything here is pure framing — no sockets are owned, no threads
are spawned: ``read_frame``/``write_frame`` work over any file-like
byte stream (the pool uses a ``socketpair`` so a stray ``print`` in
the child can never corrupt the stream the way stdout piping would),
and ``FrameSender`` is the one locked writer both sides share so
frames from concurrent threads never interleave mid-frame.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Optional, Tuple

#: Bumped whenever a frame's meaning changes; the HELLO handshake
#: refuses mismatches (a half-upgraded fleet must fail one replica
#: loudly, not misparse frames quietly).
PROTO_VERSION = 1

#: Per-frame payload bound: bigger than any real frame (token chunks
#: are tens of ids; stats batches are capped) by orders of magnitude,
#: small enough that a corrupt length prefix cannot balloon a read.
MAX_FRAME_BYTES = 4 << 20

_HEADER = struct.Struct("!I")

# Frame type bytes.
HELLO = 1
SUBMIT = 2
CHUNK = 3
RETIRE = 4
CANCEL = 5
DRAIN = 6
STATS = 7
BYE = 8
DIED = 9
PREFILL = 10
KV_HANDOFF = 11
KV_ACK = 12
MIGRATE = 13
PING = 14
PONG = 15

FRAME_NAMES = {
    HELLO: "HELLO", SUBMIT: "SUBMIT", CHUNK: "CHUNK", RETIRE: "RETIRE",
    CANCEL: "CANCEL", DRAIN: "DRAIN", STATS: "STATS", BYE: "BYE",
    DIED: "DIED", PREFILL: "PREFILL", KV_HANDOFF: "KV_HANDOFF",
    KV_ACK: "KV_ACK", MIGRATE: "MIGRATE", PING: "PING", PONG: "PONG",
}

#: Frame types whose payload is ``type byte + 4-byte header length +
#: JSON header + raw bytes`` instead of pure JSON.  ``read_frame``
#: surfaces the raw bytes under the reserved body key ``"blob"``.
BINARY_FRAMES = frozenset({KV_HANDOFF, MIGRATE})

#: MIGRATE manifest version, carried as ``v`` in every MIGRATE header
#: (requests AND payloads).  Orthogonal to ``PROTO_VERSION``: the lane
#: manifest can evolve (new state fields) without re-versioning the
#: whole stream, but a mismatched manifest must still fail ONE replica
#: loudly — installing a misread lane would corrupt a live stream,
#: which is strictly worse than the failover fallback.
MIGRATE_VERSION = 1

#: The body key binary frames deliver their raw bytes under (reserved:
#: a JSON header may not use it).
BLOB_KEY = "blob"


class ProtocolError(RuntimeError):
    """The frame stream is unusable (truncated frame, oversized length
    prefix, non-JSON payload, version mismatch).  Always fails exactly
    ONE replica: the parent classifies the reason into that replica's
    health state and SIGKILLs the worker — it never propagates past
    the replica boundary."""


def encode_frame(ftype: int, body: dict,
                 max_frame: int = MAX_FRAME_BYTES) -> bytes:
    """One wire-ready frame: header + type byte + compact JSON."""
    if ftype in BINARY_FRAMES:
        raise ProtocolError(
            f"{FRAME_NAMES.get(ftype, ftype)} is a binary frame type; "
            "encode it with encode_binary_frame (a JSON-encoded body "
            "would be mis-parsed as a binary layout on the far side)")
    payload = bytes([ftype]) + json.dumps(
        body, separators=(",", ":")).encode()
    if len(payload) > max_frame:
        raise ProtocolError(
            f"outgoing {FRAME_NAMES.get(ftype, ftype)} frame of "
            f"{len(payload)} bytes exceeds the {max_frame}-byte bound")
    return _HEADER.pack(len(payload)) + payload


def encode_binary_frame(ftype: int, header: dict, blob: bytes,
                        max_frame: int = MAX_FRAME_BYTES) -> bytes:
    """One wire-ready BINARY frame: length prefix + type byte + 4-byte
    big-endian JSON-header length + compact JSON header + raw blob.
    The blob rides verbatim — no base64, no escaping — so pool rows
    arrive bit-identical; the same ``max_frame`` bound applies to the
    whole payload (a handoff bigger than the bound is refused on the
    sending side, degrading that request to local prefill)."""
    if ftype not in BINARY_FRAMES:
        raise ProtocolError(
            f"{FRAME_NAMES.get(ftype, ftype)} is not a binary frame "
            f"type")
    if BLOB_KEY in header:
        raise ProtocolError(
            f"binary frame header may not use the reserved "
            f"{BLOB_KEY!r} key")
    hdr = json.dumps(header, separators=(",", ":")).encode()
    payload_len = 1 + _HEADER.size + len(hdr) + len(blob)
    if payload_len > max_frame:
        raise ProtocolError(
            f"outgoing {FRAME_NAMES.get(ftype, ftype)} frame of "
            f"{payload_len} bytes exceeds the {max_frame}-byte bound")
    return (_HEADER.pack(payload_len) + bytes([ftype])
            + _HEADER.pack(len(hdr)) + hdr + blob)


def write_frame(fp, ftype: int, body: dict,
                max_frame: int = MAX_FRAME_BYTES) -> None:
    """Write one frame and flush (callers serialize writers with their
    own lock — frames from concurrent relay threads must not
    interleave mid-frame)."""
    fp.write(encode_frame(ftype, body, max_frame))
    fp.flush()


class FrameSender:
    """Locked frame writer shared by every sending thread on one side
    of the stream (reader loop, per-request relays, stats heartbeat —
    or the parent driver's submitters): ONE lock so concurrent frames
    never interleave mid-frame.  A dead peer (EPIPE, torn socket)
    flips ``gone`` and returns False instead of killing the calling
    thread; an OVERSIZED outgoing frame also returns False but does
    NOT poison the stream (nothing was written) — callers that can
    answer a client distinguish it by pre-encoding with
    ``encode_frame`` themselves."""

    def __init__(self, fp, max_frame: int = MAX_FRAME_BYTES):
        self._fp = fp
        self._max_frame = max_frame
        self._lock = threading.Lock()
        self.gone = False

    def send_frame(self, frame: bytes) -> bool:
        """Write one pre-encoded frame atomically."""
        with self._lock:
            if self.gone:
                return False
            try:
                self._fp.write(frame)
                self._fp.flush()
                return True
            except (OSError, ValueError):
                self.gone = True
                return False

    def send(self, ftype: int, body: dict) -> bool:
        try:
            frame = encode_frame(ftype, body, self._max_frame)
        except ProtocolError:
            return False
        return self.send_frame(frame)

    def send_binary(self, ftype: int, header: dict, blob: bytes) -> bool:
        """Binary-frame analog of ``send``: oversized payloads return
        False without poisoning the stream (nothing was written)."""
        try:
            frame = encode_binary_frame(ftype, header, blob,
                                        self._max_frame)
        except ProtocolError:
            return False
        return self.send_frame(frame)


def _read_exact(fp, n: int) -> bytes:
    """Exactly ``n`` bytes, or everything the stream had left (the
    caller distinguishes clean EOF from a mid-frame death)."""
    chunks = []
    got = 0
    while got < n:
        b = fp.read(n - got)
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def read_frame(fp, max_frame: int = MAX_FRAME_BYTES
               ) -> Optional[Tuple[int, dict]]:
    """Read one complete frame: ``(type, body)``, or ``None`` on clean
    EOF (stream closed exactly on a frame boundary — the normal end of
    a drained worker).  Everything else raises ``ProtocolError``:

    - a length prefix beyond ``max_frame`` fails WITHOUT reading the
      body (the bounded-read contract — a corrupt prefix cannot make
      the reader allocate or wait for gigabytes);
    - EOF inside the header or the payload is a mid-frame death
      (SIGKILLed worker, torn pipe);
    - a payload that is not ``type byte + JSON object`` is garbage.
    """
    header = _read_exact(fp, _HEADER.size)
    if not header:
        return None
    if len(header) < _HEADER.size:
        raise ProtocolError(
            f"stream died mid-frame: {len(header)} of "
            f"{_HEADER.size} header bytes")
    (n,) = _HEADER.unpack(header)
    if n < 1:
        raise ProtocolError("empty frame (length prefix 0)")
    if n > max_frame:
        raise ProtocolError(
            f"oversized length prefix: {n} bytes exceeds the "
            f"{max_frame}-byte frame bound (refusing the read)")
    payload = _read_exact(fp, n)
    if len(payload) < n:
        raise ProtocolError(
            f"stream died mid-frame: {len(payload)} of {n} "
            f"payload bytes")
    ftype = payload[0]
    if ftype in BINARY_FRAMES:
        # type byte + 4-byte header length + JSON header + raw blob;
        # the blob is delivered under the reserved "blob" body key.
        if len(payload) < 1 + _HEADER.size:
            raise ProtocolError(
                f"binary frame too short for its header length "
                f"({len(payload)} bytes)")
        (hn,) = _HEADER.unpack(payload[1:1 + _HEADER.size])
        hdr_end = 1 + _HEADER.size + hn
        if hdr_end > len(payload):
            raise ProtocolError(
                f"binary frame header length {hn} exceeds the "
                f"{len(payload)}-byte payload")
        try:
            body = json.loads(payload[1 + _HEADER.size:hdr_end].decode())
        except (UnicodeDecodeError, ValueError) as e:
            raise ProtocolError(
                f"binary frame header is not JSON "
                f"(type byte {ftype}): {e}") from None
        if not isinstance(body, dict):
            raise ProtocolError(
                f"binary frame header must be a JSON object, got "
                f"{type(body).__name__}")
        body[BLOB_KEY] = payload[hdr_end:]
        return ftype, body
    try:
        body = json.loads(payload[1:].decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise ProtocolError(
            f"frame payload is not JSON "
            f"(type byte {ftype}): {e}") from None
    if not isinstance(body, dict):
        raise ProtocolError(
            f"frame body must be a JSON object, got "
            f"{type(body).__name__}")
    return ftype, body


def check_hello(ftype: int, body: dict) -> dict:
    """Validate the handshake frame; returns the body.  The FIRST
    frame must be a current-version HELLO — anything else means the
    two sides do not speak the same protocol and every later frame
    would be misparsed."""
    if ftype != HELLO:
        raise ProtocolError(
            f"expected HELLO as the first frame, got "
            f"{FRAME_NAMES.get(ftype, ftype)}")
    got = body.get("proto")
    if got != PROTO_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: worker speaks {got!r}, "
            f"parent speaks {PROTO_VERSION}")
    return body
