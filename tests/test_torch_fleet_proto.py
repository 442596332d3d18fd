"""The port's fleet frame protocol (``server.proto``) against the JAX
package's, byte for byte.

A port worker and a JAX gateway (or the reverse) must read each other's
frames: every frame type is encoded by both packages from the same dict
and the bytes compared (the length prefix, the type byte, the JSON key
order and separators), then each package's bytes are decoded by the other
package's reader.  The binary frames (KV_HANDOFF, MIGRATE) carry a real
export of the port's engine (a prefix's KV rows, a live lane), so the
binary KV layout is held too.  The hardening errors (oversized prefix,
truncated frame, unknown version) read the same in both.
"""

import io
import struct

import numpy as np
import pytest
import torch

from tensorflow_train_distributed_tpu.server import proto as jproto
from tensorflow_train_distributed_torch.server import proto as tproto
from tensorflow_train_distributed_torch.server.worker import (
    engine_info,
    llama_params,
)
from tensorflow_train_distributed_torch.serving import ServingEngine

PACKAGES = {"jax": jproto, "port": tproto}

#: One realistic body per JSON frame type (nested dicts, lists, floats,
#: None, unicode), as the pool and the workers send them.
BODIES = {
    "HELLO": {"proto": 1, "pid": 4242, "replica": 0, "role": "decode",
              "mono": 123.456789,
              "engine": {"slots": 8, "kv_block_size": 16,
                         "cache_len": 1024, "paged": True,
                         "pool_blocks": 512, "buckets": [32, 64, 128],
                         "hbm_budget_bytes": None,
                         "hbm_autosized_bytes": 0}},
    "SUBMIT": {"id": 17, "prompt": [1, 2, 3, 250], "max_new": 32,
               "seed": None, "timeout_s": 12.5, "resume_from": 3},
    "CHUNK": {"id": 17, "toks": [5, 9, 11], "granted_ago": 0.012345},
    "RETIRE": {"id": 17, "status": "expired",
               "error": "deadline 12.5 s exceeded — freed"},
    "CANCEL": {"id": 17},
    "DRAIN": {},
    "STATS": {"queue_depth": 2, "active_slots": 7, "steps": 901,
              "step_elapsed": 0.0, "rss_bytes": 123456789,
              "gauges": {"kv_blocks_in_use": 40, "overlap_ratio": 0.75,
                         "hbm_by_pool": {"kv_pool": 1.5e9}},
              "events": [["decode/chunk", "X", 1.0, 0.25, 3,
                          {"rid": 17}]], "events_dropped": 0},
    "BYE": {},
    "DIED": {"error": "RuntimeError('CUDA error: an illegal memory "
                      "access')"},
    "PREFILL": {"id": 3, "tokens": list(range(40))},
    "KV_ACK": {"id": 3, "n": 0, "error": "nothing exportable"},
    "PING": {"id": 9, "t": 77.5},
    "PONG": {"id": 9, "t": 77.5, "mono": 1234.5},
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_json_frames_byte_for_byte_both_ways(name):
    ftype = getattr(tproto, name)
    assert ftype == getattr(jproto, name)
    body = BODIES[name]
    jb, tb = jproto.encode_frame(ftype, body), tproto.encode_frame(
        ftype, body)
    assert tb == jb
    for reader, raw in ((jproto, tb), (tproto, jb)):
        got = reader.read_frame(io.BytesIO(raw))
        assert got == (ftype, body)


def test_frame_tables_and_constants_match():
    for const in ("PROTO_VERSION", "MAX_FRAME_BYTES", "MIGRATE_VERSION",
                  "BLOB_KEY", "FRAME_NAMES", "BINARY_FRAMES"):
        assert getattr(tproto, const) == getattr(jproto, const), const
    assert set(BODIES) | {"KV_HANDOFF", "MIGRATE"} == set(
        tproto.FRAME_NAMES.values())


@pytest.fixture(scope="module")
def engine_exports():
    """A prefix export (KV_HANDOFF's payload) and a live-lane export
    (MIGRATE's), on f32 and int8 pools of the port's llama_tiny."""
    import dataclasses

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg, params = llama_params("llama_tiny", 0, "cpu")
    out = {}
    for int8 in (False, True):
        c = dataclasses.replace(cfg, kv_cache_int8=int8)
        eng = ServingEngine(c, params, slots=2, cache_len=64, chunk=4,
                            prompt_buckets=(8, 16, 32), device="cpu")
        prefix = eng.export_prefix_kv(list(range(3, 27)))
        rid = eng.submit(list(range(30, 51)), 20)
        eng.serve_step()
        eng.serve_step()
        lane = eng.export_lane(rid)
        out["int8" if int8 else "f32"] = (prefix, lane, engine_info(eng))
    torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("frame", ["KV_HANDOFF", "MIGRATE"])
def test_binary_frames_byte_for_byte_both_ways(engine_exports, pool,
                                               frame):
    prefix, lane, _ = engine_exports[pool]
    meta, blob = prefix if frame == "KV_HANDOFF" else lane
    assert blob, "export without rows"
    header = dict(meta, id=5)
    if frame == "MIGRATE":
        header["v"] = tproto.MIGRATE_VERSION
    ftype = getattr(tproto, frame)
    jb = jproto.encode_binary_frame(ftype, header, blob)
    tb = tproto.encode_binary_frame(ftype, header, blob)
    assert tb == jb
    for reader, raw in ((jproto, tb), (tproto, jb)):
        ft, body = reader.read_frame(io.BytesIO(raw))
        assert ft == ftype
        got_blob = body.pop(tproto.BLOB_KEY)
        assert got_blob == blob
        assert body == header
    # The rows are laid out as the manifest says, leaf after leaf.
    sizes = [int(np.prod(leaf["shape"])) * np.dtype(leaf["dtype"]).itemsize
             for leaf in (meta["leaves"] if frame == "KV_HANDOFF"
                          else meta["kv"]["leaves"])]
    assert sum(sizes) == len(blob)


def test_hello_from_a_port_engine_passes_both_checks(engine_exports):
    info = engine_exports["f32"][2]
    body = dict(BODIES["HELLO"], engine=info)
    raw = tproto.encode_frame(tproto.HELLO, body)
    for pkg in PACKAGES.values():
        ftype, got = pkg.read_frame(io.BytesIO(raw))
        assert pkg.check_hello(ftype, got) == jproto.check_hello(ftype,
                                                                 got)


@pytest.mark.parametrize("case", ["oversize", "truncated", "empty",
                                  "garbage", "badversion", "unknown_type"])
def test_hardening_errors_read_the_same(case):
    """Each package refuses the same broken bytes with the same
    message."""
    if case == "oversize":
        raw = struct.pack("!I", (1 << 31) - 1) + b"\x00" * 8
    elif case == "truncated":
        raw = struct.pack("!I", 4096) + b"\x07" + b"x" * 9
    elif case == "empty":
        raw = struct.pack("!I", 0)
    elif case == "garbage":
        payload = b"\x01\xff\xfe not json"
        raw = struct.pack("!I", len(payload)) + payload
    elif case == "badversion":
        raw = jproto.encode_frame(jproto.HELLO, {"proto": 999, "pid": 1})
    else:
        payload = b"\x63" + b'{"a": 1}'
        raw = struct.pack("!I", len(payload)) + payload
    outcomes = []
    for pkg in (jproto, tproto):
        try:
            ftype, body = pkg.read_frame(io.BytesIO(raw))
            if case == "badversion":
                pkg.check_hello(ftype, body)
            outcomes.append(("ok", ftype, body))
        except pkg.ProtocolError as e:
            outcomes.append(("refused", str(e)))
    assert outcomes[0] == outcomes[1]
    if case in ("oversize", "truncated", "garbage", "badversion"):
        assert outcomes[1][0] == "refused"


@pytest.mark.parametrize("bound", [64, 4 << 20])
def test_frame_sender_honors_the_bound_alike(bound):
    """Both senders refuse a frame past the bound without writing a byte
    and send the rest identically."""
    big = {"toks": list(range(200))}
    small = {"id": 1}
    outs = []
    for pkg in (jproto, tproto):
        buf = io.BytesIO()
        s = pkg.FrameSender(buf, bound)
        r = (s.send(pkg.CHUNK, big), s.send(pkg.CHUNK, small),
             s.send_binary(pkg.KV_HANDOFF, {"id": 1}, b"\x01" * 100))
        outs.append((r, buf.getvalue()))
    assert outs[0] == outs[1]
