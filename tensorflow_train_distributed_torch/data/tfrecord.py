"""TFRecord + tf.train.Example interop — read the reference's corpora
(a copy of the JAX package's ``data/tfrecord.py``, numpy only, with its
imports pointing into the port).

The reference's input pipelines read TFRecord files of ``tf.train.Example``
protos (the tf.data convention its builders assume, SURVEY.md §2.1/§3.5).
A reference user migrating here brings that data; this module reads and
writes it with **zero TensorFlow/protobuf dependency** — the framing
(length + masked crc32c) and the three-message Example schema are small
enough to implement directly:

- ``TFRecordWriter`` / ``read_records``: the on-wire framing
  (`uint64 length | crc(length) | payload | crc(payload)`, crc32c masked
  with the TF rotation constant).
- ``encode_example`` / ``decode_example``: hand-rolled proto codec for
  ``Example { Features { map<string, Feature> } }`` with
  BytesList/FloatList/Int64List (packed and unpacked accepted).
- ``TFRecordSource``: a ``RandomAccessSource`` over one or more ``.tfrecord``
  files — builds an offset index in one sequential pass (TFRecord itself is
  stream-oriented; the index restores the random access the SPMD input
  pipeline needs), then serves ``{field: np.ndarray}`` records through a
  ``FixedLenFeature``-style spec.

Sequential-proto decode is NOT the hot path (that is the mmap format in
``data.filesource``); ``convert_to_shards`` does the one-time migration.
"""

from __future__ import annotations

import gzip
import io
import json
import logging
import struct
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from tensorflow_train_distributed_torch.data.filesource import (
    TransformedRecordMixin,
    read_with_retries,
)
from tensorflow_train_distributed_torch.runtime import faults

logger = logging.getLogger(__name__)

# id1+id2+deflate method: 3 bytes, not 2 — a plain TFRecord whose first
# record is exactly 0x8B1F bytes long starts with 1f 8b too, but its third
# byte is a length byte, not 0x08.
_GZIP_MAGIC = b"\x1f\x8b\x08"


def _is_gzip(path: Union[str, Path]) -> bool:
    """Sniff the gzip magic — TF writes ``.gz`` TFRecords as one gzip
    stream over the whole file (TFRecordOptions GZIP), and extension
    conventions vary, so content beats suffix."""
    with open(path, "rb") as f:
        return f.read(3) == _GZIP_MAGIC

# --- crc32c (Castagnoli), table-driven, with TF's masking -------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- varint / proto primitives ----------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out.extend(payload)


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == 1:
        return pos + 8
    if wire == 2:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire == 5:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire}")


# --- tf.train.Example codec -------------------------------------------------


def encode_example(features: dict[str, np.ndarray]) -> bytes:
    """Encode ``{name: array}`` as a serialized ``tf.train.Example``.

    dtype mapping (the tf.train convention): floating → FloatList (f32),
    integer/bool → Int64List, bytes/str objects → BytesList.
    """
    feats = bytearray()
    for name in sorted(features):
        arr = features[name]
        body = bytearray()
        if isinstance(arr, (bytes, str)):
            values = [arr.encode() if isinstance(arr, str) else arr]
            inner = bytearray()
            for v in values:
                _write_len_delimited(inner, 1, v)
            _write_len_delimited(body, 1, bytes(inner))  # bytes_list
        else:
            arr = np.asarray(arr)
            if np.issubdtype(arr.dtype, np.floating):
                packed = np.ascontiguousarray(
                    arr.reshape(-1), np.float32).tobytes()
                inner = bytearray()
                _write_len_delimited(inner, 1, packed)  # packed floats
                _write_len_delimited(body, 2, bytes(inner))  # float_list
            elif (np.issubdtype(arr.dtype, np.integer)
                  or arr.dtype == np.bool_):
                inner = bytearray()
                packed = bytearray()
                for v in arr.reshape(-1).astype(np.int64).tolist():
                    _write_varint(packed, v & 0xFFFFFFFFFFFFFFFF)
                _write_len_delimited(inner, 1, bytes(packed))
                _write_len_delimited(body, 3, bytes(inner))  # int64_list
            else:
                raise TypeError(
                    f"field {name!r}: unsupported dtype {arr.dtype}")
        # map entry: key = field 1 (string), value = field 2 (Feature)
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode())
        _write_len_delimited(entry, 2, bytes(body))
        _write_len_delimited(feats, 1, bytes(entry))
    example = bytearray()
    _write_len_delimited(example, 1, bytes(feats))  # Example.features
    return bytes(example)


def _decode_float_list(buf: bytes) -> list[float]:
    out: list[float] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # packed
            n, pos = _read_varint(buf, pos)
            out.extend(struct.unpack(f"<{n // 4}f", buf[pos:pos + n]))
            pos += n
        elif field == 1 and wire == 5:  # unpacked
            out.append(struct.unpack("<f", buf[pos:pos + 4])[0])
            pos += 4
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def _decode_int64_list(buf: bytes) -> list[int]:
    out: list[int] = []
    pos = 0

    def _signed(v: int) -> int:
        return v - (1 << 64) if v >= (1 << 63) else v

    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # packed
            n, pos = _read_varint(buf, pos)
            end = pos + n
            while pos < end:
                v, pos = _read_varint(buf, pos)
                out.append(_signed(v))
        elif field == 1 and wire == 0:  # unpacked
            v, pos = _read_varint(buf, pos)
            out.append(_signed(v))
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def _decode_bytes_list(buf: bytes) -> list[bytes]:
    out: list[bytes] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            out.append(buf[pos:pos + n])
            pos += n
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def _decode_feature(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2 and field in (1, 2, 3):
            n, pos = _read_varint(buf, pos)
            payload = buf[pos:pos + n]
            pos += n
            if field == 1:
                return _decode_bytes_list(payload)
            if field == 2:
                return np.asarray(_decode_float_list(payload), np.float32)
            return np.asarray(_decode_int64_list(payload), np.int64)
        pos = _skip_field(buf, pos, wire)
    return np.asarray([], np.float32)  # empty Feature


def decode_example(data: bytes) -> dict[str, object]:
    """Serialized ``tf.train.Example`` → ``{name: ndarray | [bytes]}``
    (flat values; apply shapes via ``TFRecordSource``'s feature spec)."""
    out: dict[str, object] = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # Example.features
            n, pos = _read_varint(data, pos)
            feats = data[pos:pos + n]
            pos += n
            fpos = 0
            while fpos < len(feats):
                ftag, fpos = _read_varint(feats, fpos)
                ffield, fwire = ftag >> 3, ftag & 7
                if ffield == 1 and fwire == 2:  # map entry
                    en, fpos = _read_varint(feats, fpos)
                    entry = feats[fpos:fpos + en]
                    fpos += en
                    key, value = None, None
                    epos = 0
                    while epos < len(entry):
                        etag, epos = _read_varint(entry, epos)
                        efield, ewire = etag >> 3, etag & 7
                        if ewire == 2:
                            vn, epos = _read_varint(entry, epos)
                            payload = entry[epos:epos + vn]
                            epos += vn
                            if efield == 1:
                                key = payload.decode()
                            elif efield == 2:
                                value = _decode_feature(payload)
                        else:
                            epos = _skip_field(entry, epos, ewire)
                    if key is not None:
                        out[key] = value
                else:
                    fpos = _skip_field(feats, fpos, fwire)
        else:
            pos = _skip_field(data, pos, wire)
    return out


# --- record-level IO --------------------------------------------------------


class TFRecordWriter:
    """Write raw records in TFRecord framing (context-manager friendly).

    A ``.gz`` path (or ``compress=True``) streams through gzip — the
    TFRecordOptions GZIP wire format, readable by tf.data with
    ``compression_type="GZIP"`` and by ``TFRecordSource`` here.
    """

    def __init__(self, path: Union[str, Path],
                 compress: Optional[bool] = None):
        if compress is None:
            compress = str(path).endswith(".gz")
        self._f = gzip.open(path, "wb") if compress else open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def write_example(self, features: dict[str, np.ndarray]) -> None:
        self.write(encode_example(features))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: Union[str, Path], *, verify_crc: bool = True,
                 on_corrupt: str = "raise",
                 stats: Optional[dict] = None):
    """Yield raw record payloads from one TFRecord file (gzip-aware).

    ``on_corrupt`` (with ``verify_crc``): ``"raise"`` keeps the
    historical fail-mid-stream behavior; ``"skip"`` drops records whose
    *payload* crc fails (the framing is intact, so the stream resyncs
    cleanly at the next record) and counts them in
    ``stats["skipped_records"]``.  A corrupt *length* crc leaves no
    trustworthy framing to resync on — skip mode abandons the rest of
    the file loudly instead of misparsing garbage as records.
    """
    if on_corrupt not in ("raise", "skip"):
        raise ValueError(
            f"on_corrupt must be 'raise' or 'skip', got {on_corrupt!r}")

    def _skip_tail(what: str) -> bool:
        # Truncation mid-record = crashed-writer tail: in skip mode it
        # is dropped (counted + logged) instead of raised — nothing
        # after it is parseable either way.
        if on_corrupt != "skip":
            return False
        if stats is not None:
            stats["skipped_records"] = stats.get("skipped_records", 0) + 1
        logger.error("%s: %s; dropping the file tail (crashed writer)",
                     path, what)
        return True

    opener = gzip.open if _is_gzip(path) else open
    with opener(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                if _skip_tail("truncated length header"):
                    return
                raise ValueError(f"{path}: truncated length header")
            (length,) = struct.unpack("<Q", header)
            crc_bytes = f.read(4)
            if len(crc_bytes) != 4:
                if _skip_tail("truncated length crc"):
                    return
                raise ValueError(f"{path}: truncated length crc")
            (len_crc,) = struct.unpack("<I", crc_bytes)
            if verify_crc and _masked_crc(header) != len_crc:
                if on_corrupt == "skip":
                    if stats is not None:
                        stats["skipped_records"] = (
                            stats.get("skipped_records", 0) + 1)
                    logger.error(
                        "%s: corrupt length crc — framing lost, "
                        "abandoning the rest of the file", path)
                    return
                raise ValueError(f"{path}: corrupt length crc")
            payload = f.read(length)
            if len(payload) != length:
                if _skip_tail("truncated record"):
                    return
                raise ValueError(f"{path}: truncated record")
            crc_bytes = f.read(4)
            if len(crc_bytes) != 4:
                if _skip_tail("truncated record crc"):
                    return
                raise ValueError(f"{path}: truncated record crc")
            (crc,) = struct.unpack("<I", crc_bytes)
            if verify_crc and _masked_crc(payload) != crc:
                if on_corrupt == "skip":
                    if stats is not None:
                        stats["skipped_records"] = (
                            stats.get("skipped_records", 0) + 1)
                    continue
                raise ValueError(f"{path}: corrupt record crc")
            yield payload


def _index_stream(f, size: int, name: str, *, on_corrupt: str = "raise",
                  stats: Optional[dict] = None) -> list[tuple[int, int]]:
    """One sequential pass → [(payload_offset, payload_length)].

    Bounds-checks every record against the stream size so a file
    truncated mid-record (crashed writer) fails loudly at open time, not
    as an opaque decode error mid-training.

    ``on_corrupt="skip"`` additionally verifies both crcs (reading every
    payload — the price of screening) and LEAVES OUT corrupt records,
    counting them in ``stats["skipped_records"]``: training then never
    meets them mid-epoch.  The default ``"raise"`` pass stays seek-only
    (no payload reads, no crc cost).
    """
    index = []
    pos = 0
    while True:
        header = f.read(8)
        if not header:
            return index
        if len(header) != 8:
            if on_corrupt == "skip":
                if stats is not None:
                    stats["skipped_records"] = (
                        stats.get("skipped_records", 0) + 1)
                logger.error(
                    "%s: truncated length header at offset %d; dropping "
                    "it (crashed writer tail)", name, pos)
                return index
            raise ValueError(f"{name}: truncated length header")
        (length,) = struct.unpack("<Q", header)
        end = pos + 12 + length + 4
        if end > size:
            if on_corrupt == "skip":
                if stats is not None:
                    stats["skipped_records"] = (
                        stats.get("skipped_records", 0) + 1)
                logger.error(
                    "%s: truncated record at offset %d; dropping it "
                    "(crashed writer tail)", name, pos)
                return index
            raise ValueError(
                f"{name}: truncated record at offset {pos} "
                f"(needs {end} bytes, stream has {size})")
        if on_corrupt == "skip":
            (len_crc,) = struct.unpack("<I", f.read(4))
            payload = f.read(length)
            (crc,) = struct.unpack("<I", f.read(4))
            if (_masked_crc(header) != len_crc
                    or _masked_crc(payload) != crc):
                if stats is not None:
                    stats["skipped_records"] = (
                        stats.get("skipped_records", 0) + 1)
                if _masked_crc(header) != len_crc:
                    # Framing itself is untrustworthy: the next "record"
                    # boundary came from a corrupt length. Stop here
                    # rather than index garbage offsets.
                    logger.error(
                        "%s: corrupt length crc at offset %d — framing "
                        "lost, abandoning the rest of the file",
                        name, pos)
                    return index
                pos = end
                continue
        index.append((pos + 12, length))
        pos = end
        f.seek(pos)


def _index_file(path: Union[str, Path], *, on_corrupt: str = "raise",
                stats: Optional[dict] = None) -> list[tuple[int, int]]:
    size = Path(path).stat().st_size
    with open(path, "rb") as f:
        return _index_stream(f, size, str(path), on_corrupt=on_corrupt,
                             stats=stats)


class TFRecordSource:
    """Random access over TFRecord file(s) of ``tf.train.Example`` protos.

    ``features``: FixedLenFeature-style spec ``{name: (shape, dtype)}`` —
    flat Example values are reshaped/cast per field.  ``None`` returns the
    raw decoded dict (flat arrays / byte lists).  Multiple paths act as
    one concatenated dataset whose file boundaries are the FILE-autoshard
    units (wrap in ``pipeline.ConcatSource`` semantics via ``as_parts``).
    """

    def __init__(self, paths: Union[str, Path, Sequence[Union[str, Path]]],
                 features: Optional[dict[str, tuple]] = None,
                 max_gz_cached: int = 4, on_corrupt: str = "raise"):
        if isinstance(paths, (str, Path)):
            paths = [paths]
        if on_corrupt not in ("raise", "skip"):
            raise ValueError(
                f"on_corrupt must be 'raise' or 'skip', got {on_corrupt!r}")
        self.paths = [Path(p) for p in paths]
        if not self.paths:
            raise ValueError("TFRecordSource needs at least one path")
        self.features = features
        self.on_corrupt = on_corrupt
        # Pipeline-stats surface (``stats()``): corrupt-crc records the
        # "skip" policy screened out at open — loud, countable, and
        # never met mid-epoch.
        self._stats = {"skipped_records": 0}
        self._index: list[tuple[int, int, int]] = []  # (file, offset, len)
        self._file_counts: list[int] = []
        # Gzip TFRecords are one stream (no per-record seek): serve random
        # access from a decompressed in-memory copy, LRU-bounded like the
        # fd cache below — a 100-shard gzip corpus must not pin the whole
        # decompressed corpus in RAM.  Re-decompression on miss is the
        # cold-path price; the mmap format is the hot path for anything
        # throughput-critical (module docstring).
        self._gz_files: set[int] = set()
        self._gz_cache: dict[int, bytes] = {}
        self._max_gz_cached = max(1, int(max_gz_cached))
        self._gz_decompressed: set[int] = set()  # shards decompressed once
        self._warned_gz_thrash = False
        for fi, p in enumerate(self.paths):
            if _is_gzip(p):
                self._gz_files.add(fi)
                data = self._gz_bytes(fi)
                entries = _index_stream(io.BytesIO(data), len(data),
                                        str(p), on_corrupt=on_corrupt,
                                        stats=self._stats)
            else:
                entries = _index_file(p, on_corrupt=on_corrupt,
                                      stats=self._stats)
            self._file_counts.append(len(entries))
            for off, length in entries:
                self._index.append((fi, off, length))
        if self._stats["skipped_records"]:
            logger.warning(
                "TFRecordSource: skipped %d corrupt record(s) across %d "
                "file(s) (on_corrupt='skip'); stats() has the count",
                self._stats["skipped_records"], len(self.paths))
        # Indexing above decompressed every gzip shard once — that's
        # construction cost, not read-pattern thrash.  Reads start fresh.
        self._gz_decompressed.clear()
        # LRU-bounded handle cache: big corpora (1000s of shard files)
        # must not exhaust the process fd limit.
        self._handles: "dict[int, object]" = {}
        self._max_handles = 64

    def __len__(self) -> int:
        return len(self._index)

    def _gz_bytes(self, fi: int) -> bytes:
        data = self._gz_cache.pop(fi, None)
        if data is None:
            if fi in self._gz_decompressed and not self._warned_gz_thrash:
                # Evicted-then-refetched: the access pattern (e.g. global
                # shuffle over many gzip shards) is thrashing the cache —
                # each miss re-decompresses a whole shard.  Warn once; a
                # strictly sequential pass never hits this.
                self._warned_gz_thrash = True
                import warnings

                warnings.warn(
                    f"re-decompressing gzip shard "
                    f"{self.paths[fi].name}: {len(self._gz_files)} gzip "
                    f"shards exceed the {self._max_gz_cached}-shard "
                    f"decompressed cache (max_gz_cached) under a "
                    f"non-sequential access pattern — raise max_gz_cached "
                    f"or convert to the uncompressed/mmap format for "
                    f"shuffled throughput-critical reads",
                    stacklevel=3)
            self._gz_decompressed.add(fi)
            if len(self._gz_cache) >= self._max_gz_cached:
                self._gz_cache.pop(next(iter(self._gz_cache)))  # LRU out
            with gzip.open(self.paths[fi], "rb") as f:
                data = f.read()
        self._gz_cache[fi] = data  # re-insert → most recently used
        return data

    def _handle(self, fi: int):
        if fi in self._gz_files:  # in-memory; no fd to manage
            return io.BytesIO(self._gz_bytes(fi))
        f = self._handles.pop(fi, None)
        if f is None:
            if len(self._handles) >= self._max_handles:
                lru = next(iter(self._handles))  # least recently used
                self._handles.pop(lru).close()
            f = open(self.paths[fi], "rb")
        self._handles[fi] = f  # re-insert → most recently used
        return f

    def stats(self) -> dict:
        """Pipeline stats: record counts + corrupt records screened out
        by ``on_corrupt='skip'`` (0 under the default policy, which
        raises instead)."""
        return {"records": len(self._index), "files": len(self.paths),
                "skipped_records": self._stats["skipped_records"]}

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        if idx < 0 or idx >= len(self._index):
            raise IndexError(idx)
        fi, off, length = self._index[idx]

        def _read():
            if faults.ARMED:
                faults.on_data_read(idx)
            f = self._handle(fi)
            f.seek(off)
            return f.read(length)

        raw = read_with_retries(
            _read, f"{self.paths[fi]} record {idx}")
        try:
            rec = decode_example(raw)
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"{self.paths[fi]}: record {idx} failed to decode "
                f"({e}) — corrupt payload; re-open with "
                "on_corrupt='skip' to screen such records out") from e
        if self.features is None:
            return rec
        out = {}
        for name, (shape, dtype) in self.features.items():
            if name not in rec:
                raise KeyError(
                    f"record {idx} missing feature {name!r}; has "
                    f"{sorted(rec)}")
            out[name] = np.asarray(rec[name]).reshape(shape).astype(dtype)
        return out

    def as_parts(self):
        """Per-file views for FILE autoshard (``ConcatSource(parts)``).

        Views, not new sources: all parts share this source's index and
        LRU-bounded handle cache, so a 5000-file corpus still holds at
        most ``_max_handles`` fds process-wide.
        """
        parts, start = [], 0
        for count in self._file_counts:
            parts.append(_SourceSlice(self, start, count))
            start += count
        return parts


class _SourceSlice:
    """Contiguous view into a ``RandomAccessSource`` (one file's records)."""

    def __init__(self, source, start: int, count: int):
        self.source, self.start, self.count = source, start, count

    def __len__(self) -> int:
        return self.count

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        if idx < 0 or idx >= self.count:
            raise IndexError(idx)
        return self.source[self.start + idx]


FEATURES_SIDECAR = "features.json"

_DTYPES = {"float32": np.float32, "float64": np.float64,
           "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
           "bool": np.bool_}


def write_features_sidecar(root: Union[str, Path],
                           features: Optional[dict[str, tuple]]) -> Path:
    """Persist a feature spec as ``features.json`` next to the tfrecords,
    so directory-level opens (CLI ``--data-dir``) need no Python spec.

    ``features=None`` writes the RAW marker: records decode as the
    Example's raw flat arrays/byte lists with no fixed-shape spec — the
    variable-shape case (JPEG corpora, varlen token docs), where a
    per-record ``transform`` produces the fixed-shape training record.
    """
    root = Path(root)
    out = root / FEATURES_SIDECAR
    if features is None:
        out.write_text(json.dumps({"raw": True}))
        return out
    spec = {name: {"shape": list(shape), "dtype": np.dtype(dtype).name}
            for name, (shape, dtype) in features.items()}
    out.write_text(json.dumps({"features": spec}))
    return out


def read_features_sidecar(root: Union[str, Path]
                          ) -> Optional[dict[str, tuple]]:
    """Feature spec from ``features.json``; None for the RAW marker."""
    spec = json.loads((Path(root) / FEATURES_SIDECAR).read_text())
    if spec.get("raw"):
        return None
    out = {}
    for name, f in spec["features"].items():
        dtype = f["dtype"]
        if dtype not in _DTYPES:
            raise ValueError(
                f"{FEATURES_SIDECAR}: feature {name!r} has unsupported "
                f"dtype {dtype!r}; supported: {sorted(_DTYPES)}")
        out[name] = (tuple(f["shape"]), _DTYPES[dtype])
    return out


def open_tfrecord_dir(root: Union[str, Path],
                      features: Optional[dict[str, tuple]] = None,
                      transform=None, on_corrupt: str = "raise"):
    """Open a directory of ``*.tfrecord``(.gz) files as a ``ConcatSource``.

    Each file is one FILE-autoshard part (``DataConfig(shard_policy=
    "file")`` hands whole files to processes — the reference's FILE policy
    unit, SURVEY.md §3.5).  The feature spec comes from ``features`` or a
    ``features.json`` sidecar; ``transform`` is a callable or a
    ``filesource.TRANSFORMS`` name applied per record.
    """
    from tensorflow_train_distributed_torch.data.filesource import (
        resolve_transform,
    )
    from tensorflow_train_distributed_torch.data.pipeline import ConcatSource

    root = Path(root)
    paths = sorted([*root.glob("*.tfrecord"), *root.glob("*.tfrecord.gz")])
    if not paths:
        raise FileNotFoundError(
            f"no *.tfrecord / *.tfrecord.gz files under {root}")
    if features is None:
        if not (root / FEATURES_SIDECAR).is_file():
            raise FileNotFoundError(
                f"{root} has no {FEATURES_SIDECAR}; pass features= or "
                "write one with write_features_sidecar()")
        features = read_features_sidecar(root)
    transform = resolve_transform(transform)
    if features is None and transform is None:
        # RAW records are variable-shape (byte lists, varlen arrays) —
        # batching would np.stack them into garbage or crash downstream.
        # Fail at open with the actionable fix instead.
        raise ValueError(
            f"{root} is a RAW corpus (features.json marks no fixed "
            "schema) — a per-record transform must produce the "
            "fixed-shape training record; pass --data-transform (e.g. "
            "imagenet_train_224) or open with transform=")
    # ONE source over all files (shared index + LRU handle cache), exposed
    # as per-file views so FILE autoshard still hands whole files out —
    # per-file sources would each cache fds and defeat the LRU bound.
    source = TFRecordSource(paths, features, on_corrupt=on_corrupt)
    parts = source.as_parts()
    if transform is not None:
        parts = [_TransformedSource(p, transform) for p in parts]
    return ConcatSource(parts)


class _TransformedSource(TransformedRecordMixin):
    """Apply a record transform over any ``RandomAccessSource``."""

    def __init__(self, source, transform):
        self.source = source
        self._init_transform(transform)

    def __len__(self) -> int:
        return len(self.source)

    def _raw(self, idx: int) -> dict[str, np.ndarray]:
        return self.source[idx]


def convert_to_shards(tfrecord_paths, out_root, features,
                      num_shards: int):
    """One-time migration: TFRecord corpus → the mmap hot-path format."""
    from tensorflow_train_distributed_torch.data.filesource import write_shards

    src = TFRecordSource(tfrecord_paths, features)
    return write_shards(out_root, src, num_shards)
