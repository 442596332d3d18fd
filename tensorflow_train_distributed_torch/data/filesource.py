"""On-disk record ingestion: memory-mapped columnar shards (a copy of
the JAX package's ``data/filesource.py``, numpy only, with its imports
pointing into the port).

The reference's input layer reads real corpora through tf.data file
formats (TFRecord readers behind ``tf.data`` builders, SURVEY.md §2.1 /
§3.5); its FILE autoshard policy (``data/ops/options.py:89``) hands whole
files to workers.  The TPU-native equivalent here is a *columnar
memory-mapped* layout rather than a sequential proto stream:

- a corpus is a directory of ``part-NNNNN/`` shard dirs — the FILE
  autoshard unit, loaded as a ``ConcatSource``;
- each shard dir holds one ``<field>.npy`` per record field plus a
  ``manifest.json``; fields are ``np.load(..., mmap_mode="r")``'d, so
  random access is an O(1) page-fault read with zero deserialization —
  exactly what the native batch stager and host→device prefetch want
  (record bytes flow mmap page → packed batch → HBM, no proto decode on
  the hot path).

Records of one shard are fixed-shape (the SPMD static-shape contract the
pipeline already enforces); variable-length data is padded at corpus-write
time, the same trade tf.data's ``padded_batch`` makes per step but paid
once.
"""

from __future__ import annotations

import inspect
import json
import logging
import time
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np

from tensorflow_train_distributed_torch.data.pipeline import (
    ConcatSource,
    fetch_record,  # noqa: F401  (re-export: the record-fetch protocol)
)
from tensorflow_train_distributed_torch.runtime import faults

logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"

# Bounded retry for transient record-read IO (flaky NFS/GCS-fuse mounts,
# injected faults): N attempts with doubling backoff, then the error
# propagates — a *persistently* failing disk must kill the job loudly,
# not spin forever feeding the trainer nothing.
IO_RETRY_ATTEMPTS = 3
IO_RETRY_BACKOFF_S = 0.05


def read_with_retries(fn: Callable[[], dict], what: str,
                      *, attempts: int = None, backoff_s: float = None,
                      sleep=time.sleep) -> dict:
    """Run a record-read thunk with bounded retry on ``OSError``.

    Only ``OSError`` (the transient-IO family, including
    ``faults.InjectedTransientIO``) retries; decode/shape errors are
    data corruption, not weather, and propagate immediately.
    """
    attempts = IO_RETRY_ATTEMPTS if attempts is None else attempts
    backoff_s = IO_RETRY_BACKOFF_S if backoff_s is None else backoff_s
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as e:
            if attempt + 1 >= attempts:
                raise
            delay = backoff_s * 2 ** attempt
            logger.warning(
                "transient IO reading %s (%s); retry %d/%d in %.2fs",
                what, e, attempt + 1, attempts - 1, delay)
            sleep(delay)

# Named record transforms, so configs/CLI can reference them as strings
# (e.g. storage-efficient uint8 images decoded to the model's f32 input).
TRANSFORMS: dict[str, Callable[[dict], dict]] = {
    "u8_image_to_f32": lambda rec: {
        **rec, "image": np.asarray(rec["image"], np.float32) / 255.0,
    },
}


def resolve_transform(
    transform: Union[Callable[[dict], dict], str, None],
) -> Optional[Callable[[dict], dict]]:
    """Resolve a ``TRANSFORMS`` name (or pass a callable/None through)."""
    if isinstance(transform, str):
        if transform not in TRANSFORMS:
            # Image decode/augment names register on demand, any size
            # (``data/image.py``; it does not import PIL at import time).
            from tensorflow_train_distributed_torch.data import image

            image.ensure_registered(transform)
        if transform not in TRANSFORMS:
            raise ValueError(
                f"Unknown transform {transform!r}; available: "
                f"{sorted(TRANSFORMS)}")
        return TRANSFORMS[transform]
    return transform


def transform_is_epoch_aware(fn) -> bool:
    """Does ``fn`` accept an ``epoch`` keyword (fresh-per-epoch
    augmentation, e.g. ``image.imagenet_train_record``)?  Sources call
    epoch-aware transforms as ``fn(rec, epoch=e)`` with the epoch the
    loader passes to ``get_record``; everything else keeps the 1-arg
    call."""
    if fn is None:
        return False
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    p = sig.parameters.get("epoch")
    return p is not None and p.kind in (
        inspect.Parameter.KEYWORD_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD)


class TransformedRecordMixin:
    """Leaf-source helper: raw record + optional (epoch-aware) transform.

    Subclasses implement ``_raw(idx)`` and call ``_init_transform`` once;
    the mixin provides the ``get_record``/``__getitem__`` pair with the
    epoch threaded into transforms that accept it."""

    def _init_transform(self, transform) -> None:
        self.transform = resolve_transform(transform)
        self.epoch_aware = transform_is_epoch_aware(self.transform)

    def get_record(self, idx: int, epoch: int = 0) -> dict:
        rec = self._raw(idx)
        if self.transform is None:
            return rec
        if self.epoch_aware:
            return self.transform(rec, epoch=epoch)
        return self.transform(rec)

    def __getitem__(self, idx: int) -> dict:
        return self.get_record(idx, 0)


class MmapArraySource(TransformedRecordMixin):
    """One shard dir of ``.npy`` columns, memory-mapped; random access.

    ``transform`` (callable or ``TRANSFORMS`` name) maps the raw stored
    record to the training record — storage dtype and model dtype need
    not match.
    """

    def __init__(self, path: Union[str, Path],
                 transform: Union[Callable[[dict], dict], str, None] = None):
        self.path = Path(path)
        manifest_path = self.path / MANIFEST
        if not manifest_path.is_file():
            raise FileNotFoundError(
                f"{self.path} is not a record shard (no {MANIFEST})")
        manifest = json.loads(manifest_path.read_text())
        self.columns: dict[str, np.ndarray] = {}
        n = int(manifest["num_records"])
        for name in manifest["fields"]:
            arr = np.load(self.path / f"{name}.npy", mmap_mode="r")
            if arr.shape[0] != n:
                raise ValueError(
                    f"{self.path}/{name}.npy has {arr.shape[0]} records, "
                    f"manifest says {n}")
            self.columns[name] = arr
        self._n = n
        self._init_transform(transform)

    def __len__(self) -> int:
        return self._n

    def _raw(self, idx: int) -> dict[str, np.ndarray]:
        if idx < 0 or idx >= self._n:
            raise IndexError(idx)

        def _read():
            if faults.ARMED:
                faults.on_data_read(idx)
            # np.asarray materializes the mmap'd row — the page-fault
            # read that a flaky mount turns into an OSError.
            return {k: np.asarray(v[idx]) for k, v in self.columns.items()}

        return read_with_retries(_read, f"{self.path} record {idx}")


def write_shards(root: Union[str, Path], source, num_shards: int) -> Path:
    """Write a ``RandomAccessSource`` as ``part-NNNNN/`` mmap shard dirs.

    Contiguous record ranges per shard (shard boundaries = file boundaries,
    the FILE-autoshard unit).  Storage dtype is whatever the source yields
    — pre-quantize (e.g. images to uint8) before writing and decode with a
    ``transform`` at read time.
    """
    root = Path(root)
    n = len(source)
    if num_shards < 1 or n < num_shards:
        raise ValueError(f"cannot write {n} records as {num_shards} shards")
    root.mkdir(parents=True, exist_ok=True)
    written = set()
    # Balanced split (sizes differ by at most 1) — a ceil-based split can
    # leave trailing shards empty.
    for s, idx in enumerate(np.array_split(np.arange(n), num_shards)):
        records = [source[int(i)] for i in idx]
        part = root / f"part-{s:05d}"
        part.mkdir(exist_ok=True)
        written.add(part.name)
        fields = sorted(records[0])
        for name in fields:
            np.save(part / f"{name}.npy",
                    np.stack([r[name] for r in records]))
        (part / MANIFEST).write_text(json.dumps(
            {"num_records": len(records), "fields": fields}))
    # Rewriting with fewer shards must not leave stale parts behind —
    # open_sharded globs part-* and would silently concatenate them.
    for stale in root.glob("part-*"):
        if stale.is_dir() and stale.name not in written:
            for f in stale.iterdir():
                f.unlink()
            stale.rmdir()
    return root


def open_sharded(root: Union[str, Path],
                 transform: Union[Callable[[dict], dict], str, None] = None,
                 ) -> ConcatSource:
    """Open a ``write_shards`` corpus as a ``ConcatSource`` of mmap parts.

    Use with ``DataConfig(shard_policy="file")`` for whole-file-per-worker
    autoshard, or the default DATA policy for index-stride sharding.
    """
    root = Path(root)
    parts = sorted(p for p in root.glob("part-*") if p.is_dir())
    if not parts:
        raise FileNotFoundError(f"no part-* shard dirs under {root}")
    return ConcatSource([MmapArraySource(p, transform) for p in parts])
