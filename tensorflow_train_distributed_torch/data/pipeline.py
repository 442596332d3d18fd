"""Host data loading and the copy to the device (the single-process part
of the JAX package's ``data/pipeline.py``).

- ``HostDataLoader`` walks a random-access source in the JAX loader's
  order: per epoch a permutation drawn from ``SeedSequence([seed,
  epoch])`` (or the identity without shuffling), whole batches only for
  training (drop remainder), or — for evaluation — the last batch padded
  by repeating the final index with a ``sample_weight`` of 0 on the pad
  rows.  ``iter_from(global_step)`` resumes mid-epoch: the order is a
  pure function of (seed, epoch), so the position is index arithmetic on
  the step alone.  The same source, batch size and seed give the JAX
  loader's batches bit for bit (``tests/test_torch_data.py``).
- ``ConcatSource`` (a file list) and ``MixtureSource`` (a weighted
  mixture) are copied verbatim.
- ``prefetch_to_device``: a thread copies each batch into pinned memory
  and onto the device with ``non_blocking=True`` while the step runs,
  the counterpart of the JAX ``prefetch_to_device``.
- ``HostBatches`` is the training loader under its earlier name.

Sharding, as the JAX loader's: ``HostDataLoader(process_index=p,
process_count=P)`` yields ``global_batch_size / P`` rows a step from its
shard, the index stride ``order[p::P]`` of the epoch's permutation
(``shard_policy="data"``), or whole files ``f % P == p`` of a
``ConcatSource`` shuffled within the shard (``"file"``).  The defaults
(0 of 1) read everything in one process; the data service's workers
(``data/service.py``) each read one shard.  The JAX loader's native
stager is not ported.
"""

from __future__ import annotations

import dataclasses
import queue as queue_lib
import threading
from typing import Iterator, Optional, Protocol

import numpy as np
import torch


class RandomAccessSource(Protocol):
    """Minimal source protocol (grain-compatible): len + indexed record."""

    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]: ...


def fetch_record(source, idx: int, epoch: int = 0) -> dict:
    """Fetch ``source[idx]`` with the epoch threaded to epoch-aware
    transforms (fresh-per-epoch augmentation, reference tf.data
    semantics).  The epoch travels WITH the call — no mutable source
    state — so interleaved iterators over one source (periodic eval,
    ``iter_from`` probes, prefetch threads) can never corrupt each
    other's augmentation epoch.  Sources without the ``get_record`` hook
    fall back to plain indexing (their transforms, if any, are
    epoch-independent)."""
    g = getattr(source, "get_record", None)
    if g is not None:
        return g(idx, epoch)
    return source[idx]


class ConcatSource:
    """Concatenation of per-file sources — the FILE-autoshard unit.

    The reference's ``AutoShardPolicy.FILE`` (``data/ops/options.py:89``)
    assigns whole input files to workers; here a "file" is any
    ``RandomAccessSource`` and this class is the file list (one process
    reads every file).
    """

    def __init__(self, parts):
        if not parts:
            raise ValueError("ConcatSource needs at least one part")
        self.parts = list(parts)
        self._offsets = np.cumsum([0] + [len(p) for p in self.parts])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        return self.get_record(idx, 0)

    def get_record(self, idx: int, epoch: int = 0) -> dict[str, np.ndarray]:
        """Indexed fetch with the epoch threaded to epoch-aware parts
        (``fetch_record`` semantics)."""
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        f = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return fetch_record(self.parts[f], int(idx - self._offsets[f]), epoch)

    @property
    def epoch_aware(self) -> bool:
        return any(getattr(p, "epoch_aware", False) for p in self.parts)

    def part_indices(self, part: int) -> np.ndarray:
        """Global record indices belonging to file ``part``."""
        return np.arange(self._offsets[part], self._offsets[part + 1])


class MixtureSource:
    """Weighted mixture of sources — the LLM-pretrain data-mixture unit.

    Record ``i`` deterministically comes from one component (chosen by a
    seeded weighted draw) at that component's next sequential position,
    wrapping when a smaller corpus is exhausted (components repeat at
    their weight's rate — the standard mixture semantics; beyond the
    reference, which has no multi-corpus story).  The schedule is drawn
    once from ``seed`` at open (a longer ``num_examples`` with the same
    seed extends the schedule without rescrambling its prefix), making
    the source random-access like any other: DATA autoshard, shuffling,
    and deterministic mid-epoch resume compose unchanged.  (FILE
    autoshard wants a ``ConcatSource`` of per-file parts — mix *inside*
    each part, or shard the mixture with the DATA policy.)

    ``num_examples`` defaults to the total across components (each seen
    ~once at equal weights); set it explicitly for weighted runs where
    "one epoch" is a token budget, not a corpus pass.
    """

    def __init__(self, sources, weights=None, *, seed: int = 0,
                 num_examples: int | None = None):
        if not sources:
            raise ValueError("MixtureSource needs at least one source")
        self.sources = list(sources)
        k = len(self.sources)
        empty = [i for i, s in enumerate(self.sources) if len(s) == 0]
        if empty:
            raise ValueError(
                f"mixture components {empty} are empty (every component "
                "must have at least one record)")
        if weights is None:
            weights = [1.0] * k
        if len(weights) != k:
            raise ValueError(
                f"{k} sources but {len(weights)} weights")
        w = np.asarray(weights, np.float64)
        if (w <= 0).any():
            raise ValueError(f"weights must be > 0, got {weights}")
        self.weights = w / w.sum()
        n = sum(len(s) for s in self.sources) if num_examples is None \
            else num_examples
        if n <= 0:
            raise ValueError(f"num_examples must be > 0, got {n}")
        # Seeded by `seed` alone: rng.choice draws sequentially, so a
        # longer num_examples with the same seed keeps the prefix stable
        # (extending a token budget must not rescramble history).
        rng = np.random.default_rng(np.random.SeedSequence([seed]))
        # Materialized schedule: component id per record + running
        # within-component position.  int8+int32 per record (~5 B/record)
        # — 100M-record mixtures cost ~500 MB of host index, same order
        # as the offset indexes the file sources already keep.
        if k > 127:
            raise ValueError(f"at most 127 mixture components, got {k}")
        self._assignment = rng.choice(
            k, size=n, p=self.weights).astype(np.int8)
        # Within-component cumcount in one stable-argsort pass (a
        # per-component mask loop would be O(k·n) — hundreds of array
        # sweeps at the 100M-record/127-component scale budgeted above).
        order = np.argsort(self._assignment, kind="stable")
        counts = np.bincount(self._assignment, minlength=k)
        starts = np.repeat(np.concatenate(
            [[0], np.cumsum(counts)[:-1]]), counts)
        self._within = np.empty(n, np.int32)
        self._within[order] = (np.arange(n) - starts).astype(np.int32)
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        return self.get_record(idx, 0)

    def get_record(self, idx: int, epoch: int = 0) -> dict[str, np.ndarray]:
        """Indexed fetch with the epoch threaded to epoch-aware
        components (``fetch_record`` semantics)."""
        if idx < 0 or idx >= self._n:
            raise IndexError(idx)
        src = self.sources[int(self._assignment[idx])]
        return fetch_record(src, int(self._within[idx]) % len(src), epoch)

    @property
    def epoch_aware(self) -> bool:
        return any(getattr(s, "epoch_aware", False) for s in self.sources)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Loader configuration (global batch semantics, as in the JAX
    package): ``drop_remainder=False`` pads the final batch and adds a
    ``sample_weight`` key ([B] f32, 1 real / 0 pad) to every batch, so a
    finite split's metrics cover each example once; ``num_epochs`` None
    repeats forever; ``shard_policy`` "data" (index stride) or "file"
    (whole files of a ``ConcatSource`` per process)."""

    global_batch_size: int = 32
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True
    num_epochs: Optional[int] = None
    shard_policy: str = "data"


class HostDataLoader:
    """Iterates one process's batches of a source: ``global_batch_size /
    process_count`` rows a step from its shard; together the processes
    cover each epoch once (the JAX ``HostDataLoader``)."""

    def __init__(self, source: RandomAccessSource, config: DataConfig, *,
                 process_index: int = 0, process_count: int = 1):
        self.source = source
        self.config = config
        self.process_index = process_index
        self.process_count = process_count
        if config.global_batch_size % process_count:
            raise ValueError(
                f"global_batch_size={config.global_batch_size} not divisible "
                f"by process_count={process_count}")
        self.host_batch_size = config.global_batch_size // process_count
        if config.shard_policy not in ("data", "file"):
            raise ValueError(f"shard_policy must be data|file, got "
                             f"{config.shard_policy!r}")
        if config.shard_policy == "file":
            if not isinstance(source, ConcatSource):
                raise ValueError(
                    "shard_policy='file' needs a ConcatSource (the file "
                    f"list); got {type(source).__name__}")
            if len(source.parts) < process_count:
                raise ValueError(
                    f"FILE autoshard needs >= one file per process: "
                    f"{len(source.parts)} files < {process_count} "
                    "processes")
            # File f belongs to process f % P; every process sizes every
            # shard, so steps_per_epoch agrees without communication.
            self._file_shards = [
                np.concatenate([source.part_indices(f)
                                for f in range(q, len(source.parts),
                                               process_count)])
                for q in range(process_count)]
        if self.steps_per_epoch() == 0:
            raise ValueError(
                f"source yields 0 batches/epoch: per-process records < "
                f"host batch size {self.host_batch_size} ({len(source)} "
                f"records over {process_count} processes); shrink the "
                "batch or grow the source")

    def _epoch_order(self, epoch: int) -> np.ndarray:
        def permutation(n):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.config.seed, epoch]))
            return rng.permutation(n)

        if self.config.shard_policy == "file":
            # Shuffled within the shard (tf.data's shard-then-shuffle).
            own = self._file_shards[self.process_index]
            return own[permutation(len(own))] if self.config.shuffle \
                else own
        n = len(self.source)
        order = permutation(n) if self.config.shuffle else np.arange(n)
        # Index stride: the same permutation everywhere, process p takes
        # order[p::P].
        return order[self.process_index::self.process_count]

    def _padded_order(self, epoch: int) -> np.ndarray:
        """The epoch's index stream sized to whole batches: truncated
        (drop_remainder) or padded by repeating the final index."""
        order = np.asarray(self._epoch_order(epoch))
        want = self.steps_per_epoch() * self.host_batch_size
        if self.config.drop_remainder or len(order) == want:
            return order[:want]
        filler = order[-1:] if len(order) else np.zeros(1, np.int64)
        return np.concatenate(
            [order, np.repeat(filler, want - len(order))])

    def _with_sample_weight(self, batch: dict, in_epoch_batch: int) -> dict:
        """Attach the pad-row mask (drop_remainder=False contract)."""
        if "sample_weight" in batch:
            raise ValueError(
                "source records already have a 'sample_weight' key; the "
                "drop_remainder=False pad mask would clobber it")
        b0 = in_epoch_batch * self.host_batch_size
        w = ((np.arange(self.host_batch_size) + b0)
             < self._shard_len()).astype(np.float32)
        return dict(batch, sample_weight=w)

    def _batches(self, epoch: int, first_batch: int) -> Iterator[dict]:
        order = self._padded_order(epoch)
        bs = self.host_batch_size
        for b in range(first_batch, self.steps_per_epoch()):
            records = [fetch_record(self.source, int(i), epoch)
                       for i in order[b * bs:(b + 1) * bs]]
            batch = {k: np.stack([r[k] for r in records])
                     for k in records[0]}
            if not self.config.drop_remainder:
                batch = self._with_sample_weight(batch, b)
            yield batch

    def iter_from(self, global_step: int) -> Iterator[dict]:
        """Iterator positioned after ``global_step`` batches: epoch
        ``global_step // steps_per_epoch``, from batch ``global_step %
        steps_per_epoch`` of that epoch's order (the JAX loader's
        mid-epoch resume)."""
        epoch, offset = divmod(global_step, self.steps_per_epoch())

        def resumed():
            e, first = epoch, offset
            while (self.config.num_epochs is None
                   or e < self.config.num_epochs):
                yield from self._batches(e, first)
                e, first = e + 1, 0

        return resumed()

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def _shard_len(self) -> int:
        """This process's records in one epoch, before padding."""
        if self.config.shard_policy == "file":
            return len(self._file_shards[self.process_index])
        n, p, pc = len(self.source), self.process_index, self.process_count
        return (n - p + pc - 1) // pc

    def steps_per_epoch(self) -> int:
        """The same on every process: whole batches of the smallest shard
        (drop_remainder), else batches covering the largest."""
        if self.config.shard_policy == "file":
            sizes = [len(s) for s in self._file_shards]
            per = min(sizes) if self.config.drop_remainder else max(sizes)
        else:
            n, pc = len(self.source), self.process_count
            per = n // pc if self.config.drop_remainder else -(-n // pc)
        if self.config.drop_remainder:
            return per // self.host_batch_size
        return -(-per // self.host_batch_size)


def HostBatches(source, global_batch_size: int, *,
                seed: int = 0) -> HostDataLoader:
    """The training loader: shuffled, whole batches, epochs forever."""
    return HostDataLoader(source, DataConfig(
        global_batch_size=global_batch_size, seed=seed))


def to_device(batch: dict, device) -> dict:
    """numpy batch → tensors on ``device`` (through pinned memory for a
    CUDA device, so the copy is asynchronous)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


# Batches staged ahead of the step that consumes them.
PREFETCH_DEPTH = 2


def prefetch_to_device(batches: Iterator[dict], device) -> Iterator[dict]:
    """Host batches → device batches, ``PREFETCH_DEPTH`` ahead on a
    thread.

    The thread reads each batch and queues its copy (``to_device``) on
    the device's current stream, so the copy runs in stream order before
    the steps queued after it; the step that consumes a batch is queued
    later still.  Stopping early (break, exception) releases the thread
    and drops the staged batches."""
    q: queue_lib.Queue = queue_lib.Queue(maxsize=PREFETCH_DEPTH)
    end = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_lib.Full:
                continue
        return False

    def producer():
        try:
            for batch in batches:
                if not put(to_device(batch, device)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)
        finally:
            put(end)

    t = threading.Thread(target=producer, daemon=True, name="ttd-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue_lib.Empty:
                break
        t.join(timeout=5)
