"""Host batches and their copy to the device (the single-process subset of
the JAX package's ``data/pipeline.py``).

``HostBatches`` walks a random-access source in the JAX
``HostDataLoader``'s order: per epoch a permutation drawn from
``SeedSequence([seed, epoch])``, whole batches only (drop remainder),
epochs repeating forever.  The same
source, batch size and seed give the JAX loader's batches, which is what
the parity tests feed both trainers.  ``to_device`` copies a numpy batch
host → pinned → device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class HostBatches:
    def __init__(self, source, global_batch_size: int, *, seed: int = 0):
        self.source = source
        self.batch_size = global_batch_size
        self.seed = seed
        if self.steps_per_epoch() == 0:
            raise ValueError(
                f"source yields 0 batches/epoch: {len(source)} records < "
                f"batch size {global_batch_size}")

    def steps_per_epoch(self) -> int:
        return len(self.source) // self.batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed,
                                                             epoch]))
        return rng.permutation(len(self.source))

    def __iter__(self) -> Iterator[dict]:
        epoch = 0
        while True:
            order = self._epoch_order(epoch)
            for b in range(self.steps_per_epoch()):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                records = [self.source[int(i)] for i in idx]
                yield {k: np.stack([r[k] for r in records])
                       for k in records[0]}
            epoch += 1


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
