"""Synthetic dataset sources for every reference model config (a copy of
the JAX package's ``data/datasets.py``: framework-free numpy, the same
records for the same seed and index, imports pointing into the port).

The reference ships tf.data builders for MNIST / ImageNet / BERT MLM /
WMT en-de (SURVEY.md §2.1).  This environment has no network and no stored
corpora, so each family gets a *deterministic procedural source*: records are
generated from a per-index PRNG (reproducible, O(1) storage, arbitrarily
large) with enough learnable structure that convergence tests are meaningful
— the role tf.data's in-repo toy datasets played for the reference's smoke
tests.  Real-data ingestion plugs in behind the same ``RandomAccessSource``
protocol.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, idx: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, idx]))


class SyntheticMNIST:
    """28×28×1 digit-like images; label = which quadrant pattern is lit.

    Learnable by LeNet in a few dozen steps — the convergence canary for the
    reference's MNIST MirroredStrategy smoke config.
    """

    def __init__(self, num_examples: int = 60_000, num_classes: int = 10,
                 seed: int = 17):
        self.n, self.num_classes, self.seed = num_examples, num_classes, seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = _rng(self.seed, idx)
        label = idx % self.num_classes
        img = rng.normal(0.1, 0.1, (28, 28, 1)).astype(np.float32)
        # Class-dependent bright stripe: row band at label-th position.
        r0 = 2 + label * 2
        img[r0 : r0 + 3, 4:24, 0] += 1.0
        return {"image": np.clip(img, 0, 1), "label": np.int32(label)}


class SyntheticBlobs:
    """Linearly-separable gaussian blobs — fastest convergence unit fixture."""

    def __init__(self, num_examples: int = 4096, dim: int = 16,
                 num_classes: int = 4, seed: int = 3):
        self.n, self.dim, self.num_classes, self.seed = (
            num_examples, dim, num_classes, seed)
        centers_rng = np.random.default_rng(seed)
        self.centers = centers_rng.normal(0, 3.0, (num_classes, dim)).astype(
            np.float32)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = _rng(self.seed, idx)
        label = idx % self.num_classes
        x = self.centers[label] + rng.normal(0, 0.5, self.dim).astype(np.float32)
        return {"x": x.astype(np.float32), "label": np.int32(label)}


class SyntheticImageNet:
    """224×224×3 images with class-dependent channel statistics (ResNet-50)."""

    def __init__(self, num_examples: int = 1_281_167, num_classes: int = 1000,
                 image_size: int = 224, seed: int = 29,
                 space_to_depth: bool = False):
        self.n, self.num_classes, self.size, self.seed = (
            num_examples, num_classes, image_size, seed)
        # Host-side 2x2 space-to-depth (models.resnet.space_to_depth): the
        # MXU-friendly input layout for the s2d stem, applied before
        # transfer so the device never sees the 3-channel tensor.
        self.space_to_depth = space_to_depth

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = _rng(self.seed, idx)
        label = idx % self.num_classes
        img = rng.normal(0, 1, (self.size, self.size, 3)).astype(np.float32)
        # Class signature: low-frequency pattern seeded by the label only.
        sig = np.random.default_rng(self.seed * 7919 + label)
        basis = sig.normal(0, 1, (8, 8, 3)).astype(np.float32)
        rep = -(-self.size // 8)  # ceil; crop handles non-multiple-of-8 sizes
        upsampled = np.repeat(np.repeat(basis, rep, axis=0), rep, axis=1)
        img += upsampled[: self.size, : self.size]
        if self.space_to_depth:
            s = self.size // 2
            img = (img.reshape(s, 2, s, 2, 3).transpose(0, 2, 1, 3, 4)
                   .reshape(s, s, 12))
        return {"image": img, "label": np.int32(label)}


class SyntheticLM:
    """Causal-LM token streams from a learnable affine recurrence.

    ``t[i+1] = (a*t[i] + b) mod vocab`` with (a, b) drawn per sequence — a
    next-token structure a transformer learns quickly, for Llama SFT and
    decoder throughput/convergence runs.
    """

    def __init__(self, num_examples: int = 100_000, seq_len: int = 512,
                 vocab_size: int = 32_000, seed: int = 41):
        self.n, self.seq_len, self.vocab, self.seed = (
            num_examples, seq_len, vocab_size, seed)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = _rng(self.seed, idx)
        a = int(rng.integers(2, 64))
        b = int(rng.integers(0, self.vocab))
        t0 = int(rng.integers(0, self.vocab))
        toks = np.empty(self.seq_len + 1, np.int32)
        toks[0] = t0
        for i in range(self.seq_len):
            toks[i + 1] = (a * toks[i] + b) % self.vocab
        return {"tokens": toks[:-1], "targets": toks[1:]}


class SyntheticMLM:
    """BERT-style masked-LM records: tokens, 15% masked, target = original.

    Mirrors the reference BERT-base MLM pretrain config's input contract
    (input ids + masked positions + labels).
    """

    MASK_ID = 1

    def __init__(self, num_examples: int = 100_000, seq_len: int = 128,
                 vocab_size: int = 30_522, mask_frac: float = 0.15,
                 seed: int = 53):
        self.n, self.seq_len, self.vocab, self.mask_frac, self.seed = (
            num_examples, seq_len, vocab_size, mask_frac, seed)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = _rng(self.seed, idx)
        # Learnable structure: palindromic halves, so masked tokens are
        # recoverable from context.
        half = rng.integers(2, self.vocab, self.seq_len // 2).astype(np.int32)
        tokens = np.concatenate([half, half[::-1]])
        n_mask = max(1, int(self.seq_len * self.mask_frac))
        pos = rng.choice(self.seq_len, n_mask, replace=False)
        inputs = tokens.copy()
        inputs[pos] = self.MASK_ID
        weights = np.zeros(self.seq_len, np.float32)
        weights[pos] = 1.0
        return {
            "input_ids": inputs,
            "labels": tokens,
            "mask_weights": weights,
        }


class SyntheticWMT:
    """Seq2seq pairs: target = source reversed with a fixed vocab rotation.

    Stands in for WMT en-de in the Transformer-big config; an encoder-decoder
    learns the copy/reverse/rotate mapping quickly.
    """

    BOS = 1
    EOS = 2

    def __init__(self, num_examples: int = 100_000, seq_len: int = 64,
                 vocab_size: int = 32_000, seed: int = 61):
        self.n, self.seq_len, self.vocab, self.seed = (
            num_examples, seq_len, vocab_size, seed)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = _rng(self.seed, idx)
        src = rng.integers(3, self.vocab, self.seq_len - 1).astype(np.int32)
        tgt_core = ((src[::-1] + 7) % self.vocab).astype(np.int32)
        tgt_core[tgt_core < 3] += 3
        src_full = np.concatenate([src, [self.EOS]]).astype(np.int32)
        tgt_in = np.concatenate([[self.BOS], tgt_core]).astype(np.int32)
        tgt_out = np.concatenate([tgt_core, [self.EOS]]).astype(np.int32)
        return {"inputs": src_full, "targets_in": tgt_in,
                "targets_out": tgt_out}


class SliceSource:
    """Contiguous ``[start, stop)`` view of another source.

    The building block for held-out train/validation splits (Keras
    ``validation_split`` analog): both views share the underlying records
    with no copying, and each is a full ``RandomAccessSource``.
    """

    def __init__(self, source, start: int, stop: int):
        n = len(source)
        if not (0 <= start <= stop <= n):
            raise ValueError(
                f"invalid slice [{start}, {stop}) of a {n}-record source")
        self.source, self.start, self.stop = source, start, stop

    def __len__(self) -> int:
        return self.stop - self.start

    def __getitem__(self, idx: int):
        return self.get_record(idx, 0)

    def get_record(self, idx: int, epoch: int = 0):
        """Indexed fetch with the epoch threaded through the view —
        ``--eval-split`` wrapping must not freeze per-epoch augmentation
        (``pipeline.fetch_record`` semantics)."""
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        from tensorflow_train_distributed_torch.data.pipeline import (
            fetch_record,
        )

        return fetch_record(self.source, self.start + idx, epoch)

    @property
    def epoch_aware(self) -> bool:
        return getattr(self.source, "epoch_aware", False)


def train_val_split(source, val_fraction: float, *, min_val: int = 1,
                    min_train: int = 1):
    """Split a source into (train, holdout-tail) views.

    The tail — never the head — is held out so the training prefix is a
    stable function of the source regardless of the fraction.  ``min_val``
    and ``min_train`` (typically both the global batch size) guarantee each
    side can fill at least one batch — a split that can't is a config
    error, not a silent empty loader.
    """
    if not 0.0 < val_fraction < 1.0:
        raise ValueError(f"val_fraction must be in (0, 1), got {val_fraction}")
    n = len(source)
    n_val = max(int(n * val_fraction), min_val)
    cut = n - n_val
    if cut < min_train:
        raise ValueError(
            f"validation split of {n_val} leaves {max(cut, 0)} training "
            f"records < required {min_train} (source has {n}); shrink "
            "--eval-split or the batch size")
    return SliceSource(source, 0, cut), SliceSource(source, cut, n)


def _array_dir(root: str, transform=None):
    """On-disk mmap corpus (``filesource.write_shards`` layout)."""
    from tensorflow_train_distributed_torch.data.filesource import open_sharded

    return open_sharded(root, transform=transform)


def _tfrecord_dir(root: str, transform=None, on_corrupt: str = "raise"):
    """Directory of ``*.tfrecord`` files + ``features.json`` sidecar."""
    from tensorflow_train_distributed_torch.data.tfrecord import (
        open_tfrecord_dir,
    )

    return open_tfrecord_dir(root, transform=transform,
                             on_corrupt=on_corrupt)


_REGISTRY = {
    "mnist": SyntheticMNIST,
    "blobs": SyntheticBlobs,
    "imagenet": SyntheticImageNet,
    "lm": SyntheticLM,
    "mlm": SyntheticMLM,
    "wmt": SyntheticWMT,
    "array_dir": _array_dir,
    "tfrecord_dir": _tfrecord_dir,
}


def get_dataset(name: str, **kwargs):
    if name not in _REGISTRY:
        raise ValueError(f"Unknown dataset {name!r}; available: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
