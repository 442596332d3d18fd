"""Sequence packing: variable-length documents → fixed [seq] LM rows (a
copy of the JAX package's ``data/packing.py``).

Real corpora are variable-length; TPU training wants static shapes and no
wasted positions.  Packing concatenates documents into fixed-length rows
with three side arrays the model consumes:

- ``segment_ids``  — which document each position belongs to (1-based;
  0 marks padding).  Attention is restricted to same-segment pairs (the
  pallas flash kernel handles this natively via ``SegmentIds``), so a
  packed row trains *identically* to each document alone.
- positions are derived in-model (``segment_relative_positions``): RoPE
  restarts at each document boundary.
- ``loss_weights`` — 1.0 where ``targets`` is a real next-token label,
  0.0 at document-final positions (the "next token" would be the next
  document's first token) and padding.

The reference has no packing story (its corpora are pre-batched fixed
shapes); this is the long-context-first-class piece of the rebuild.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   *, pad_id: int = 0):
    """Greedy sequential packing → list of LM records.

    Documents are laid into rows in order; a document longer than the
    remaining space is split across rows (its continuation keeps a fresh
    segment id — attention never crosses a row boundary anyway).  Each
    record: ``tokens``/``targets`` [seq_len] int32, ``segment_ids``
    [seq_len] int32 (0 = padding), ``loss_weights`` [seq_len] float32.
    Targets are the next token *within* the document; the final position
    of each document (and padding) carries weight 0.
    """
    if seq_len < 2:
        raise ValueError(f"seq_len must be >= 2, got {seq_len}")
    records = []
    row_toks: list[np.ndarray] = []
    row_segs: list[np.ndarray] = []
    row_tgts: list[np.ndarray] = []
    row_wts: list[np.ndarray] = []
    used = 0
    seg = 0

    def flush():
        nonlocal used
        if used == 0:
            return
        pad = seq_len - used
        toks = np.concatenate(row_toks + [np.full(pad, pad_id, np.int32)])
        segs = np.concatenate(row_segs + [np.zeros(pad, np.int32)])
        tgts = np.concatenate(row_tgts + [np.full(pad, pad_id, np.int32)])
        wts = np.concatenate(row_wts + [np.zeros(pad, np.float32)])
        records.append({"tokens": toks, "targets": tgts,
                        "segment_ids": segs, "loss_weights": wts})
        row_toks.clear(), row_segs.clear(), row_tgts.clear(), row_wts.clear()
        used = 0

    def _take(remaining: int, space: int) -> int:
        """Tokens to place now.  Never leaves a 1-token continuation: its
        lone position would carry loss weight 0 (dead packed capacity), so
        the split point moves back one and the continuation keeps a
        labeled next-token pair."""
        take = min(remaining, space)
        if remaining - take == 1:
            take -= 1
        return take

    for doc in docs:
        doc = np.asarray(doc, np.int32).ravel()
        if doc.size < 2:
            # A 1-token document has no next-token pair to learn from.
            continue
        start = 0
        while start < doc.size:
            if used == seq_len:
                flush()
            take = _take(doc.size - start, seq_len - used)
            if take < 2 and doc.size - start >= 2:
                # Don't strand a <2-token piece at a row end (a sliver, or
                # the split-back above) — start a fresh row instead.  In a
                # fresh row take ≥ 2 for seq_len ≥ 3; the seq_len == 2
                # degenerate edge can still yield a labeled 1-token piece.
                flush()
                take = _take(doc.size - start, seq_len)
            piece = doc[start:start + take]
            seg += 1
            row_toks.append(piece)
            row_segs.append(np.full(take, seg, np.int32))
            tgt = np.concatenate([piece[1:], [pad_id]]).astype(np.int32)
            wt = np.ones(take, np.float32)
            if start + take < doc.size:
                # Split mid-document: the true next token exists (the
                # continuation's first token) — keep it as a labeled
                # position; the prefix context is all same-document.
                tgt[-1] = doc[start + take]
            else:
                wt[-1] = 0.0  # document end: "next" is another document
            row_tgts.append(tgt)
            row_wts.append(wt)
            used += take
            start += take
    flush()
    return records


class PackedLmSource:
    """``RandomAccessSource`` over packed documents (packs at open).

    For corpora that fit host memory as token arrays; convert to the mmap
    format for anything bigger.  Deterministic: the packing is a pure
    function of the doc sequence and ``seq_len``.
    """

    def __init__(self, docs: Sequence[np.ndarray], seq_len: int,
                 *, pad_id: int = 0):
        self._records = pack_documents(docs, seq_len, pad_id=pad_id)
        if not self._records:
            raise ValueError("no packable documents (all < 2 tokens?)")
        # O(1) vocab-range validation for launchers: the max id over the
        # packed corpus, tracked here so callers never re-scan it.
        self.max_token_id = max(
            int(r["tokens"].max()) for r in self._records)

    @classmethod
    def from_source(cls, source, seq_len: int, *, key: str = "tokens",
                    pad_id: int = 0) -> "PackedLmSource":
        """Pack variable-length docs out of any ``RandomAccessSource``.

        The natural producer is ``TFRecordSource(paths, features=None)``:
        without a fixed spec it returns each Example's raw flat arrays,
        which is exactly what a varlen tokenized corpus is — so real
        TFRecord document corpora feed packed LM training directly.
        """
        docs = []
        for i in range(len(source)):
            rec = source[i]
            if key not in rec:
                raise KeyError(
                    f"record {i} has no feature {key!r} (has "
                    f"{sorted(rec)}); pass key=/--pack-key naming the "
                    "token feature")
            docs.append(np.asarray(rec[key]).ravel())
        return cls(docs, seq_len, pad_id=pad_id)

    def __len__(self) -> int:
        return len(self._records)

    def __getitem__(self, idx: int):
        if idx < 0 or idx >= len(self._records):
            raise IndexError(idx)
        return self._records[idx]
