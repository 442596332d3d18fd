"""Row-sharded embedding tables (counterpart of the JAX package's
``ops/embedding.py``): tables looked up by integer feature ids, with
per-feature combiners (sum/mean/sqrtn) and tables shared between
features.

A table is row-sharded over a mesh axis (``table_axis``, default
``tensor``): rank i of the axis holds rows ``[i·V/n, (i+1)·V/n)``.  A
lookup clips the global ids into the rank's range and takes the rows it
owns (zeros elsewhere, ``_local_take``), and one sum over the axis's
group gives every rank the rows.  No rank holds the whole table or
gathers the ids; the traffic is the activation's size.  Negative and
out-of-range ids give zero rows.

Gradients: the table's is the sparse scatter of the rows' cotangents
into the rows each rank owns.  The sum's output is replicated (every
rank holds it and computes the same loss from it), so its backward
counts the cotangent once (``collectives.replicated_output``: divided by
the group's size, then summed), the transpose ``shard_map`` applies to
the JAX body's replicated output.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from tensorflow_train_distributed_torch.parallel import collectives as C


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One embedding table."""

    name: str
    vocab_size: int
    dim: int
    initializer_stddev: float = 1.0


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """One input feature routed to a table; several features may name
    the same table (table sharing).  ``combiner`` reduces the valence dim
    of [B, L] multi-valent inputs; scalar [B] inputs skip combining."""

    name: str
    table: str
    combiner: str = "mean"  # "sum" | "mean" | "sqrtn"


def _combine(rows: torch.Tensor, valid: torch.Tensor,
             combiner: str) -> torch.Tensor:
    """Reduce the valence dim. rows: [B, L, D]; valid: [B, L] bool."""
    w = valid.to(rows.dtype)
    total = torch.einsum("bld,bl->bd", rows, w)
    if combiner == "sum":
        return total
    count = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    if combiner == "mean":
        return total / count
    if combiner == "sqrtn":
        return total / torch.sqrt(count)
    raise ValueError(f"Unknown combiner {combiner!r}")


def _local_take(local_table: torch.Tensor, ids: torch.Tensor,
                shard: int) -> torch.Tensor:
    """Rows this shard owns, zeros elsewhere: global row r lives on shard
    r // rows_per_shard at local row r % rows_per_shard."""
    rows_per_shard = local_table.shape[0]
    local_ids = ids - shard * rows_per_shard
    owned = (local_ids >= 0) & (local_ids < rows_per_shard)
    rows = local_table[local_ids.clamp(0, rows_per_shard - 1)]
    return torch.where(owned[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, *, mesh=None,
                   table_axis: str = "tensor",
                   vocab_size: Optional[int] = None) -> torch.Tensor:
    """Embedding rows for ``ids`` (any integer shape) on this rank.

    ``table`` is the whole table [vocab, dim], or with ``vocab_size``
    this rank's row block of a ``vocab_size``-row table row-sharded over
    ``table_axis``.  Without a mesh that shards ``table_axis`` the lookup
    is a masked take of the whole table.  Out-of-range and negative ids
    give zero rows."""
    n = 1 if mesh is None else mesh.shape.get(table_axis, 1)
    vocab = table.shape[0] if vocab_size is None else int(vocab_size)
    valid = (ids >= 0) & (ids < vocab)
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    if n <= 1:
        if vocab_size is not None and table.shape[0] != vocab:
            raise ValueError(f"a table of {table.shape[0]} rows is not a "
                             f"whole {vocab}-row table")
        return torch.where(valid[..., None], table[safe], zero)
    if vocab % n:
        raise ValueError(
            f"vocab {vocab} not divisible by mesh axis "
            f"{table_axis}={n}")
    shard = mesh.index(table_axis)
    if vocab_size is None:
        table = table.chunk(n, 0)[shard]
    elif table.shape[0] != vocab // n:
        raise ValueError(f"rank's table block has {table.shape[0]} rows, "
                         f"want {vocab // n} of {vocab}")
    group = mesh.group(table_axis)
    rows = C.replicated_output(
        C.psum(_local_take(table, safe, shard), group), group)
    return torch.where(valid[..., None], rows, zero)


class EmbeddingCollection(nn.Module):
    """Feature -> table embedding bank.  ``forward`` takes ``{feature:
    ids}`` ([B] scalar or [B, L] multi-valent with negative padding) and
    returns ``{feature: [B, dim]}``.  On a ``mesh`` that shards
    ``table_axis`` each table parameter holds this rank's row block
    (``init_tables`` / ``load_tables`` cut whole tables); else whole."""

    def __init__(self, tables: Sequence[TableSpec],
                 features: Sequence[FeatureSpec], *,
                 table_axis: str = "tensor", dtype=torch.float32,
                 mesh=None, device=None):
        super().__init__()
        by_name = {t.name: t for t in tables}
        if len(by_name) != len(tables):
            raise ValueError("Duplicate table names")
        for f in features:
            if f.table not in by_name:
                raise ValueError(
                    f"Feature {f.name!r} routes to unknown table {f.table!r}")
        self.specs = by_name
        self.features = tuple(features)
        self.table_axis = table_axis
        self.dtype = dtype
        self.mesh = (mesh if mesh is not None
                     and mesh.shape.get(table_axis, 1) > 1 else None)
        n = 1 if self.mesh is None else self.mesh.shape[table_axis]
        for t in tables:
            if t.vocab_size % n:
                raise ValueError(
                    f"vocab {t.vocab_size} not divisible by mesh axis "
                    f"{table_axis}={n}")
        self.tables = nn.ParameterDict({
            t.name: nn.Parameter(torch.empty(t.vocab_size // n, t.dim,
                                             dtype=torch.float32,
                                             device=device))
            for t in tables})

    def _rows(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return whole
        n = self.mesh.shape[self.table_axis]
        return whole.chunk(n, 0)[self.mesh.index(self.table_axis)]

    @torch.no_grad()
    def load_tables(self, whole: Mapping[str, torch.Tensor]) -> None:
        """Copy this rank's rows of each whole table into its parameter."""
        for name, t in whole.items():
            self.tables[name].copy_(self._rows(name, t))

    @torch.no_grad()
    def init_tables(self, generator: torch.Generator) -> dict:
        """Draw every whole table from N(0, stddev²) in spec order, keep
        this rank's rows, and return the whole tables."""
        whole = {name: torch.randn((s.vocab_size, s.dim),
                                   generator=generator)
                 * s.initializer_stddev for name, s in self.specs.items()}
        self.load_tables(whole)
        return whole

    def forward(self, feature_ids: Mapping[str, torch.Tensor]) -> dict:
        out = {}
        for f in self.features:
            if f.name not in feature_ids:
                continue
            ids = feature_ids[f.name]
            spec = self.specs[f.table]
            table = self.tables[f.table].to(self.dtype)
            scalar = ids.dim() == 1
            ids2d = ids[:, None] if scalar else ids
            rows = sharded_lookup(
                table, ids2d, mesh=self.mesh, table_axis=self.table_axis,
                vocab_size=spec.vocab_size)
            if scalar:
                out[f.name] = rows[:, 0, :]
            else:
                valid = (ids2d >= 0) & (ids2d < spec.vocab_size)
                out[f.name] = _combine(rows, valid, f.combiner)
        return out
