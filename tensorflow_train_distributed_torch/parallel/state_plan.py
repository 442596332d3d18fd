"""Where each piece of the train state lives on a mesh, and the step's
collectives (the port's counterpart of what GSPMD does implicitly in the
JAX ``Trainer``).

Each parameter has a spec (``sharding.make_state_shardings``).  Its
``expert`` axis shards the compute: an MoE block holds only its rank's
experts' stacks (``models.moe.set_expert_parallel``).  Its other axes
(``fsdp``, ``tensor``, and ``data`` under ZeRO-1 or the sharded update)
shard storage: the model computes on the whole parameter, while the
optimizer state and the update live on this rank's piece alone, and the
updated pieces are all-gathered back into the parameter.

A step, after the backward of the local batch's mean loss:

1. the gradients' mean over the batch axes: one flat ``all_reduce`` over
   ``seq`` where the batch's sequences are sharded over it (each rank's
   gradient is of its tokens' share of the loss) and over ``data``,
   then over ``fsdp`` a ``reduce_scatter`` along the dim a
   parameter splits over it (an ``all_reduce`` for the others), divided
   by data × fsdp.  Under ``grad_quant`` the fsdp sum comes first and
   exact, then the int8 error-feedback mean over ``data``
   (``collectives.ef_grad_sync``, or ``ef_bucket_sync`` per bucket of
   ``plan_grad_buckets`` under ``grad_overlap``), as the JAX pipeline is
   manual over ``data`` alone.  Tensor, expert and pipeline ranks hold
   the same batch: nothing is reduced over them (a pipelined model's
   stage-owned layers differ along ``pipeline``; its replicated
   parameters get whole gradients on every stage, ``parallel.pipeline``);
2. under a loss scale, the finiteness of this rank's pieces and-ed over
   every rank (``all_finite``): the pieces differ along the storage and
   expert axes, and every rank takes or skips the step with the others;
3. the optimizer on the pieces, the global norm of a clip summing each
   piece's squares over the ranks holding the others
   (``optimizers.norm_reducer``);
4. the pieces all-gathered back.

On a mesh of one rank (the trainer's when it is given none) nothing is
reduced, split or gathered, and each step above is the identity or the
single-device arithmetic.

Checkpoints hold the whole state (``full_state``: the pieces gathered,
the experts' stacks gathered, a pipelined model's stage-owned layers
gathered from every stage under their own names, the error-feedback
residual as one row per data rank), written by rank 0; ``load_full_state`` cuts it for this rank,
refolding the residual's rows onto another data width
(``sharding.fold_leading_replicas``), so a run saved at one world size
restores at another.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from tensorflow_train_distributed_torch.parallel import collectives as C
from tensorflow_train_distributed_torch.parallel import sharding as S
from tensorflow_train_distributed_torch.runtime import events
from tensorflow_train_distributed_torch.training import optimizers


class StatePlan:
    """The state's layout on ``mesh`` for parameters named ``names`` with
    full shapes ``shapes`` (``{name: shape}``)."""

    def __init__(self, mesh, shapes: dict, *, zero1: bool = False,
                 sharded_update: bool = False,
                 rules=S.DEFAULT_RULES, pipelined: bool = False,
                 seq_sharded: bool = False):
        self.mesh = mesh
        self.names = list(shapes)
        # A pipelined model holds its stage's layers ``layers.<i>.*``.
        self.stage_owned = {
            k: pipelined and mesh.shape["pipeline"] > 1
            and _LAYER.match(k) is not None for k in self.names}
        self.pipelined = any(self.stage_owned.values())
        self.seq_group = mesh.group("seq") if seq_sharded else None
        self.specs = S.make_state_shardings(mesh, shapes, rules)
        ep = mesh.shape["expert"]
        self.expert_dim0 = {
            k: ep > 1 and "expert" in (s[0] or ()) if s else False
            for k, s in self.specs.items()}
        self.local_shapes = {
            k: ((shapes[k][0] // ep,) + tuple(shapes[k][1:])
                if self.expert_dim0[k] else tuple(shapes[k]))
            for k in self.names}
        storage = {k: S.storage_axes(s) for k, s in self.specs.items()}
        if zero1 or sharded_update:
            storage = S.zero1_opt_shardings(mesh, self.local_shapes,
                                            storage)
        self.storage = storage
        # The axes over which a parameter's gradient pieces differ: its
        # storage split, and ``expert`` for a stack the ranks hold a
        # slice of (the router's expert dim is whole on every rank).
        self.norm_axes = {
            k: tuple(a for a in S.AXES
                     if a in S.spec_groups(mesh, storage[k])
                     or (a == "expert" and self.expert_dim0[k])
                     or (a == "pipeline" and self.stage_owned[k]))
            for k in self.names}
        self.split = {k: S.num_pieces(mesh, storage[k]) > 1
                      for k in self.names}
        self.sharded_update = any(self.split.values())
        self.needs_norm_reduce = any(self.norm_axes.values())
        self.n_batch = mesh.group_size(("data", "fsdp"))
        self.trivial = (self.n_batch == 1 and not self.sharded_update
                        and not self.needs_norm_reduce
                        and self.seq_group is None)
        self._axes_by_id: dict = {}
        # The last bucketed sync's buckets, as parameter indices in
        # dispatch order (``sync_grads`` with ``overlap``).
        self.buckets: list = []

    # -- the layout ------------------------------------------------------

    def local_params(self, full: dict) -> dict:
        """This rank's parameters from the full ones: each expert stack
        cut to the rank's experts, everything else whole."""
        m = self.mesh
        return {k: (v.chunk(m.shape["expert"], 0)[m.index("expert")]
                    if self.expert_dim0.get(k) else v)
                for k, v in full.items()}

    def pieces(self, params: list) -> list:
        """The optimizer's view of the parameters: this rank's piece of
        each (a view of its storage, flagged as the parameter is)."""
        if not self.sharded_update:
            return params
        out = []
        for k, p in zip(self.names, params):
            if not self.split[k]:
                out.append(p)
                continue
            v = S.shard(self.mesh, self.storage[k], p.detach())
            out.append(v.requires_grad_(p.requires_grad))
        return out

    def piece_shape(self, k: str) -> tuple:
        shape = list(self.local_shapes[k])
        for d, axes in enumerate(self.storage[k]):
            if axes:
                shape[d] //= self.mesh.group_size(axes)
        return tuple(shape)

    # -- the step --------------------------------------------------------

    def sync_grads(self, grads: list, *, residual: Optional[list] = None,
                   wire: str = "none", overlap: int = 0,
                   device=None) -> tuple:
        """(this rank's piece of each mean gradient, the new residual, the
        data group's finiteness flag under ``wire`` else None, the wire MB
        a rank sent).  ``grads`` are the local batch's, None for frozen
        parameters.  Under ``wire`` the sync is the JAX pipeline's
        ``train/grad_comm`` span: one that ends where the sums are ready
        on ``device``, or with ``overlap`` one a bucket (``bucket=``,
        ``buckets=``) that meters the host; ``self.buckets`` then holds
        the buckets' parameter indices."""
        m = self.mesh
        live = [i for i, g in enumerate(grads) if g is not None]
        out = list(grads)
        dgrp, fgrp = m.group("data"), m.group("fsdp")
        D, F = m.shape["data"], m.shape["fsdp"]
        finite, wire_mb = None, 0.0
        sgrp = self.seq_group
        if wire != "none":
            g = [grads[i].float() for i in live]
            for grp in (sgrp, fgrp):
                if grp is not None:
                    g = [x / C.group_size(grp)
                         for x in _flat_all_reduce(g, grp)]
            r = [residual[i] for i in live]
            if overlap > 1:
                mean, new_r, flags = [None] * len(g), [None] * len(g), []
                buckets = C.plan_grad_buckets(g, overlap)
                self.buckets = [[live[j] for j in b] for b in buckets]
                for b, bucket in enumerate(buckets):
                    mb = C.bucket_sync_wire_bytes(
                        [g[j] for j in bucket], D, wire) / 1e6
                    with events.span("train/grad_comm", wire=wire, mb=mb,
                                     bucket=b, buckets=len(buckets)):
                        bm, br, bf = C.ef_bucket_sync(
                            [g[j] for j in bucket], [r[j] for j in bucket],
                            dgrp, wire=wire)
                    for j, a, b_ in zip(bucket, bm, br):
                        mean[j], new_r[j] = a, b_
                    flags.append(bf)
                    wire_mb += mb
                finite = torch.stack(flags).all()
            else:
                wire_mb = C.grad_sync_wire_bytes(g, D, wire) / 1e6
                with events.device_span("train/grad_comm",
                                        torch.device(device or "cpu"),
                                        wire=wire, mb=wire_mb):
                    mean, new_r, finite = C.ef_grad_sync(g, r, dgrp,
                                                         wire=wire)
            residual = list(residual)
            for j, i in enumerate(live):
                residual[i] = new_r[j]
                out[i] = S.shard(m, self.storage[self.names[i]], mean[j])
            return out, residual, finite, wire_mb
        g = [grads[i].float() for i in live]
        for grp in (sgrp, dgrp):
            if grp is not None:
                g = _flat_all_reduce(g, grp)
        rest = {}
        if fgrp is not None:
            plain = []
            for j, i in enumerate(live):
                spec = self.storage[self.names[i]]
                d = next((d for d, a in enumerate(spec) if a == ("fsdp",)),
                         None)
                if d is None:
                    plain.append(j)
                else:
                    g[j] = C.reduce_scatter(g[j], fgrp, scatter_dim=d)
                    rest[j] = spec[:d] + (None,) + spec[d + 1:]
            if plain:
                for j, x in zip(plain, _flat_all_reduce(
                        [g[j] for j in plain], fgrp)):
                    g[j] = x
        n = D * F * C.group_size(sgrp)
        for j, i in enumerate(live):
            spec = rest.get(j, self.storage[self.names[i]])
            out[i] = S.shard(m, spec, g[j] / n if n > 1 else g[j])
        return out, residual, finite, wire_mb

    def all_finite(self, flag: torch.Tensor) -> torch.Tensor:
        """``flag`` (this rank's gradient pieces are finite) and-ed over
        every rank of the mesh."""
        return C.all_reduce(flag.to(torch.int32), self.mesh.group(S.AXES),
                            op="min").bool()

    def _reduce_norm(self, tensors) -> torch.Tensor:
        parts: dict = {}
        for t in tensors:
            if t is None:
                continue
            axes = self._axes_by_id.get(id(t), ())
            sq = (t.float() * t.float()).sum()
            parts[axes] = parts[axes] + sq if axes in parts else sq
        total = None
        for axes in sorted(parts):
            s = parts[axes]
            for a in axes:
                s = C.all_reduce(s, self.mesh.group(a))
            total = s if total is None else total + s
        return torch.sqrt(total)

    def norm_context(self, grads: list):
        """``optimizers.global_norm`` over pieces held across ranks,
        within the block (a no-op where one rank holds everything)."""
        if not self.needs_norm_reduce:
            return contextlib.nullcontext()
        self._axes_by_id = {id(g): self.norm_axes[k]
                            for k, g in zip(self.names, grads)
                            if g is not None}
        return optimizers.norm_reducer(self._reduce_norm)

    def apply(self, tx, opt_state, params: list, grads: list, *,
              buckets: Optional[list] = None):
        """The optimizer on this rank's pieces, the pieces gathered back
        into the parameters; returns the new optimizer state.  With
        ``buckets`` (parameter indices, ``self.buckets``) each bucket's
        parameters are written under its own ``train/optimizer_apply``
        span, as the JAX bucketed step applies a bucket at a time; the
        update itself is computed once, in bucket 0's span (a clip's
        global norm reads every bucket)."""
        pieces = self.pieces(params)
        parts = buckets or [range(len(params))]
        for b, ix in enumerate(parts):
            with (events.span("train/optimizer_apply", bucket=b,
                              buckets=len(parts)) if buckets
                  else contextlib.nullcontext()):
                if b == 0:
                    with self.norm_context(grads):
                        updates, opt_state = tx.update(grads, opt_state,
                                                       pieces)
                with torch.no_grad():
                    for i in ix:
                        k, p, v, u = (self.names[i], params[i], pieces[i],
                                      updates[i])
                        if u is None:       # a frozen parameter
                            continue
                        v.add_(u)
                        if self.split[k]:
                            p.copy_(S.gather(self.mesh, self.storage[k], v))
        return opt_state

    # -- whole state <-> this rank's state -------------------------------

    def _full_tensor(self, k: str, t: torch.Tensor) -> torch.Tensor:
        t = S.gather(self.mesh, self.storage[k], t.detach())
        if self.expert_dim0[k]:
            t = C.all_gather(t, self.mesh.group("expert"), gather_dim=0)
        return t

    def _local_tensor(self, k: str, t: torch.Tensor) -> torch.Tensor:
        m = self.mesh
        if self.expert_dim0[k]:
            t = t.chunk(m.shape["expert"], 0)[m.index("expert")]
        return S.shard(m, self.storage[k], t).contiguous()

    def _walk(self, node, list_fn):
        """``node`` (the optimizer state) with every per-parameter list
        (one ``list_fn`` answers for: a new list, else None) replaced."""
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            items = list_fn(node)
            if items is not None:
                return type(node)(items)
        if isinstance(node, dict):
            return {k: self._walk(v, list_fn) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [self._walk(v, list_fn) for v in node]
            return (type(node)(*items) if hasattr(node, "_fields")
                    else type(node)(items))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: self._walk(getattr(node, f.name), list_fn)
                for f in dataclasses.fields(node) if f.init})
        return node

    def _map_opt(self, node, live: list, fn):
        """``node`` (the optimizer state) with every per-parameter tensor
        — an element of a list as long as the parameters (or the live
        ones) — replaced by ``fn(name, tensor)``."""
        def list_fn(items):
            if len(items) not in (len(self.names), len(live)):
                return None
            index = (range(len(self.names)) if len(items) == len(self.names)
                     else live)
            return [fn(self.names[i], t) if isinstance(t, torch.Tensor)
                    else self._map_opt(t, live, fn)
                    for i, t in zip(index, items)]
        return self._walk(node, list_fn)

    # -- a pipelined model's stages --------------------------------------

    def _full_names(self) -> tuple:
        """(every name of the whole model in its order, full name ->
        the local name at its place in a stage)."""
        layer = [k for k in self.names if self.stage_owned[k]]
        idx = sorted({int(_LAYER.match(k).group(1)) for k in layer})
        per, first = len(idx), idx[0]
        suffixes = [_LAYER.match(k).group(2) for k in layer
                    if int(_LAYER.match(k).group(1)) == first]
        lo = self.names.index(layer[0])
        hi = self.names.index(layer[-1]) + 1
        full, rep = list(self.names[:lo]), {k: k for k in self.names}
        for g in range(per * self.mesh.shape["pipeline"]):
            for suf in suffixes:
                name = f"layers.{g}.{suf}"
                full.append(name)
                rep[name] = f"layers.{first + g % per}.{suf}"
        return full + list(self.names[hi:]), rep

    def _stage_gather(self, k: str, t: torch.Tensor) -> dict:
        """{the name of the same place on every stage: that stage's
        tensor} for stage-owned ``k`` (collective over ``pipeline``)."""
        m = _LAYER.match(k)
        per = len({_LAYER.match(n).group(1) for n in self.names
                   if self.stage_owned[n]})
        j = int(m.group(1)) % per
        parts = C.all_gather(t.detach()[None], self.mesh.group("pipeline"),
                             gather_dim=0)
        return {f"layers.{s * per + j}.{m.group(2)}": parts[s]
                for s in range(parts.shape[0])}

    def _expand_stages(self, node, live: list, params: dict) -> tuple:
        """(the optimizer state ``node``, ``params``) of this stage made
        whole: each stage-owned entry of a per-parameter list gathered
        from every stage, in the whole model's order."""
        full, rep = self._full_names()

        def expand(names, items) -> list:
            got = {}
            for k, t in zip(names, items):
                if self.stage_owned[k] and isinstance(t, torch.Tensor):
                    got.update(self._stage_gather(k, t))
                else:
                    got[k] = t
            keep = set(names)
            return [got[f] for f in full if rep[f] in keep and f in got]

        def list_fn(items):
            if len(items) == len(self.names):
                return expand(self.names, items)
            if len(items) == len(live):
                return expand([self.names[i] for i in live], items)
            return None

        out = self._walk(node, list_fn)
        names = list(params)
        whole = dict(zip([f for f in full if rep[f] in set(names)],
                         expand(names, [params[k] for k in names])))
        return out, whole

    def _contract_stages(self, node, live: list):
        """The inverse of ``_expand_stages`` on the optimizer state: each
        whole per-parameter list cut to this stage's entries."""
        full, rep = self._full_names()
        local = set(self.names)
        live_full = [f for f in full
                     if self.names.index(rep[f]) in set(live)]

        def list_fn(items):
            for names in (full, live_full):
                if len(items) == len(names):
                    return [t for f, t in zip(names, items) if f in local]
            return None
        return self._walk(node, list_fn)

    def full_state(self, state, live: list):
        """The whole state from every rank's (collective: every rank
        calls it); ``state`` itself on a trivial mesh."""
        if self.trivial and not any(self.expert_dim0.values()) \
                and state.grad_residual is None and not self.pipelined:
            return state
        m = self.mesh
        params = {k: (self._full_tensor(k, p) if self.expert_dim0[k]
                      else p) for k, p in state.params.items()}

        def opt_fn(k, t):
            if tuple(t.shape) != self.piece_shape(k):
                return t
            return self._full_tensor(k, t)

        opt = self._map_opt(state.opt_state, live, opt_fn)
        if self.pipelined:
            if state.grad_residual is not None:
                raise ValueError("grad_quant does not compose with a "
                                 "pipelined model's checkpoints")
            opt, params = self._expand_stages(opt, live, params)
        residual = None
        if state.grad_residual is not None:
            residual = []
            for k, r in zip(self.names, state.grad_residual):
                if r is None:
                    residual.append(None)
                    continue
                if self.expert_dim0[k]:
                    r = C.all_gather(r, m.group("expert"), gather_dim=0)
                residual.append(C.all_gather(r[None], m.group("data"),
                                             gather_dim=0))
        return state.replace(params=params, opt_state=opt,
                             grad_residual=residual)

    def load_full_state(self, full, template):
        """This rank's state from a whole one (``full_state``'s layout):
        parameters copied into ``template``'s (the model's own), the
        optimizer state and the residual cut for this rank."""
        m = self.mesh
        with torch.no_grad():
            for k, p in template.params.items():
                src = full.params[k]
                if self.expert_dim0[k]:
                    src = src.chunk(m.shape["expert"], 0)[m.index("expert")]
                if src is not p:
                    p.copy_(src)

        def opt_fn(k, t):
            full_shape = list(self.local_shapes[k])
            if self.expert_dim0[k]:
                full_shape[0] *= m.shape["expert"]
            if list(t.shape) != full_shape:
                return t
            return self._local_tensor(k, t)

        live = [i for i, p in enumerate(template.params.values())
                if p.requires_grad]
        opt = full.opt_state
        if self.pipelined:
            opt = self._contract_stages(opt, live)
        opt = self._map_opt(opt, live, opt_fn)
        residual = None
        if full.grad_residual is not None:
            residual = []
            for k, r in zip(self.names, full.grad_residual):
                if r is None:
                    residual.append(None)
                    continue
                r = S.fold_leading_replicas(r, m.shape["data"])
                r = r[m.index("data")]
                if self.expert_dim0[k]:
                    r = r.chunk(m.shape["expert"], 0)[m.index("expert")]
                residual.append(r.contiguous())
        return full.replace(params=template.params, opt_state=opt,
                            grad_residual=residual)


_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


def stage_layer(name: str) -> bool:
    """Whether ``name`` is a layer's parameter, which a pipelined model's
    stages own (``layers.<i>.*``)."""
    return _LAYER.match(name) is not None


def _flat_all_reduce(tensors: list, group) -> list:
    """Sum each tensor over ``group`` with one collective on their
    concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = C.all_reduce(flat, group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def mean_metrics(metrics: dict, group) -> dict:
    """The batch group's mean of a step's metrics (device scalars), each
    rank's weighted by its ``loss_weight`` where the task reports one
    (then the total weight); the metrics unchanged on a group of one."""
    if group is None or not metrics:
        return metrics
    names = sorted(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in names])
    w = metrics.get("loss_weight")
    if w is not None:
        wf = w.float().reshape(())
        vals = torch.where(torch.tensor([k == "loss_weight" for k in names],
                                        device=vals.device), vals, vals * wf)
    vals = C.all_reduce(vals, group)
    n = C.group_size(group)
    if w is not None:
        total = vals[names.index("loss_weight")]
        out = {k: (v if k == "loss_weight" else v / total)
               for k, v in zip(names, vals)}
    else:
        out = {k: v / n for k, v in zip(names, vals)}
    return out


def weighted_grad_factor(weight: Optional[torch.Tensor], group
                         ) -> Optional[torch.Tensor]:
    """For a weighted-mean loss: the factor that makes the mean of the
    ranks' scaled gradients the gradient of the global weighted mean
    (``w_local · n / w_total``); None when unweighted or alone."""
    if weight is None or group is None:
        return None
    total = C.all_reduce(weight.float().reshape(()), group)
    return weight.float() * C.group_size(group) / total
