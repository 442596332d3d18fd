"""Pipeline parallelism: GPipe-style microbatched stages over a mesh axis
(counterpart of the JAX package's ``parallel/pipeline.py``).

The schedule is the JAX one: every rank of the ``pipeline`` group holds
one stage's parameters and runs the same loop of ``M + S - 1`` ticks
(M microbatches, S stages).  Each tick, every rank

1. selects its input: microbatch ``t`` on stage 0 (clamped in the bubble
   tail, where the work is dead), the activation received from its
   predecessor elsewhere;
2. applies its stage;
3. passes its output one stage forward (``collectives.ring_permute``).

The last stage's ticks ``S-1 .. T-1`` are its outputs for microbatches
``0 .. M-1``; one masked sum-broadcast (``collectives.broadcast_from``)
gives them to every rank, and the loss downstream is computed the same
on all of them.

The backward needs no scheduler: it is autograd through the tick loop,
with each hop's transpose carrying the activation cotangents a stage
back.  Every rank builds the same graph: the input is chosen with
``torch.where`` on a flag (not a Python branch on the stage), the stage
function runs the same layers' code on every stage, and each tick makes
the same collectives in the same order.  A single-device autograd engine
runs a graph's nodes in an order fixed by the graph, so the backward's
collectives (one rotation a tick, in reverse tick order, and the
broadcast's sum) meet in the same order on every rank.  The batch enters
replicated over the group and leaves replicated: its cotangent is summed
over the stages (only stage 0 consumes it) and the output's counted once
(``collectives.replicated_input`` / ``replicated_output``), the
transposes ``shard_map`` applies to unmapped inputs and outputs, so
parameters used outside the pipeline get whole gradients on every stage.

Every stage maps activations of one shape and dtype to the same.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from tensorflow_train_distributed_torch.parallel import collectives as C


def num_pipeline_ticks(num_microbatches: int, num_stages: int) -> int:
    """Schedule length: M microbatches + (S-1) bubble ticks."""
    return num_microbatches + num_stages - 1


def _map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a tuple/list/dict tree (None
    leaves stay None)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _map(lambda t: out.append(t), tree)
    return out


def _take_stage(params, stage: int, keep_dim: bool):
    return _map(lambda x: x[stage:stage + 1] if keep_dim else x[stage],
                params)


def pipeline_stages(stage_fn: Callable[[Any, Any], Any], stage_params: Any,
                    microbatches: Any, *, group=None,
                    unstack_params: bool = True) -> Any:
    """Run the microbatch pipeline on this rank of ``group``.

    Args:
      stage_fn: ``(params_one_stage, activation) -> activation``.
      stage_params: this rank's stage parameters, leading dim 1 (the
        rank's slice of the stacked tree).
      microbatches: ``[M, mb, ...]`` tree (tensors, or None leaves) of
        this rank's microbatches, the same on every stage.
      group: the pipeline axis's process group (None: one stage).
      unstack_params: strip the leading stage dim; ``False`` passes the
        slice intact (``gpipe_layers``' layer groups).

    Returns the ``[M, mb, ...]`` outputs, on every rank.
    """
    params = (_map(lambda x: x[0], stage_params) if unstack_params
              else stage_params)
    stage = C.group_rank(group)
    num_stages = C.group_size(group)
    microbatches = _map(lambda m: C.replicated_input(m, group), microbatches)
    num_micro = _leaves(microbatches)[0].shape[0]
    ticks = num_pipeline_ticks(num_micro, num_stages)
    dev = _leaves(microbatches)[0].device
    first = torch.tensor(stage == 0, device=dev)

    act = _map(lambda m: torch.zeros(m.shape[1:], dtype=m.dtype,
                                     device=m.device), microbatches)
    outs = []
    for t in range(ticks):
        feed = _map(lambda m: m[min(t, num_micro - 1)], microbatches)
        inp = _map(lambda f, a: torch.where(first, f, a), feed, act)
        out = stage_fn(params, inp)
        outs.append(out)
        if t < ticks - 1:
            # Every stage's output one hop down the ring; stage 0
            # receives the last stage's and replaces it with the next
            # microbatch.
            act = _map(lambda o: C.ring_permute(o, group, shift=1), out)
    # Ticks S-1 .. T-1 on the last stage are microbatches 0 .. M-1.
    stacked = _map(lambda *o: torch.stack(o), *outs[num_stages - 1:])
    return _map(lambda o: C.replicated_output(
        C.broadcast_from(o, group, num_stages - 1), group), stacked)


def _stage_group(mesh, axis: str):
    return mesh.group(axis), mesh.shape[axis], mesh.index(axis)


def gpipe(stage_fn: Callable[[Any, Any], Any], stacked_params: Any,
          batch: Any, *, mesh, num_microbatches: int,
          axis: str = "pipeline", batch_axes: Sequence[str] = (),
          unstack_params: bool = True) -> Any:
    """Microbatch ``batch`` and run the whole pipeline on this rank.

    ``stacked_params`` leaves carry a leading ``num_stages`` dim (built
    with ``init_stage_params``); this rank takes its stage's slice.
    ``batch`` is this rank's rows ``[B, ...]`` (under ``batch_axes`` its
    data-parallel shard, the same on every stage), split into
    ``num_microbatches`` equal microbatches.  Returns ``[B, ...]``.
    Differentiable."""
    del batch_axes  # the rows are already this rank's
    group, _, stage = _stage_group(mesh, axis)
    bsz = _leaves(batch)[0].shape[0]
    if bsz % num_microbatches:
        raise ValueError(
            f"batch size {bsz} not divisible by "
            f"num_microbatches={num_microbatches}")
    micro = _map(lambda x: x.reshape(num_microbatches,
                                     bsz // num_microbatches,
                                     *x.shape[1:]), batch)
    local = _take_stage(stacked_params, stage, keep_dim=True)
    out = pipeline_stages(stage_fn, local, micro, group=group,
                          unstack_params=unstack_params)
    return _map(lambda o: o.reshape(bsz, *o.shape[2:]), out)


def gpipe_layers(layer_fn: Callable[[Any, Any], Any], stacked_params: Any,
                 batch: Any, *, mesh, num_microbatches: int,
                 axis: str = "pipeline",
                 batch_axes: Sequence[str] = ()) -> Any:
    """GPipe where each stage holds a contiguous group of layers:
    ``stacked_params`` leaves carry a leading ``num_layers`` dim, which
    must divide over the axis; stage s applies layers
    ``s·L/S .. (s+1)·L/S - 1`` in order each tick.
    ``layer_fn(params_one_layer, act) -> act``."""
    num_stages = mesh.shape[axis]
    num_layers = _leaves(stacked_params)[0].shape[0]
    if num_layers % num_stages:
        raise ValueError(
            f"num_layers={num_layers} not divisible by the {axis} axis "
            f"size {num_stages}")
    per = num_layers // num_stages
    grouped = _map(lambda x: x.reshape(num_stages, per, *x.shape[1:]),
                   stacked_params)

    def stage_fn(local_params, h):
        # local_params: this stage's [1, L/S, ...] slice, in depth order.
        for i in range(per):
            h = layer_fn(_map(lambda x: x[0, i], local_params), h)
        return h

    return gpipe(stage_fn, grouped, batch, mesh=mesh,
                 num_microbatches=num_microbatches, axis=axis,
                 batch_axes=batch_axes, unstack_params=False)


def init_stage_params(init_fn: Callable[[torch.Generator], Any],
                      generator: torch.Generator, num_stages: int) -> Any:
    """Stack per-stage params: ``init_fn(generator) -> params`` called
    ``num_stages`` times in order, the results stacked on a leading stage
    dim (the JAX ``vmap`` over split keys)."""
    per = [init_fn(generator) for _ in range(num_stages)]
    return _map(lambda *xs: torch.stack(xs), *per)
