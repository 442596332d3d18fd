"""Multi-device parallelism over ``torch.distributed``: the named
collectives, the logical-axis sharding rules and the train state's
layout on a mesh, sequence parallelism (``ring_attention``: ring and
Ulysses attention) and the GPipe pipeline (``pipeline``).  The exports
are the JAX ``parallel`` package's, less ``logical_sharding``/
``with_logical_rules`` (flax constraints; the port's spec is
``sharding.logical_spec``), plus the differentiable hops."""

from tensorflow_train_distributed_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    all_reduce,
    all_to_all,
    allreduce_bus_bandwidth,
    broadcast_from,
    broadcast_from_coordinator,
    dequantize_q8,
    ef_grad_sync,
    grad_sync_wire_bytes,
    psum,
    q8_all_reduce,
    quantize_q8,
    reduce_scatter,
    replicated_input,
    replicated_output,
    ring_permute,
)
from tensorflow_train_distributed_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    cross_replica_update_shardings,
    logical_spec,
    make_state_shardings,
    shard_batch,
    shard_batch_spec,
    zero1_opt_shardings,
)
