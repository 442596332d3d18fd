"""Multi-device parallelism over ``torch.distributed``: the named
collectives, the logical-axis sharding rules and the train state's
layout on a mesh."""
