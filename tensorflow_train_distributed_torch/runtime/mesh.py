"""Device mesh construction and strategy presets (counterpart of the JAX
package's ``runtime/mesh.py``).

The JAX package runs every strategy as one SPMD program over a named
``jax.sharding.Mesh``; here a mesh is the same named grid of ranks, one
process a device, over ``torch.distributed``.  The axes, their order and
the presets are the JAX package's:

- ``data``     — data parallelism (replicated params, sharded batch);
- ``fsdp``     — data parallelism with parameters and optimizer state
                 sharded over it (the batch is sharded over data×fsdp);
- ``tensor``   — parameter dims ``mlp``/``heads``/``vocab`` sharded;
- ``seq``      — sequence parallelism (ring attention, Ulysses);
- ``expert``   — expert parallelism for MoE layers;
- ``pipeline`` — pipeline stages.

``build_mesh`` returns a ``Mesh``: the axis sizes, this
rank's coordinates, the process group of every axis set the trainer
reduces over, and, where a process group is up, the
``torch.distributed.device_mesh.DeviceMesh`` over the six named axes.
A world of one with no process group builds the same object with no
groups: every collective over it is the identity (``parallel.
collectives``), so one process runs the code many run.

``force_platform``/``set_cpu_device_count`` have no counterpart: the
launcher's ``--device`` picks CUDA or the CPU, and ``--cpu-devices N``
starts N gloo ranks on the CPU (``launch.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

# Canonical axis order: outermost first (the JAX package's AXES).
AXES = ("pipeline", "data", "fsdp", "expert", "seq", "tensor")

# The tensor and fsdp axes shard storage, not compute (``parallel.
# state_plan``): what is left open against the JAX package's GSPMD.
UNSPLIT_COMPUTE = ("ROADMAP Queue 1 step 7 (the Megatron split of the "
                   "products, and ZeRO-3)")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes per logical axis; ``-1`` on at most one axis means "infer".
    ``strategy`` may name a preset (``STRATEGY_PRESETS``)."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipeline: int = 1
    strategy: Optional[str] = None

    def axis_sizes(self) -> dict[str, int]:
        return {
            "pipeline": self.pipeline,
            "data": self.data,
            "fsdp": self.fsdp,
            "expert": self.expert,
            "seq": self.seq,
            "tensor": self.tensor,
        }

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Concrete per-axis sizes for an ``n_devices`` mesh."""
        sizes = self.axis_sizes()
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"At most one axis may be -1, got {unknown}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if unknown:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}"
                )
            sizes[unknown[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"Mesh {sizes} needs {math.prod(sizes.values())} devices, "
                f"have {n_devices}"
            )
        return sizes


STRATEGY_PRESETS: dict[str, MeshConfig] = {
    "dp": MeshConfig(data=-1),
    "mirrored": MeshConfig(data=-1),
    "multi_worker_mirrored": MeshConfig(data=-1),
    "horovod": MeshConfig(data=-1),
    "tpu": MeshConfig(data=-1),
    "fsdp": MeshConfig(data=1, fsdp=-1),
    "dp_fsdp": MeshConfig(data=-1, fsdp=8),
    "dp_tp": MeshConfig(data=-1, tensor=4),
    "dtensor": MeshConfig(data=-1, tensor=4),
    "dp_sp": MeshConfig(data=-1, seq=4),
    "dp_tp_sp": MeshConfig(data=-1, seq=2, tensor=4),
    "fsdp_tp": MeshConfig(data=1, fsdp=-1, tensor=4),
    "dp_ep": MeshConfig(data=-1, expert=4),
    "dp_pp": MeshConfig(data=-1, pipeline=2),
}


def strategy_preset(name: str, n_devices: Optional[int] = None) -> MeshConfig:
    """Look up a preset, shrinking fixed axes to fit small device counts
    (``dp_tp``'s tensor=4 on 2 devices becomes tensor=2)."""
    if name == "ps" or name == "parameter_server":
        raise ValueError(
            "ParameterServerStrategy is not supported: this framework is "
            "SPMD-only. Use --strategy=dp_tp (the DTensor-style mesh the "
            "reference's north star prescribes for the BERT config)."
        )
    if name not in STRATEGY_PRESETS:
        raise ValueError(
            f"Unknown strategy {name!r}; available: "
            f"{sorted(STRATEGY_PRESETS)}"
        )
    cfg = STRATEGY_PRESETS[name]
    if n_devices is None:
        return cfg
    return MeshConfig(strategy=name,
                      **_shrink_sizes(cfg.axis_sizes(), n_devices))


def _shrink_sizes(sizes: dict, n_devices: int) -> dict:
    """Shrink fixed (>1, non-inferred) axes until the mesh fits
    ``n_devices``: halving non-dividers first, then the largest fixed
    axis until the fixed product divides the device count."""
    sizes = dict(sizes)
    fixed_axes = [a for a, s in sizes.items() if s not in (1, -1)]
    for axis in fixed_axes:
        while sizes[axis] > 1 and n_devices % sizes[axis]:
            sizes[axis] //= 2
        sizes[axis] = max(1, min(sizes[axis], n_devices))
    fixed = math.prod(s for s in sizes.values() if s != -1)
    while fixed > n_devices or n_devices % fixed:
        big = max(fixed_axes, key=lambda a: sizes[a], default=None)
        if big is None or sizes[big] == 1:
            break
        sizes[big] //= 2
        fixed = math.prod(s for s in sizes.values() if s != -1)
    return sizes


def degrade_to_fit(config: MeshConfig, n_devices: int) -> MeshConfig:
    """Nearest valid layout for ``config`` on ``n_devices`` devices (the
    elastic relaunch's degrade): fixed axes shrunk as ``strategy_preset``
    shrinks them, an explicit product mismatch absorbed by ``data``.
    Returns ``config`` unchanged when it already resolves."""
    try:
        config.resolve(n_devices)
        return config
    except ValueError:
        pass
    sizes = _shrink_sizes(config.axis_sizes(), n_devices)
    probe = MeshConfig(strategy=config.strategy, **sizes)
    try:
        probe.resolve(n_devices)
    except ValueError:
        sizes["data"] = -1
        probe = MeshConfig(strategy=config.strategy, **sizes)
        probe.resolve(n_devices)  # raises only if truly unsatisfiable
    return probe


def hybrid_shapes(sizes: dict[str, int],
                  dcn_axes: Optional[dict[str, int]],
                  num_slices: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Split per-axis totals into (intra-node, inter-node) shapes: per-dim
    totals = intra × inter, the product of the inter-node dims = the
    number of nodes.  ``dcn_axes`` names how the nodes divide each axis
    (``{"data": 4}``: 4 nodes data-parallel); None puts all of them on
    the outermost data-like axis whose size they divide (tensor and seq
    collectives are never placed across nodes unasked)."""
    if dcn_axes is None:
        for a in ("pipeline", "data", "fsdp", "expert"):
            if sizes[a] >= num_slices and sizes[a] % num_slices == 0:
                dcn_axes = {a: num_slices}
                break
        else:
            raise ValueError(
                f"cannot place {num_slices} slices on any data-like axis "
                f"of {sizes} (tensor/seq are never inferred — their "
                "collectives belong on ICI); pass dcn_axes explicitly")
    if math.prod(dcn_axes.values()) != num_slices:
        raise ValueError(
            f"dcn_axes {dcn_axes} product must equal the slice count "
            f"{num_slices}")
    for a, d in dcn_axes.items():
        if a not in sizes:
            raise ValueError(f"unknown dcn axis {a!r}")
        if d < 1:
            raise ValueError(f"dcn factor for {a!r} must be >= 1, got {d}")
        if sizes[a] % d:
            raise ValueError(
                f"axis {a!r} of size {sizes[a]} not divisible by its DCN "
                f"factor {d}")
    ici = tuple(sizes[a] // dcn_axes.get(a, 1) for a in AXES)
    dcn = tuple(dcn_axes.get(a, 1) for a in AXES)
    return ici, dcn


def _hybrid_order(sizes: dict, dcn_axes: dict) -> list:
    """Rank of each mesh position when ranks are numbered node by node
    (``--dcn``): position index (row-major over ``AXES``) -> rank, each
    node's ranks contiguous and intra-node axes innermost, as
    ``mesh_utils.create_hybrid_device_mesh`` lays slices out."""
    ici, dcn = hybrid_shapes(sizes, dcn_axes, math.prod(dcn_axes.values()))
    per_node = math.prod(ici)
    order = []
    for pos in itertools.product(*(range(sizes[a]) for a in AXES)):
        node = [p // i for p, i in zip(pos, ici)]
        local = [p % i for p, i in zip(pos, ici)]
        node_ix = local_ix = 0
        for n, d in zip(node, dcn):
            node_ix = node_ix * d + n
        for p, i in zip(local, ici):
            local_ix = local_ix * i + p
        order.append(node_ix * per_node + local_ix)
    return order


class Mesh:
    """A named grid of ranks over ``AXES``.

    ``shape`` maps axis to size (the JAX ``mesh.shape``); ``coords`` is
    this rank's position; ``group(axes)`` the process group of the ranks
    that differ from this one only along ``axes`` (None on a world of one
    or a group of one, where every collective is the identity);
    ``index(axes)`` this rank's index inside that group (row-major over
    ``axes`` in ``AXES`` order).  ``device_mesh`` is the
    ``DeviceMesh`` over the six names when a process group is up."""

    def __init__(self, sizes: dict, rank: int = 0, *,
                 device_type: str = "cpu", rank_grid: Optional[list] = None,
                 process_groups: bool = False):
        self.shape = {a: int(sizes[a]) for a in AXES}
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        self.device_type = device_type
        # position (row-major over AXES) -> rank.
        self._grid = (list(range(self.size)) if rank_grid is None
                      else list(rank_grid))
        pos = self._grid.index(self.rank)
        self.coords = {}
        for a in reversed(AXES):
            self.coords[a] = pos % self.shape[a]
            pos //= self.shape[a]
        self.coords = {a: self.coords[a] for a in AXES}
        self._groups: dict = {}
        self.device_mesh = None
        if process_groups:
            self._make_groups()

    def _ranks_along(self, axes: tuple, fixed: dict) -> list:
        """Ranks with the coordinates ``fixed`` off ``axes``, in order."""
        out = []
        for pos in itertools.product(*(range(self.shape[a]) for a in AXES)):
            c = dict(zip(AXES, pos))
            if all(c[a] == fixed[a] for a in AXES if a not in axes):
                ix = 0
                for a in AXES:
                    ix = ix * self.shape[a] + c[a]
                out.append(self._grid[ix])
        return out

    # Axis sets the port reduces over: each axis alone, the batch axes,
    # the batch and seq axes (a step's metrics under sequence
    # parallelism), and every axis (the step's all-ranks finiteness flag).
    GROUP_AXES = tuple((a,) for a in AXES) + (
        ("data", "fsdp"), ("data", "fsdp", "seq"), AXES)

    def _make_groups(self) -> None:
        """Every rank calls ``new_group`` for every group of every axis
        set, in one order (c10d's rule)."""
        import torch.distributed as dist

        made = set()
        for axes in self.GROUP_AXES:
            # An axis set is its axes above 1: sets that differ only in
            # axes of size 1 share one group.
            axes = self._live(axes)
            if not axes or axes in made:
                continue
            made.add(axes)
            others = [a for a in AXES if a not in axes]
            for pos in itertools.product(
                    *(range(self.shape[a]) for a in others)):
                fixed = dict(zip(others, pos))
                fixed.update({a: 0 for a in axes})
                ranks = self._ranks_along(axes, fixed)
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axes] = (g, ranks)
        if dist.is_initialized():
            import numpy as np
            from torch.distributed.device_mesh import DeviceMesh

            grid = np.asarray(self._grid).reshape(
                tuple(self.shape[a] for a in AXES))
            self.device_mesh = DeviceMesh(self.device_type, grid.tolist(),
                                          mesh_dim_names=AXES)

    @staticmethod
    def _key(axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in AXES if a in axes)

    def _live(self, axes) -> tuple:
        return tuple(a for a in self._key(axes) if self.shape[a] > 1)

    def group_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def group(self, axes):
        """The process group along ``axes`` (None where it holds one
        rank, or where no process group is up)."""
        key = self._live(axes)
        if not key:
            return None
        if key not in self._groups:
            if self.size == 1:
                return None
            raise KeyError(f"no process group over {key}; the mesh makes "
                           f"{self.GROUP_AXES}")
        return self._groups[key][0]

    def group_ranks(self, axes) -> list:
        key = self._key(axes)
        fixed = dict(self.coords)
        return self._ranks_along(key, fixed)

    def index(self, axes) -> int:
        """This rank's index inside its group along ``axes``."""
        ix = 0
        for a in self._key(axes):
            ix = ix * self.shape[a] + self.coords[a]
        return ix

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def build_mesh(config: Optional[MeshConfig] = None, *,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device_type: str = "cpu",
               dcn_axes: Optional[dict[str, int]] = None) -> Mesh:
    """Build the named mesh over this job's ranks.

    ``world_size``/``rank`` default to the process group's (1 and 0 where
    none is up).  A bare ``MeshConfig(strategy=...)`` resolves its preset
    against the world so shrink-to-fit applies (``dp_tp`` on one rank is
    1×1).  ``dcn_axes`` (``--dcn``) numbers ranks node by node with the
    named axes across nodes (``hybrid_shapes``)."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if up else 1
    if rank is None:
        rank = dist.get_rank() if up else 0
    if config is None:
        config = MeshConfig(data=-1)
    if config.strategy is not None and all(
        s == 1 for a, s in config.axis_sizes().items() if a != "data"
    ) and config.data == -1:
        config = strategy_preset(config.strategy, world_size)
    sizes = config.resolve(world_size)
    grid = _hybrid_order(sizes, dcn_axes) if dcn_axes else None
    return Mesh(sizes, rank, device_type=device_type, rank_grid=grid,
                process_groups=up)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    return tuple(a for a in ("data", "fsdp") if mesh.shape[a] > 1) or ("data",)


def data_parallel_size(mesh: Mesh) -> int:
    return mesh.shape["data"] * mesh.shape["fsdp"]
