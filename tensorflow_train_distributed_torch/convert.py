"""Weights for the port: carried over from a flax variable tree, or made
at random from a seed.

The port's parameter names and layouts follow flax's: a flax path
``a/b/c`` becomes ``a.b.c``, the unrolled ``layer_{i}/…`` and the scanned
``layers/stack/block/…`` trees both become ``layers.{i}.…``, and every
array keeps its flax layout — dense kernels ``[in, out]``, the embedding
``[vocab, d_model]``, norm scales and biases ``[d]`` (named ``scale`` and
``bias``, as flax names them), the MoE experts' stacked kernels
``[E, in, out]`` (``layer_{i}/moe/experts/wi_gate/kernel`` →
``layers.{i}.moe.experts.wi_gate.kernel``) — except conv kernels, which
go from flax's HWIO to torch's OIHW.  A LoRA model (``LlamaConfig.lora``)
holds its adapters under flax's names too (``…/query/lora_a`` [in, r],
``…/query/lora_b`` [r, out], f32), so they carry across like any leaf.  BatchNorm's running statistics
(flax's ``batch_stats`` collection) are the model's buffers: a flat key
``batch_stats/a/b/mean`` becomes the buffer ``a.b.mean``, and the train
state names them back (``model_state_names``).  ``--params-npz`` files
hold the flat flax dict (``flax.traverse_util.flatten_dict(params,
sep="/")`` saved with ``np.savez``, plus any ``batch_stats/…`` keys).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from tensorflow_train_distributed_torch.models import layers as L

_SCANNED = "layers/stack/block/"
_UNROLLED = re.compile(r"^layer_(\d+)/(.*)$")
BATCH_STATS = "batch_stats/"


def _meta_model(config):
    """The port's model for a config (its task's ``model``), without
    storage."""
    from tensorflow_train_distributed_torch.models import registry

    return registry.make_task({"config": config}, device="meta").model


def model_state_names(model) -> dict:
    """``{state name: buffer name}`` of the model's persistent buffers
    (BatchNorm's running statistics): ``stem_bn.mean`` is
    ``batch_stats/stem_bn/mean`` in the train state, as in flax."""
    params = {k for k, _ in model.named_parameters()}
    return {BATCH_STATS + k.replace(".", "/"): k
            for k in model.state_dict() if k not in params}


def expected_shapes(config) -> dict:
    """``{name: shape}`` of every parameter (and persistent buffer) the
    port's model holds."""
    model = _meta_model(config)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def params_from_flax(flat: dict, config) -> dict:
    """Flat flax params (``{"a/b/c": array}``, either layer layout, plus
    ``batch_stats/…`` keys for a BatchNorm model) → the port's ``{name:
    tensor}`` on the CPU (its ``state_dict`` keys), dtypes kept, conv
    kernels HWIO → OIHW.  Raises on a missing, extra or misshapen key."""
    want = expected_shapes(config)
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if key.startswith(BATCH_STATS):
            key = key[len(BATCH_STATS):]
        elif key.endswith("kernel") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        if key.startswith(_SCANNED):
            rest = key[len(_SCANNED):].replace("/", ".")
            if arr.shape[:1] != (config.num_layers,):
                raise ValueError(f"scanned leaf {key} has leading axis "
                                 f"{arr.shape[:1]}, expected "
                                 f"({config.num_layers},)")
            for i in range(config.num_layers):
                out[f"layers.{i}.{rest}"] = arr[i]
            continue
        m = _UNROLLED.match(key)
        name = (f"layers.{m.group(1)}.{m.group(2).replace('/', '.')}" if m
                else key.replace("/", "."))
        out[name] = arr
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise ValueError(f"flax params do not match the {config} model: "
                         f"missing {missing}, extra {extra}")
    for name, arr in out.items():
        if tuple(arr.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{want[name]}")
    return {name: _to_torch(arr) for name, arr in out.items()}


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        # numpy's bf16 (ml_dtypes) is unknown to torch: go through f32,
        # which holds every bf16 value exactly.
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))    # a writable copy


def load_npz(path: str, config) -> dict:
    """``params_from_flax`` of an ``np.savez`` of the flat flax dict."""
    with np.load(path) as f:
        return params_from_flax({k: f[k] for k in f.files}, config)


def init_params(config, generator: torch.Generator, *,
                device="cuda", dtype=None) -> dict:
    """Random weights (and initial buffers) made from ``generator``
    directly on ``device``, in ``dtype`` (default ``config.dtype``, f32
    for the vision models), with the JAX package's initialisers:
    embedding N(0, 1), dense kernels N(0, 1/fan_in) (flax's lecun_normal,
    untruncated here; fan_in is ``shape[-2]``, so an expert-stacked
    ``[E, in, out]`` kernel draws each expert as its own ``[in, out]``, as
    ``lecun_normal(batch_axis=(0,))`` does), biases zero, norm scales one
    (zero for a zero-centered norm), and each module's own
    ``init_spec()`` where it has one (conv kernels' variance scaling,
    BatchNorm's statistics and zero-init scales, BERT's 0.02 position
    tables, ResNet's zero head, LoRA's normal(0.02) ``lora_a`` and zero
    ``lora_b``).  ``generator`` must live on ``device``."""
    dtype = dtype or getattr(config, "dtype", torch.float32)
    params = {}
    model = _meta_model(config)
    # A zero-centered norm computes x̂·(1 + scale): its scale starts at 0.
    spec = {f"{name}.scale": ("fill", 0.0)
            for name, m in model.named_modules()
            if isinstance(m, L.RMSNorm) and m.zero_centered}
    for name, m in model.named_modules():
        if hasattr(m, "init_spec"):
            prefix = f"{name}." if name else ""
            spec.update({prefix + k: v for k, v in m.init_spec().items()})
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        rule = spec.get(name)
        if rule is None:
            if name.endswith(".scale"):
                rule = ("fill", 1.0)
            elif name.endswith(".bias"):
                rule = ("fill", 0.0)
            else:
                rule = ("normal", 1.0 if name.endswith("embedding")
                        else 1 / math.sqrt(shape[-2]))
        if rule[0] == "fill":
            t = torch.full(shape, rule[1], dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32).mul_(rule[1]).to(dtype)
        params[name] = t
    return params
