"""Weights for the port: carried over from a flax parameter tree, or made
at random from a seed.

The port's parameter names and layouts follow flax's: a flax path
``a/b/c`` becomes ``a.b.c``, the unrolled ``layer_{i}/…`` and the scanned
``layers/stack/block/…`` trees both become ``layers.{i}.…``, and every
array keeps its flax layout — dense kernels ``[in, out]``, the embedding
``[vocab, d_model]``, norm scales ``[d]``.  ``--params-npz`` files hold
the flat flax dict (``flax.traverse_util.flatten_dict(params, sep="/")``
saved with ``np.savez``).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from tensorflow_train_distributed_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
)

_SCANNED = "layers/stack/block/"
_UNROLLED = re.compile(r"^layer_(\d+)/(.*)$")


def expected_shapes(config: LlamaConfig) -> dict:
    """``{name: shape}`` of every parameter the port's model holds."""
    model = LlamaModel(config, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def params_from_flax(flat: dict, config: LlamaConfig) -> dict:
    """Flat flax params (``{"a/b/c": array}``, either layer layout) →
    the port's ``{name: tensor}`` on the CPU, dtypes kept.  Raises on a
    missing, extra or misshapen key."""
    want = expected_shapes(config)
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
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
        raise ValueError(f"flax params do not match the {config} decoder: "
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


def load_npz(path: str, config: LlamaConfig) -> dict:
    """``params_from_flax`` of an ``np.savez`` of the flat flax dict."""
    with np.load(path) as f:
        return params_from_flax({k: f[k] for k in f.files}, config)


def init_params(config: LlamaConfig, generator: torch.Generator, *,
                device="cuda", dtype=None) -> dict:
    """Random weights made from ``generator`` directly on ``device``, in
    ``dtype`` (default ``config.dtype``), with the JAX package's
    initialisers: embedding N(0, 1), dense kernels N(0, 1/fan_in) (flax's
    lecun_normal, untruncated here), biases zero, norm scales one (zero
    when ``norm_zero_centered``).  ``generator`` must live on ``device``."""
    dtype = dtype or config.dtype
    params = {}
    for name, shape in expected_shapes(config).items():
        if name.endswith(".scale"):
            fill = 0.0 if config.norm_zero_centered else 1.0
            t = torch.full(shape, fill, dtype=dtype, device=device)
        elif name.endswith(".bias"):
            t = torch.zeros(shape, dtype=dtype, device=device)
        else:
            std = 1.0 if name.endswith("embedding") else 1 / math.sqrt(
                shape[0])
            t = torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32).mul_(std).to(dtype)
        params[name] = t
    return params
