"""Post-training int8 weight-only quantization for serving.

Counterpart of the JAX package's ``models/quant.py`` over the port's flat
``{state_dict name: tensor}`` layout.  ``quantize_params`` replaces every
floating ``...kernel`` of ndim 2 or 3 (dense ``[in, out]`` kernels and
expert-stacked ``[E, in, out]`` ones) with a symmetric int8 tensor and
returns the scales beside it: one f32 scale per output channel, keyed
``...scale`` where the kernel is ``...kernel`` (``[out]``, or ``[E, out]``
for a stacked kernel).  Embeddings, norms, biases and conv filters stay
as they are.  ``models.generate(..., quant_scales=)`` and
``ServingEngine(..., quant_scales=)`` take the pair: every quantized
``layers.Dense`` computes ``(x @ q) * scale (+ bias)`` in its dtype, and
the MoE dense dispatch scales each expert's product the same way.

The products run as ``torch.matmul`` on the kernel converted to the
compute dtype, as the JAX package's run as XLA ``dot_general`` outside
any Pallas kernel; here the converted copy is materialised before each
product (JAX counts on XLA fusing the convert into the matmul's read).

Error bound: symmetric per-channel round-to-nearest gives ``|w - q*s| <=
s/2`` with ``s = max|w_col| / 127``.
"""

from __future__ import annotations

from typing import Optional

import torch

# Kernel ranks eligible for quantization: dense kernels [in, out] and
# expert-stacked [E, in, out]; conv kernels (4-D) stay as they are.
QUANT_NDIMS = (2, 3)


def eligible(name: str, w: torch.Tensor) -> bool:
    """Whether ``name``'s tensor is a kernel ``quantize_params`` turns
    into int8."""
    return (name.rsplit(".", 1)[-1] == "kernel" and w.dim() in QUANT_NDIMS
            and w.is_floating_point())


def scale_name(kernel_name: str) -> str:
    """The scale's key beside its kernel: ``a.b.kernel`` -> ``a.b.scale``."""
    return kernel_name.rsplit(".", 1)[0] + ".scale"


def quantize_tensor(w: torch.Tensor):
    """(int8 codes, f32 scale) of one kernel: ``amax`` over the input axis
    (-2), ``scale = amax / 127`` where ``amax > 0`` else 1, codes
    ``clip(round(w / scale), -127, 127)`` (round half to even).  Works on
    any device, one tensor at a time."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)), -127, 127)
    return q.to(torch.int8), scale


def quantize_params(params: dict, *, bits: int = 8):
    """Quantize the matmul kernels of ``params`` to int8.  Returns
    ``(qparams, scales)``: ``qparams`` with every eligible kernel replaced
    by its int8 codes and every other tensor unchanged, ``scales`` the
    ``{name.scale: f32 tensor}`` beside them."""
    if bits != 8:
        raise ValueError(f"only int8 supported, got bits={bits}")
    qparams, scales = {}, {}
    for name, w in params.items():
        if eligible(name, w):
            qparams[name], scales[scale_name(name)] = quantize_tensor(w)
        else:
            qparams[name] = w
    if not scales:
        raise ValueError(
            "no eligible matmul kernels found to quantize (expected "
            "'kernel' leaves of ndim 2/3; was this tree already "
            "quantized, or boxed? pass nn.unbox-ed params)")
    return qparams, scales


def dequantize_params(qparams: dict, scales: dict) -> dict:
    """Inverse transform: int8 kernels back to f32 (for tests and
    tools)."""
    out = {}
    for name, w in qparams.items():
        s = scales.get(scale_name(name))
        if name.endswith("kernel") and s is not None:
            out[name] = w.float() * s.unsqueeze(-2)
        else:
            out[name] = w
    return out


def quantized_bytes(params: dict) -> int:
    """Total parameter bytes (int8 kernels count one byte each)."""
    return sum(t.element_size() * t.numel() for t in params.values())


def check_quant_pairing(params: dict, quant_scales: Optional[dict]) -> None:
    """int8 kernels and their scales travel together: either mistake
    (unscaled int8 products, or scales on full-precision kernels) gives
    plausibly shaped garbage.  Shared by ``generate()`` and the serving
    engine."""
    has_int8 = any(t.dtype == torch.int8 for t in params.values())
    if has_int8 != (quant_scales is not None):
        raise ValueError(
            "int8 params and quant_scales must be passed together: got "
            f"int8 kernels={has_int8}, quant_scales="
            f"{'set' if quant_scales is not None else 'None'} "
            "(both come from models.quant.quantize_params)")


def attach_scales(model: torch.nn.Module, quant_scales: dict,
                  device) -> None:
    """Give each int8 kernel of ``model`` its scale (the ``scale`` buffer
    of its ``layers.Dense`` or expert stack).  Raises when a scale names
    no int8 kernel, has the wrong shape, or an int8 kernel has none."""
    for name, s in quant_scales.items():
        path, leaf = name.rsplit(".", 1)
        try:
            mod = model.get_submodule(path) if leaf == "scale" else None
        except AttributeError:
            mod = None
        kernel = getattr(mod, "kernel", None)
        if kernel is None or kernel.dtype != torch.int8 or (
                "scale" not in mod._buffers):
            raise ValueError(f"quant scale {name} has no int8 kernel")
        want = tuple(kernel.shape[:-2]) + tuple(kernel.shape[-1:])
        if tuple(s.shape) != want:
            raise ValueError(f"quant scale {name}: shape {tuple(s.shape)} "
                             f"!= {want}")
        mod.scale = s.to(device=device, dtype=torch.float32)
    for path, mod in model.named_modules():
        kernel = getattr(mod, "kernel", None)
        if (isinstance(kernel, torch.Tensor) and kernel.dtype == torch.int8
                and mod._buffers.get("scale") is None):
            raise ValueError(f"int8 kernel {path}.kernel has no quant "
                             f"scale")
