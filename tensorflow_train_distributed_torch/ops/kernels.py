"""The serving path's hand-written Hopper kernels and their plain versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py``.  Each kernel
has two faces with one signature and layout (the JAX function's):

- ``rms_norm`` / ``paged_kv_gather`` / ``paged_attention``: the wrapper.
  On a CUDA tensor it launches the CUDA kernel from ``csrc/`` (built and
  loaded by ``ops.cuda_build``) on the current stream, or raises; it never
  falls back.  On a CPU tensor it computes the plain version, because that
  is where the tensor lies (the CPU tests).
- ``*_reference``: plain PyTorch, the oracle the kernels are held against
  on the card and the math the CPU path runs.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else, so a run can show that its main path went through the
kernels (``reset_launch_counts`` / ``launch_counts``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tensorflow_train_distributed_torch.ops.attention import (
    dot_product_attention,
)

LAUNCHES = {"rms_norm": 0, "paged_attention": 0, "paged_kv_gather": 0}

# Element-type codes shared with csrc/common.cuh (ttd::DType).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on sm_90


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    all lie on one CUDA device (kernel); raises otherwise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"{name}: tensors must all lie on the CPU or on one "
                     f"CUDA device, got {sorted(map(str, devices))}")


def _check(name: str, t: torch.Tensor, what: str, dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {what} dtype {t.dtype} not in "
                        f"{sorted(map(str, dtypes))}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _raise_on(name: str, rc: int) -> None:
    if rc:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {rc})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# RMSNorm (K1f)
# ---------------------------------------------------------------------------


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor, *,
                       epsilon: float = 1e-5) -> torch.Tensor:
    """Plain version (``models.layers.RMSNorm`` numerics, f32 accumulation)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + epsilon)
    return (y * scale.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             epsilon: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm.  ``x``: [..., D] f32/bf16; ``scale``: [D]."""
    if _on_cpu("rms_norm", x, scale):
        return rms_norm_reference(x, scale, epsilon=epsilon)
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    floats = (torch.float32, torch.bfloat16)
    _check("rms_norm", x, "x", floats)
    _check("rms_norm", scale, "scale", floats)
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rms_norm: scale shape {tuple(scale.shape)} != "
                         f"({d},)")
    y = torch.empty_like(x)
    n = x.numel() // d if d else 0
    if n == 0:
        return y
    rc = library().ttd_rms_norm_fwd(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), n, d, epsilon,
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], _stream())
    _raise_on("rms_norm", rc)
    LAUNCHES["rms_norm"] += 1
    return y


# ---------------------------------------------------------------------------
# Paged KV gather (K5)
# ---------------------------------------------------------------------------


def paged_kv_gather_reference(pool: torch.Tensor, table: torch.Tensor,
                              cache_len: int) -> torch.Tensor:
    """Plain version: lane b's logical row p is
    ``pool[table[b, p // bs], p % bs]``.  ``pool``: [num_blocks, bs,
    kv_heads, head_dim]; ``table``: [lanes, n_blk] int32.  Returns
    [lanes, cache_len, kv_heads, head_dim]."""
    _, _, kvh, hd = pool.shape
    blocks = pool[table.long()]                 # [lanes, n_blk, bs, ...]
    return blocks.reshape(table.shape[0], -1, kvh, hd)[:, :cache_len]


def paged_kv_gather(pool: torch.Tensor, table: torch.Tensor,
                    cache_len: int) -> torch.Tensor:
    """Block-table gather, bit-identical to the reference (a copy)."""
    if _on_cpu("paged_kv_gather", pool, table):
        return paged_kv_gather_reference(pool, table, cache_len)
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    if pool.dim() != 4 or table.dim() != 2:
        raise ValueError("paged_kv_gather: pool must be [nb, bs, kvh, hd] "
                         "and table [lanes, n_blk]")
    if not pool.is_contiguous():
        raise ValueError("paged_kv_gather: pool must be contiguous")
    _check("paged_kv_gather", table, "table", (torch.int32,))
    nb, bs, kvh, hd = pool.shape
    lanes, n_blk = table.shape
    c = min(cache_len, n_blk * bs)
    out = torch.empty((lanes, c, kvh, hd), dtype=pool.dtype,
                      device=pool.device)
    if out.numel() == 0:
        return out
    rc = library().ttd_paged_kv_gather(
        pool.data_ptr(), table.data_ptr(), out.data_ptr(), lanes, n_blk,
        nb, bs, kvh * hd * pool.element_size(), c, _stream())
    _raise_on("paged_kv_gather", rc)
    LAUNCHES["paged_kv_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# Fused paged attention (K4)
# ---------------------------------------------------------------------------


def paged_attention_reference(q, k_pool, v_pool, table, lengths, *,
                              k_scales=None, v_scales=None,
                              cache_len: Optional[int] = None):
    """Plain version: gather-then-attend, the math of the JAX engine's
    block-gather leg.

    ``q``: [lanes, q_len, heads, head_dim] (RoPE applied);
    ``k_pool``/``v_pool``: [num_blocks, bs, kv_heads, head_dim] (int8 when
    ``k_scales``/``v_scales`` [num_blocks, bs, kv_heads] are given);
    ``table``: [lanes, n_blk] int32; ``lengths``: [lanes] int32, each
    lane's row count before this call (query i sits at position
    ``lengths[lane] + i`` and sees rows ``<=`` it).  Returns
    [lanes, q_len, heads, head_dim]."""
    _, bs, kvh, _ = k_pool.shape
    lanes, q_len, heads, _ = q.shape
    c = cache_len if cache_len is not None else table.shape[1] * bs
    kc = paged_kv_gather_reference(k_pool, table, c)
    vc = paged_kv_gather_reference(v_pool, table, c)
    if k_scales is not None:
        ks = paged_kv_gather_reference(k_scales[..., None], table, c)
        vs = paged_kv_gather_reference(v_scales[..., None], table, c)
        kc = kc.to(q.dtype) * ks.to(q.dtype)
        vc = vc.to(q.dtype) * vs.to(q.dtype)
    if kvh != heads:
        rep = heads // kvh
        kc = kc.repeat_interleave(rep, dim=2)
        vc = vc.repeat_interleave(rep, dim=2)
    positions = (lengths.long()[:, None]
                 + torch.arange(q_len, device=q.device))        # [B, q]
    mask = (torch.arange(kc.shape[1], device=q.device)[None, None, :]
            <= positions[:, :, None])
    out = dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        mask=mask[:, None])
    return out.transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _rounded_scale(hd: int, dtype: torch.dtype) -> float:
    """hd^-0.5 rounded to the query dtype, as the reference applies it."""
    return torch.tensor(hd ** -0.5, dtype=dtype).item()


def paged_attention(q, k_pool, v_pool, table, lengths, *,
                    k_scales=None, v_scales=None,
                    cache_len: Optional[int] = None):
    """Flash-style decode attention straight through the block table
    (the dense per-lane KV view is never built).  Arguments as
    ``paged_attention_reference``."""
    tensors = [q, k_pool, v_pool, table, lengths]
    int8 = k_scales is not None
    if int8 != (v_scales is not None):
        raise ValueError("paged_attention: k_scales and v_scales go together")
    if int8:
        tensors += [k_scales, v_scales]
    if _on_cpu("paged_attention", *tensors):
        return paged_attention_reference(
            q, k_pool, v_pool, table, lengths, k_scales=k_scales,
            v_scales=v_scales, cache_len=cache_len)
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    floats = (torch.float32, torch.bfloat16)
    _check("paged_attention", q, "q", floats)
    kv_types = (torch.int8,) if int8 else floats
    _check("paged_attention", k_pool, "k_pool", kv_types)
    _check("paged_attention", v_pool, "v_pool", kv_types)
    _check("paged_attention", table, "table", (torch.int32,))
    _check("paged_attention", lengths, "lengths", (torch.int32,))
    if int8:
        _check("paged_attention", k_scales, "k_scales", (torch.float32,))
        _check("paged_attention", v_scales, "v_scales", (torch.float32,))
    nb, bs, kvh, hd = k_pool.shape
    lanes, q_len, heads, qhd = q.shape
    n_blk = table.shape[1]
    if (tuple(v_pool.shape) != tuple(k_pool.shape) or v_pool.dtype
            != k_pool.dtype or qhd != hd or heads % kvh
            or tuple(table.shape) != (lanes, n_blk)
            or tuple(lengths.shape) != (lanes,)):
        raise ValueError(
            f"paged_attention: shapes do not agree: q {tuple(q.shape)}, "
            f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(table.shape)}, lengths {tuple(lengths.shape)}")
    if int8 and (tuple(k_scales.shape) != (nb, bs, kvh)
                 or tuple(v_scales.shape) != (nb, bs, kvh)):
        raise ValueError("paged_attention: scales must be [nb, bs, kvh]")
    c = cache_len if cache_len is not None else n_blk * bs
    lib = library()
    smem = lib.ttd_paged_attention_smem(heads // kvh * q_len, hd, bs)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"paged_attention: {smem} bytes of shared memory per block "
            f"(rep*q_len={heads // kvh * q_len}, hd={hd}, bs={bs}) exceed "
            f"the {_SMEM_LIMIT} a Hopper block can use")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = lib.ttd_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scales.data_ptr() if int8 else None,
        v_scales.data_ptr() if int8 else None,
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        lanes, q_len, heads, kvh, hd, nb, bs, n_blk, c,
        _rounded_scale(hd, q.dtype), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_pool.dtype], _stream())
    _raise_on("paged_attention", rc)
    LAUNCHES["paged_attention"] += 1
    return out
