"""The port's hand-written Hopper kernels and their plain versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py``.  Each kernel
has two faces with one signature and layout (the JAX function's):

- ``rms_norm`` / ``cross_entropy`` / ``flash_attention`` /
  ``splash_attention`` / ``paged_kv_gather`` / ``paged_attention`` /
  ``gmm`` / ``tgmm``: the wrapper.  On a CUDA
  tensor it launches the CUDA kernel from ``csrc/`` (built and loaded by
  ``ops.cuda_build``) on the current stream, or raises; it never falls
  back.  On a CPU tensor it computes the plain version, because that is
  where the tensor lies (the CPU tests).  The training kernels are
  ``torch.autograd.Function``s whose backward is a kernel too (K1b, K3b,
  flash and splash backward, gmm and tgmm), as the JAX functions are
  ``custom_vjp``s.
- ``*_reference``: plain PyTorch, the oracle the kernels are held against
  on the card and the math the CPU path runs.

Every wrapper adds one to ``LAUNCHES[name]`` (``_count``, under a lock: a
fleet's driver threads launch concurrently) where it launches its kernel,
and nowhere else (under ``runtime.debug.debug_mode`` the same call checks
the launch's inputs and outputs for non-finite values, ``NAN_TRAP``), so
a run can show that its main path went through the kernels
(``reset_launch_counts`` / ``launch_counts``); K6 with a
``group_offset`` (an expert shard's groups) counts as ``gmm_ep`` /
``tgmm_ep``.  K1f, K1b, K4 and
K5 have two bodies each, K6 three and K2/K7 four, one launch either way
(K1b's warp body sums dscale's per-block rows in a second kernel of the
same call); ``rms_norm_body``, ``rms_norm_bwd_body``,
``paged_attention_body``, ``paged_kv_gather_body``, ``gmm_body``,
``tgmm_body`` and ``flash_attention_body`` name the one the library
picks for a call.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import torch

from tensorflow_train_distributed_torch.ops.attention import (
    dot_product_attention,
)

LAUNCHES = {"rms_norm": 0, "rms_norm_bwd": 0, "cross_entropy": 0,
            "cross_entropy_bwd": 0, "flash_attention": 0,
            "flash_attention_bwd": 0, "splash_attention": 0,
            "splash_attention_bwd": 0, "paged_attention": 0,
            "paged_kv_gather": 0, "gmm": 0, "tgmm": 0,
            # K6 with a group_offset (expert parallelism), counted apart.
            "gmm_ep": 0, "tgmm_ep": 0}

# Element-type codes shared with csrc/common.cuh (ttd::DType).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on sm_90


# Engines of a serving fleet launch from their own driver threads: the
# counts are bumped under one lock, so no increment is lost between them.
_LAUNCH_LOCK = threading.Lock()


#: A callable ``(name, inputs, outputs)`` that every launch hands its
#: tensors to, or None.  ``runtime.debug.debug_mode(nan_checks=True)``
#: sets it to a check that raises ``FloatingPointError`` naming the kernel
#: (a dispatch mode does not see the kernels) and restores it on exit.
NAN_TRAP = None


def _count(name: str, inputs=(), outputs=()) -> None:
    """Count one launch of kernel ``name`` and hand its ``inputs`` and
    ``outputs`` to ``NAN_TRAP`` where one is set."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
    if NAN_TRAP is not None:
        NAN_TRAP(name, inputs, outputs)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict:
    with _LAUNCH_LOCK:
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
# RMSNorm (K1f forward, K1b backward)
# ---------------------------------------------------------------------------


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor, *,
                       epsilon: float = 1e-5) -> torch.Tensor:
    """Plain version (``models.layers.RMSNorm`` numerics, f32 accumulation);
    its autograd backward is K1b's plain version."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + epsilon)
    return (y * scale.float()).to(x.dtype)


RMS_NORM_BODIES = ("block", "warp")     # csrc/rms_norm.cu body codes


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def rms_norm_body(x: torch.Tensor, scale: torch.Tensor) -> str:
    """The body that serves K1f for rows ``x`` [..., D] and ``scale``, as
    the library chooses it: "warp" (a warp per row, 16-byte loads; 64 rows
    or more) or "block" (a block per row).  The wrapper's output is a
    fresh, aligned allocation, so this is the body it launches."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    d = x.shape[-1]
    code = library().ttd_rms_norm_body(
        x.numel() // d if d else 0, d, _DTYPE_CODES.get(x.dtype, -1),
        _DTYPE_CODES.get(scale.dtype, -1), int(_aligned(x, scale)))
    return RMS_NORM_BODIES[code]


def rms_norm_forward(x2: torch.Tensor, scale: torch.Tensor,
                     epsilon: float, with_r: bool,
                     body: Optional[str] = None):
    """K1f on CUDA [N, D] rows: y, and r = rsqrt(mean x² + eps) [N] f32 when
    ``with_r``.  ``body`` None takes the library's choice; "block" or
    "warp" forces one (to time the two side by side), and a forced body
    that cannot run on these rows raises."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    n, d = x2.shape
    y = torch.empty_like(x2)
    r = (torch.empty(n, dtype=torch.float32, device=x2.device) if with_r
         else None)
    rc = library().ttd_rms_norm_fwd(
        x2.data_ptr(), scale.data_ptr(), y.data_ptr(),
        r.data_ptr() if with_r else None, n, d, epsilon,
        _DTYPE_CODES[x2.dtype], _DTYPE_CODES[scale.dtype],
        -1 if body is None else RMS_NORM_BODIES.index(body), _stream())
    if rc and body is not None:
        raise ValueError(f"rms_norm: the {body} body does not run on these "
                         f"rows (cudaError {rc})")
    _raise_on("rms_norm", rc)
    _count("rms_norm", (x2, scale), (y, r))
    return y, r


def rms_norm_backward_reference(x: torch.Tensor, scale: torch.Tensor,
                                r: torch.Tensor, g: torch.Tensor):
    """Plain version of K1b, the math of the JAX ``_rms_norm_pallas_bwd``
    in f32: ``dx = r·(g·s) − x·r³·mean((g·s)·x)`` per row, in x's dtype,
    and ``ds = Σ_rows g·(x·r)``, rounded once to the scale's dtype.
    ``x``, ``g``: [..., D]; ``r``: rsqrt(mean x² + eps), one per row
    ([...] or [..., 1]); returns (dx [..., D], ds [D])."""
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    g32 = g.reshape(-1, d).float()
    r32 = r.reshape(-1, 1).float()
    gs = g32 * scale.float()
    c = (gs * x32).mean(-1, keepdim=True)
    dx = r32 * gs - x32 * (r32 * r32 * r32) * c
    ds = torch.einsum("nd,nd->d", g32, x32 * r32)
    return dx.to(x.dtype).reshape(x.shape), ds.to(scale.dtype)


def rms_norm_bwd_body(x: torch.Tensor, scale: torch.Tensor,
                      g: Optional[torch.Tensor] = None) -> str:
    """The body that serves K1b for rows ``x`` [..., D], ``scale`` and the
    cotangent ``g``, by K1f's rule (``rms_norm_body``) with g aligned too:
    "warp" (a warp per row, dx and dscale in one pass) or "block" (a block
    per row, dx only: dscale is then an einsum's column sum)."""
    if g is not None and not _aligned(g):
        return "block"
    return rms_norm_body(x, scale)


@functools.lru_cache(maxsize=None)
def _rms_norm_partials(device: int, n: int, d: int, x_code: int,
                       s_code: int) -> int:
    """Rows of the warp body's f32 workspace (its grid) on ``device``."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    with torch.cuda.device(device):
        return library().ttd_rms_norm_bwd_partials(n, d, x_code, s_code)


def rms_norm_backward(x2: torch.Tensor, scale: torch.Tensor,
                      r: torch.Tensor, g: torch.Tensor, *,
                      with_ds: bool = True, body: Optional[str] = None):
    """K1b on CUDA [N, D] rows: (dx, ds) from the forward's ``r`` [N] f32
    and the output cotangent ``g`` (x's dtype, contiguous); dx in x's
    dtype, ds [D] in the scale's dtype (None without ``with_ds``).
    ``body`` None takes the library's choice (``rms_norm_bwd_body``);
    "block" or "warp" forces one (to time the two side by side), and a
    forced body that cannot run on these rows raises."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    n, d = x2.shape
    chosen = body or rms_norm_bwd_body(x2, scale, g)
    dx = torch.empty_like(x2)
    ds = partial = None
    if chosen == "warp" and with_ds:
        parts = _rms_norm_partials(x2.device.index, n, d,
                                   _DTYPE_CODES[x2.dtype],
                                   _DTYPE_CODES[scale.dtype])
        if parts <= 0:
            raise ValueError(f"rms_norm_bwd: the warp body does not run on "
                             f"[{n}, {d}] {x2.dtype} rows")
        partial = torch.empty(parts * d, dtype=torch.float32,
                              device=x2.device)
        ds = torch.empty(d, dtype=scale.dtype, device=x2.device)
    rc = library().ttd_rms_norm_bwd(
        x2.data_ptr(), scale.data_ptr(), r.data_ptr(), g.data_ptr(),
        dx.data_ptr(), None if ds is None else ds.data_ptr(),
        None if partial is None else partial.data_ptr(), n, d,
        _DTYPE_CODES[x2.dtype], _DTYPE_CODES[scale.dtype],
        RMS_NORM_BODIES.index(chosen), _stream())
    if rc and body is not None:
        raise ValueError(f"rms_norm_bwd: the {body} body does not run on "
                         f"these rows (cudaError {rc})")
    _raise_on("rms_norm_bwd", rc)
    _count("rms_norm_bwd", (x2, scale, r, g), (dx, ds))
    if chosen == "block" and with_ds:   # the JAX function's einsum
        ds = torch.einsum("nd,nd->d", g.float(),
                          x2.float() * r[:, None]).to(scale.dtype)
    return dx, ds


class _RmsNormFn(torch.autograd.Function):
    """K1f forward saving r, K1b backward: dx and, where the scale needs
    a gradient, dscale in the scale's dtype (``_rms_norm_pallas_bwd``)."""

    @staticmethod
    def forward(ctx, x2, scale, epsilon):
        y, r = rms_norm_forward(x2, scale, epsilon, with_r=True)
        ctx.save_for_backward(x2, scale, r)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, scale, r = ctx.saved_tensors
        dx, ds = rms_norm_backward(x2, scale, r, g.to(x2.dtype).contiguous(),
                                   with_ds=ctx.needs_input_grad[1])
        return dx, ds, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             epsilon: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm.  ``x``: [..., D] f32/bf16; ``scale``: [D].  Under
    autograd (an input that needs a gradient) the kernel also writes r and
    the backward runs K1b."""
    if _on_cpu("rms_norm", x, scale):
        return rms_norm_reference(x, scale, epsilon=epsilon)
    floats = (torch.float32, torch.bfloat16)
    _check("rms_norm", x, "x", floats)
    _check("rms_norm", scale, "scale", floats)
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rms_norm: scale shape {tuple(scale.shape)} != "
                         f"({d},)")
    if x.numel() == 0:
        return torch.empty_like(x)
    x2 = x.view(-1, d)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RmsNormFn.apply(x2, scale, epsilon).view(x.shape)
    return rms_norm_forward(x2, scale, epsilon,
                            with_r=False)[0].view(x.shape)


# ---------------------------------------------------------------------------
# Fused softmax cross-entropy (K3f forward, K3b backward)
# ---------------------------------------------------------------------------


def cross_entropy_reference(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """Plain version: per-example ``logsumexp(logits) - logits[label]`` in
    f32 (``pallas_kernels.cross_entropy_reference``); its autograd
    backward, ``(softmax - onehot) * g``, is K3b's plain version."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    ll = torch.gather(x, -1, labels.long()[..., None])[..., 0]
    return lse - ll


def cross_entropy_forward(logits2: torch.Tensor, labels: torch.Tensor):
    """K3f on CUDA [N, V] logits and [N] int32 labels: (loss, lse), [N]
    f32 each."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    n, v = logits2.shape
    loss = torch.empty(n, dtype=torch.float32, device=logits2.device)
    lse = torch.empty_like(loss)
    rc = library().ttd_cross_entropy_fwd(
        logits2.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), n, v, _DTYPE_CODES[logits2.dtype], _stream())
    _raise_on("cross_entropy", rc)
    _count("cross_entropy", (logits2,), (loss, lse))
    return loss, lse


def cross_entropy_backward(logits2: torch.Tensor, labels: torch.Tensor,
                           lse: torch.Tensor, g: torch.Tensor
                           ) -> torch.Tensor:
    """K3b on CUDA: ``dlogits`` [N, V] in logits' dtype from the forward's
    ``lse`` and the per-row cotangent ``g`` [N] f32.  dlogits lies as far
    from a vector boundary (16 bytes f32, 8 bf16) as logits does (a view
    into a buffer a few elements longer), so the kernel's rows stream at
    vector width in both."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    n, v = logits2.shape
    es = logits2.element_size()
    lead = logits2.data_ptr() % (4 * es) // es
    dlogits = torch.empty(n * v + lead, dtype=logits2.dtype,
                          device=logits2.device)[lead:].view(n, v)
    rc = library().ttd_cross_entropy_bwd(
        logits2.data_ptr(), labels.data_ptr(), lse.data_ptr(),
        g.data_ptr(), dlogits.data_ptr(), n, v,
        _DTYPE_CODES[logits2.dtype], _stream())
    _raise_on("cross_entropy_bwd", rc)
    _count("cross_entropy_bwd", (logits2, lse, g), (dlogits,))
    return dlogits


class _CrossEntropyFn(torch.autograd.Function):
    """K3f forward saving lse, K3b backward writing dlogits in logits'
    dtype."""

    @staticmethod
    def forward(ctx, logits2, labels):
        loss, lse = cross_entropy_forward(logits2, labels)
        ctx.save_for_backward(logits2, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits2, labels, lse = ctx.saved_tensors
        return cross_entropy_backward(logits2, labels, lse,
                                      g.float().contiguous()), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy with integer labels, never
    materialising the softmax.  ``logits``: [..., V] f32/bf16; ``labels``:
    int32 [...] in [0, V).  Returns f32 [...]."""
    if _on_cpu("cross_entropy", logits, labels):
        return cross_entropy_reference(logits, labels)
    _check("cross_entropy", logits, "logits", (torch.float32,
                                                torch.bfloat16))
    _check("cross_entropy", labels, "labels", (torch.int32,))
    v = logits.shape[-1]
    if tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"cross_entropy: labels {tuple(labels.shape)} do "
                         f"not match logits {tuple(logits.shape)}")
    if labels.numel() == 0:
        return torch.zeros(labels.shape, dtype=torch.float32,
                           device=logits.device)
    loss = _CrossEntropyFn.apply(logits.view(-1, v), labels.view(-1))
    return loss.view(labels.shape)


# ---------------------------------------------------------------------------
# Flash attention (K2 forward and backward)
# ---------------------------------------------------------------------------

# The library kernel's additive mask value (flash_attention.py
# DEFAULT_MASK_VALUE).
FLASH_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
FLASH_HEAD_DIMS = (64, 128, 256)
FLASH_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              segment_ids=None, sm_scale: float = 1.0):
    """Plain version with the library kernel's numerics: scores
    ``q·kᵀ`` in f32, ``sm_scale`` applied in f32 after the product, masked
    scores get ``+ FLASH_MASK_VALUE``, the softmax weights are rounded to
    v's dtype before ``p·v``, the output is in q's dtype.  ``q``:
    [B, H, S, D]; ``k``/``v``: [B, KVH, S, D] with H % KVH == 0 (kv head
    ``h // (H / KVH)`` serves query head h); ``segment_ids``: [B, S] or
    None (equal ids attend).  Its autograd backward is the backward
    kernels' plain version."""
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    keep = None
    if segment_ids is not None:
        keep = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    if causal:
        n = q.shape[2]
        tri = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        keep = tri if keep is None else keep & tri
    if keep is not None:
        s = s + torch.where(keep, 0.0, FLASH_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its last dim is contiguous and every row starts 16-byte
    aligned (the kernels' tile loads), else a contiguous copy."""
    e = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * e % 16 == 0 for st in t.stride()[:-1])):
        return t
    return t.contiguous()


def _strides(*ts) -> "ctypes.Array":
    import ctypes

    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bshd(b, s, h, d, like):
    """A [B, H, S, D] view of fresh [B, S, H, D] storage: the layout the
    model's head merge reads without a copy."""
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


# csrc/flash_common.cuh Body codes.
FLASH_BODIES = ("FMA", "mma.sync", "wgmma", "split")


def flash_attention_body(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel body that serves K2 and K7 (forward and backward) at
    ``dtype`` and ``head_dim``, as the library chooses it: "wgmma" (bf16
    at D 64 and 128), "split" (f32 at D 64 and 128: the wgmma body on
    exact bf16 terms of the f32 operands, six term products a product),
    "mma.sync" (bf16 at D 256) or
    "FMA" (f32 at D 256); "none" where the pair is refused."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    code = library().ttd_flash_attention_body(
        head_dim, _DTYPE_CODES.get(dtype, -1))
    return FLASH_BODIES[code] if code >= 0 else "none"


def _flash_body_code(name: str, q, body: Optional[str]) -> int:
    """-1 (the library's choice) for ``body`` None; else the code of a
    forced body, which must be the library's choice or "FMA" where that
    is "split" (to time the two side by side)."""
    if body is None:
        return -1
    auto = flash_attention_body(q.dtype, q.shape[-1])
    if body != auto and not (body == "FMA" and auto == "split"):
        raise ValueError(f"{name}: body {body!r} does not serve this call; "
                         f"the library's choice is {auto!r}")
    return FLASH_BODIES.index(body)


def flash_attention_forward(q, k, v, segment_ids, causal: bool,
                            sm_scale: float, body: Optional[str] = None):
    """K2 forward on CUDA tensors checked by ``flash_attention``: (o, lse),
    o [B, H, S, D] in q's dtype (a view of [B, S, H, D] storage), lse
    [B, H, S] f32.  ``body`` None takes the library's choice
    (``flash_attention_body``); see ``_flash_body_code`` for a forced
    one."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    code = _flash_body_code("flash_attention", q, body)
    b, h, s, d = q.shape
    o = _bshd(b, s, h, d, q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    seg = segment_ids
    rc = library().ttd_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), seg.data_ptr() if seg is not None else None,
        _strides(q, k, v, o), b, h, k.shape[1], s, d, sm_scale, int(causal),
        _DTYPE_CODES[q.dtype], code, _stream())
    _raise_on("flash_attention", rc)
    _count("flash_attention", (q, k, v), (o, lse))
    return o, lse


def flash_attention_backward(q, k, v, o, lse, do, segment_ids, causal: bool,
                             sm_scale: float, body: Optional[str] = None):
    """K2 backward on CUDA (three kernels: di, dk/dv, dq): (dq, dk, dv) in
    q's dtype from the forward's o and lse and the output cotangent
    ``do`` (q's dtype, 16-byte aligned rows); ``body`` as the
    forward's."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    code = _flash_body_code("flash_attention_bwd", q, body)
    b, h, s, d = q.shape
    kvh = k.shape[1]
    dq = _bshd(b, s, h, d, q)
    dk = _bshd(b, s, kvh, d, k)
    dv = _bshd(b, s, kvh, d, v)
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    seg = segment_ids
    rc = library().ttd_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), di.data_ptr(),
        seg.data_ptr() if seg is not None else None,
        _strides(q, k, v, o, do, dq, dk, dv), b, h, kvh, s, d, sm_scale,
        int(causal), _DTYPE_CODES[q.dtype], code, _stream())
    _raise_on("flash_attention_bwd", rc)
    _count("flash_attention_bwd", (q, k, v, o, lse, do), (dq, dk, dv))
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale):
        q, k, v = (_aligned_rows(t) for t in (q, k, v))
        o, lse = flash_attention_forward(q, k, v, segment_ids, causal,
                                         sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, _aligned_rows(do.to(q.dtype)), seg, ctx.causal,
            ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, segment_ids=None,
                    sm_scale: float = 1.0):
    """Flash attention forward (and, under autograd, backward) over
    [B, H, S, D] queries and [B, KVH, S, D] keys and values; arguments as
    ``flash_attention_reference``.  The kernel takes S a multiple of 64,
    D in (64, 128, 256), f32 or bf16 (one dtype for q, k, v) and int32
    segment ids."""
    tensors = [q, k, v] + ([segment_ids] if segment_ids is not None else [])
    if _on_cpu("flash_attention", *tensors):
        return flash_attention_reference(q, k, v, causal=causal,
                                         segment_ids=segment_ids,
                                         sm_scale=sm_scale)
    _attention_checks("flash_attention", q, k, v, segment_ids)
    if q.numel() == 0:
        return torch.zeros_like(q)
    return _FlashAttentionFn.apply(q, k, v, segment_ids, bool(causal),
                                   float(sm_scale))


def _attention_checks(name: str, q, k, v, segment_ids) -> None:
    """Raises on what the flash and splash kernels do not take."""
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in FLASH_DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: {what} dtype {t.dtype}; q, k, v must "
                            f"share one of f32/bf16")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, S, D] and k, v "
                         f"[B, KVH, S, D]")
    b, h, s, d = q.shape
    kb, kvh, ks, kd = k.shape
    if (kb, ks, kd) != (b, s, d) or kvh == 0 or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not agree (self-attention, "
                         f"H a multiple of KVH)")
    if d not in FLASH_HEAD_DIMS or s % 64:
        raise ValueError(f"{name}: the kernel takes head_dim in "
                         f"{FLASH_HEAD_DIMS} and S a multiple of 64, got "
                         f"D={d}, S={s}")
    if segment_ids is not None:
        _check(name, segment_ids, "segment_ids", (torch.int32,))
        if tuple(segment_ids.shape) != (b, s):
            raise ValueError(f"{name}: segment_ids "
                             f"{tuple(segment_ids.shape)} != ({b}, {s})")


# ---------------------------------------------------------------------------
# Splash attention (K7 forward and backward): sliding-window causal
# ---------------------------------------------------------------------------


def splash_scaled_q(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """The query splash attends with: ``q * sm_scale`` rounded to q's
    dtype, the scale first rounded to that dtype (the JAX function's
    ``(q * scale).astype(q.dtype)`` with a weakly typed scale)."""
    return q * torch.tensor(sm_scale, dtype=q.dtype).item()


def splash_mask(s: int, window: int, sinks: int,
                device=None) -> torch.Tensor:
    """[S, S] bool, True where query row i sees key j:
    ``j <= i and (i - j < window or j < sinks)``
    (``dot_product_attention``'s mask)."""
    pos = torch.arange(s, device=device)
    dist = pos[:, None] - pos[None, :]
    return (dist >= 0) & ((dist < window) | (pos[None, :] < sinks))


def splash_attention_reference(q, k, v, *, window: int, sinks: int = 0,
                               segment_ids=None, sm_scale: float):
    """Plain version with the splash kernel's numerics: q scaled by
    ``splash_scaled_q``; scores ``qs·kᵀ`` in f32; masked scores replaced
    by ``FLASH_MASK_VALUE``; softmax and ``p·v`` in f32 (v cast to f32,
    p not rounded); the output rounded once to q's dtype.  The mask is
    ``splash_mask`` and, with ``segment_ids`` [B, S], equal ids.  Shapes
    as ``flash_attention_reference``.  Its autograd backward is the
    backward kernel's plain version."""
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    qs = splash_scaled_q(q, sm_scale)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    keep = splash_mask(q.shape[2], window, sinks, q.device)
    if segment_ids is not None:
        keep = keep & (segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :])
    s = torch.where(keep, s, FLASH_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def splash_attention_forward(qs, k, v, segment_ids, window: int, sinks: int):
    """K7 forward on CUDA tensors checked by ``splash_attention``, ``qs``
    already scaled: (o, lse) as ``flash_attention_forward``."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    b, h, s, d = qs.shape
    o = _bshd(b, s, h, d, qs)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=qs.device)
    seg = segment_ids
    rc = library().ttd_splash_attention_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), seg.data_ptr() if seg is not None else None,
        _strides(qs, k, v, o), b, h, k.shape[1], s, d, window, sinks,
        _DTYPE_CODES[qs.dtype], _stream())
    _raise_on("splash_attention", rc)
    _count("splash_attention", (qs, k, v), (o, lse))
    return o, lse


def splash_attention_backward(qs, k, v, o, lse, do, segment_ids,
                              window: int, sinks: int):
    """K7 backward on CUDA (three kernels: di, dk/dv, dq): (dqs, dk, dv),
    dqs the gradient of the scaled query."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    b, h, s, d = qs.shape
    kvh = k.shape[1]
    dq = _bshd(b, s, h, d, qs)
    dk = _bshd(b, s, kvh, d, k)
    dv = _bshd(b, s, kvh, d, v)
    di = torch.empty((b, h, s), dtype=torch.float32, device=qs.device)
    seg = segment_ids
    rc = library().ttd_splash_attention_bwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), di.data_ptr(),
        seg.data_ptr() if seg is not None else None,
        _strides(qs, k, v, o, do, dq, dk, dv), b, h, kvh, s, d, window,
        sinks, _DTYPE_CODES[qs.dtype], _stream())
    _raise_on("splash_attention_bwd", rc)
    _count("splash_attention_bwd", (qs, k, v, o, lse, do), (dq, dk, dv))
    return dq, dk, dv


class _SplashAttentionFn(torch.autograd.Function):
    """K7 forward saving (o, lse), K7 backward; over the scaled query, so
    autograd carries the gradient through the scaling as JAX does."""

    @staticmethod
    def forward(ctx, qs, k, v, segment_ids, window, sinks):
        qs, k, v = (_aligned_rows(t) for t in (qs, k, v))
        o, lse = splash_attention_forward(qs, k, v, segment_ids, window,
                                          sinks)
        ctx.save_for_backward(qs, k, v, o, lse, segment_ids)
        ctx.window, ctx.sinks = window, sinks
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse, seg = ctx.saved_tensors
        dq, dk, dv = splash_attention_backward(
            qs, k, v, o, lse, _aligned_rows(do.to(qs.dtype)), seg,
            ctx.window, ctx.sinks)
        return dq, dk, dv, None, None, None


def splash_attention(q, k, v, *, window: int, sinks: int = 0,
                     segment_ids=None, sm_scale: float):
    """Sliding-window causal attention (forward and, under autograd,
    backward) with the splash kernel's numerics; arguments as
    ``splash_attention_reference``.  The kernel takes what
    ``flash_attention``'s does, with ``window >= 1`` and
    ``0 <= sinks <= window``; the tiles outside the band are skipped."""
    if window < 1 or not 0 <= sinks <= window:
        raise ValueError(f"splash_attention: needs window >= 1 and 0 <= "
                         f"sinks <= window, got window={window}, "
                         f"sinks={sinks}")
    tensors = [q, k, v] + ([segment_ids] if segment_ids is not None else [])
    if _on_cpu("splash_attention", *tensors):
        return splash_attention_reference(q, k, v, window=window,
                                          sinks=sinks,
                                          segment_ids=segment_ids,
                                          sm_scale=sm_scale)
    _attention_checks("splash_attention", q, k, v, segment_ids)
    if q.numel() == 0:
        return torch.zeros_like(q)
    s = q.shape[2]          # a window past S masks as one of S (C ints)
    return _SplashAttentionFn.apply(splash_scaled_q(q, sm_scale), k, v,
                                    segment_ids, min(window, s),
                                    min(sinks, s))


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


PAGED_KV_GATHER_BODIES = ("block", "bulk")   # csrc/paged_kv_gather.cu


def paged_kv_gather_body(pool: torch.Tensor) -> str:
    """The body that serves K5 for ``pool`` [nb, bs, kvh, hd], as the
    library chooses it: "bulk" (TMA bulk copies of 8 KiB chunks over the
    whole card) where a row is whole 16-byte vectors and the pool is
    16-byte aligned, else "block" (a block per logical block).  The
    wrapper's output is a fresh, aligned allocation."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    row_bytes = pool.shape[-2] * pool.shape[-1] * pool.element_size()
    code = library().ttd_paged_kv_gather_body(row_bytes,
                                              int(_aligned(pool)))
    return PAGED_KV_GATHER_BODIES[code]


def paged_kv_gather(pool: torch.Tensor, table: torch.Tensor,
                    cache_len: int, *,
                    body: Optional[str] = None) -> torch.Tensor:
    """Block-table gather, bit-identical to the reference (a copy).  On
    CUDA tensors ``body`` None takes the library's choice
    (``paged_kv_gather_body``); "block" or "bulk" forces one (to time
    the two side by side), and a forced body that cannot run on this pool
    raises."""
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
        nb, bs, kvh * hd * pool.element_size(), c,
        -1 if body is None else PAGED_KV_GATHER_BODIES.index(body),
        _stream())
    if rc and body is not None:
        raise ValueError(f"paged_kv_gather: the {body} body does not run on "
                         f"this pool (cudaError {rc})")
    _raise_on("paged_kv_gather", rc)
    _count("paged_kv_gather")
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


PAGED_BODIES = ("staged", "ring")   # csrc/paged_attention.cu choose_body
# Rows of a lane one block of the ring body takes (ring::kChunkRows); a
# longer lane spreads over several blocks.
PAGED_CHUNK_ROWS = 256
_TICKETS: dict = {}


def paged_attention_body(q, k_pool, v_pool=None) -> str:
    """The body that serves K4 for these query and pool tensors, as the
    library chooses it: "ring" (bf16 or int8 pools at head_dim 64 or 128,
    16-byte aligned, at most 8 query rows a kv-head group) or "staged"."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    pools = (k_pool,) if v_pool is None else (k_pool, v_pool)
    code = library().ttd_paged_attention_body(
        _DTYPE_CODES.get(k_pool.dtype, -1), k_pool.shape[-1],
        q.shape[2] // k_pool.shape[2] * q.shape[1], int(_aligned(*pools)))
    return PAGED_BODIES[code]


def _paged_tickets(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 tickets for the ring body's merge, one buffer per
    device and stream (the kernel leaves them zero), grown as needed."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def paged_attention(q, k_pool, v_pool, table, lengths, *,
                    k_scales=None, v_scales=None,
                    cache_len: Optional[int] = None,
                    body: Optional[str] = None):
    """Flash-style decode attention straight through the block table
    (the dense per-lane KV view is never built).  Arguments as
    ``paged_attention_reference``; on CUDA tensors ``body`` None takes the
    library's choice (``paged_attention_body``), "staged" or "ring" forces
    one (to time the two side by side), and a forced body that does not
    apply raises."""
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
    rows = heads // kvh * q_len
    lib = library()
    auto = paged_attention_body(q, k_pool, v_pool)
    chosen = body or auto
    if chosen not in (auto, "staged"):
        raise ValueError(f"paged_attention: body {body!r} does not serve "
                         f"this call; the library's choice is {auto!r}")
    workspace = tickets = None
    if chosen == "staged":
        smem = lib.ttd_paged_attention_smem(rows, hd, bs)
        if smem > _SMEM_LIMIT:
            raise ValueError(
                f"paged_attention: {smem} bytes of shared memory per block "
                f"(rep*q_len={rows}, hd={hd}, bs={bs}) exceed the "
                f"{_SMEM_LIMIT} a Hopper block can use")
    else:
        chunks = -(-min(c, n_blk * bs) // PAGED_CHUNK_ROWS)
        if chunks > 1:      # a lane may span blocks: room for their merge
            workspace = torch.empty(kvh * lanes * chunks * rows * (hd + 2),
                                    dtype=torch.float32, device=q.device)
            tickets = _paged_tickets(q.device, kvh * lanes)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = lib.ttd_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scales.data_ptr() if int8 else None,
        v_scales.data_ptr() if int8 else None,
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        lanes, q_len, heads, kvh, hd, nb, bs, n_blk, c,
        _rounded_scale(hd, q.dtype), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_pool.dtype], PAGED_BODIES.index(chosen), _stream())
    _raise_on("paged_attention", rc)
    _count("paged_attention")
    return out


# ---------------------------------------------------------------------------
# Grouped matmul (K6: megablox gmm and tgmm)
# ---------------------------------------------------------------------------

GMM_DTYPES = (torch.float32, torch.bfloat16)
GMM_BODIES = ("FMA", "mma.sync", "wgmma")   # csrc/grouped_matmul.cu Body


def gmm_body(lhs: torch.Tensor, rhs: torch.Tensor,
             transpose_rhs: bool = False) -> str:
    """The body that serves K6 ``gmm`` for these operands, as the library
    chooses it: "wgmma" (a bf16 rhs and a bf16 or f32 lhs that TMA can
    load: 16-byte aligned, rows of a multiple of 16 bytes; an f32 lhs
    runs as three bf16 terms), "mma.sync" (other bf16 x bf16) or "FMA"."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    k = lhs.shape[-1]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[-1]
    code = library().ttd_gmm_body(
        k, n, int(transpose_rhs), _DTYPE_CODES.get(lhs.dtype, -1),
        _DTYPE_CODES.get(rhs.dtype, -1), int(_aligned(lhs, rhs)))
    return GMM_BODIES[code]


def tgmm_body(lhs_mk: torch.Tensor, rhs: torch.Tensor) -> str:
    """The body that serves K6 ``tgmm`` of ``lhs_mk`` [m, k] (read as its
    transpose) and ``rhs`` [m, n], as ``gmm_body`` chooses: "wgmma" for a
    bf16 lhs and a bf16 or f32 rhs that TMA can load."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    (m, k), n = lhs_mk.shape, rhs.shape[-1]
    code = library().ttd_tgmm_body(
        m, k, n, _DTYPE_CODES.get(lhs_mk.dtype, -1),
        _DTYPE_CODES.get(rhs.dtype, -1), int(_aligned(lhs_mk, rhs)))
    return GMM_BODIES[code]


def bf16_split3(t: torch.Tensor) -> tuple:
    """The exact split the wgmma bodies make of an f32 operand (K6's f32
    operand; both operands of K2's and K7's "split" body): (hi, mid,
    lo) in bf16 with hi = bf16(t), mid = bf16(t - hi), lo = bf16(t - hi -
    mid), each rounded to nearest; hi + mid + lo == t in f32 for normal
    values (the two differences are exact in f32, and three 8-bit
    significands carry f32's 24).  A plain helper for the tests: the main
    path splits inside the kernel."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    r = t - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _group_spans(group_sizes: torch.Tensor, rows: int):
    """(group, first row, end row) of each group over ``rows`` rows, the
    sizes clamped as the kernels clamp them (negative sizes count as 0,
    rows past ``rows`` do not exist).  Reads the sizes on the host."""
    spans, start = [], 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), rows)
        spans.append((g, start, end))
        start = end
    return spans


def gmm_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                  group_sizes: torch.Tensor, *,
                  preferred_element_type: torch.dtype = torch.float32,
                  transpose_rhs: bool = False,
                  group_offset: Optional[int] = None) -> torch.Tensor:
    """Plain version of megablox ``gmm``: ``out[r] = lhs[r] @ rhs[g]`` for
    the rows r of group g (consecutive rows, ``group_sizes`` [E] int32
    counting them in order), ``rhs`` [E, k, n] or, with ``transpose_rhs``,
    [E, n, k]; rows past the sizes' sum are zero.  A loop over groups with
    ``torch.matmul`` in f32 (megablox computes bf16 x bf16 products
    exactly and accumulates in f32, and any f32 operand in f32), rounded
    once to ``preferred_element_type``.  Differentiable by autograd.

    ``group_offset`` (megablox's, expert parallelism): ``rhs`` holds the
    groups [offset, offset + rhs.shape[0]) of the ``group_sizes`` ones;
    rows of every other group come back zero."""
    if group_offset is not None:
        return _gmm_reference_local(lhs, rhs, group_sizes,
                                    preferred_element_type, transpose_rhs,
                                    int(group_offset))
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    pieces = []
    for g, start, end in _group_spans(group_sizes, m):
        w = rhs[g].float()
        pieces.append(lhs[start:end].float() @ (w.t() if transpose_rhs
                                                else w))
    done = sum(p.shape[0] for p in pieces)
    pieces.append(lhs.new_zeros((m - done, n), dtype=torch.float32))
    return torch.cat(pieces).to(preferred_element_type)


def _gmm_reference_local(lhs, rhs, group_sizes, out_dtype, transpose_rhs,
                         offset: int) -> torch.Tensor:
    """``gmm_reference`` with ``group_offset``: the local groups' rows
    from ``rhs[g - offset]``, zeros for the others and past the sum."""
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    local = range(offset, offset + rhs.shape[0])
    pieces = []
    for g, start, end in _group_spans(group_sizes, m):
        if g in local:
            w = rhs[g - offset].float()
            pieces.append(lhs[start:end].float() @ (w.t() if transpose_rhs
                                                    else w))
        else:
            pieces.append(lhs.new_zeros((end - start, n),
                                        dtype=torch.float32))
    done = sum(p.shape[0] for p in pieces)
    pieces.append(lhs.new_zeros((m - done, n), dtype=torch.float32))
    return torch.cat(pieces).to(out_dtype)


def _local_groups(group_sizes, group_offset, num_actual_groups) -> tuple:
    """(offset, count) of tgmm's output groups: all of them without an
    offset, else ``num_actual_groups`` (default: the groups from the
    offset on)."""
    e = group_sizes.shape[0]
    if group_offset is None and num_actual_groups is None:
        return 0, e
    off = int(group_offset or 0)
    count = e - off if num_actual_groups is None else int(num_actual_groups)
    if off < 0 or count < 1 or off + count > e:
        raise ValueError(f"tgmm: groups [{off}, {off + count}) do not lie "
                         f"in the {e} the sizes count")
    return off, count


def tgmm_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor, *,
                   preferred_element_type: torch.dtype = torch.float32,
                   group_offset: Optional[int] = None,
                   num_actual_groups: Optional[int] = None
                   ) -> torch.Tensor:
    """Plain version of megablox ``tgmm``: ``out[g] = lhs[:, rows of g] @
    rhs[rows of g]`` with ``lhs`` [k, m] (megablox's layout), ``rhs``
    [m, n]; [E, k, n], zero for an empty group.  f32 math, rounded once
    to ``preferred_element_type``.  With ``group_offset`` (and
    megablox's ``num_actual_groups``) only the local groups [offset,
    offset + count) are computed: [count, k, n]."""
    k, m = lhs.shape
    off, count = _local_groups(group_sizes, group_offset, num_actual_groups)
    out = lhs.new_zeros((count, k, rhs.shape[1]), dtype=torch.float32)
    for g, start, end in _group_spans(group_sizes, m):
        if end > start and off <= g < off + count:
            out[g - off] = lhs[:, start:end].float() @ rhs[start:end].float()
    return out.to(preferred_element_type)


def gmm_tolerance(got: torch.Tensor, ref32: torch.Tensor,
                  sumsq32: torch.Tensor, depth, tensor_cores: bool
                  ) -> torch.Tensor:
    """The largest ``|got - ref32|`` the grouped-matmul kernels allow
    themselves, elementwise.  ``ref32`` is the f32 value (the plain
    version), ``sumsq32`` the plain version of the squared operands, so
    R = sqrt(Σ(a·b)²) over the products each output sums, and ``depth``
    their count (a number, or a tensor that broadcasts: a tgmm group's
    rows).  In units of 2^-24·R:

    - f32 math (any f32 operand; FMAs, rounded to nearest): the rounding
      errors of both sums add up as a random walk, ~0.6·sqrt(depth),
      allowed 16·sqrt(depth).  The "wgmma" body's three-way bf16 split
      of the f32 operand is held to this too: its products are exact,
      and each 64-deep stage's truncated tensor-core sum is added to an
      f32 total rounded to nearest;
    - tensor cores (bf16 x bf16): each 16-deep ``mma`` truncates its f32
      sum, an error that grows linearly with depth: depth/2 more.

    A bf16 output adds half a bf16 step of the larger of |got| and
    |ref32| (one rounding of a value that is right to the above).  An
    operand rounded to bf16 on the way (2^-9 of it) misses this by far."""
    r = torch.sqrt(sumsq32)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=r.device)
    units = 16 * torch.sqrt(depth) + (depth / 2 if tensor_cores else 0)
    allowed = 2.0 ** -24 * units * r
    if got.dtype == torch.bfloat16:
        top = torch.maximum(got.float().abs(), ref32.abs())
        _, e = torch.frexp(top)      # top in [2^(e-1), 2^e): a step 2^(e-8)
        half_step = torch.where(top > 0, torch.ldexp(torch.ones_like(top),
                                                     e - 9), 0.0)
        allowed = allowed + half_step
    return allowed


def _gmm_checks(name: str, lhs, rhs, group_sizes, transpose_rhs: bool,
                group_offset: Optional[int] = None):
    """Raises on what the CUDA kernels do not take; returns (m, k, n)."""
    for what, t in (("lhs", lhs), ("rhs", rhs)):
        _check(name, t, what, GMM_DTYPES)
    _check(name, group_sizes, "group_sizes", (torch.int32,))
    if lhs.dim() != 2 or group_sizes.dim() != 1:
        raise ValueError(f"{name}: lhs must be 2-D and group_sizes 1-D")
    m, k = lhs.shape
    if name == "tgmm":
        if rhs.dim() != 2 or rhs.shape[0] != m:
            raise ValueError(f"tgmm: rhs {tuple(rhs.shape)} must be "
                             f"[m, n] with m = {m}")
        return m, k, rhs.shape[1]
    if group_offset is not None:
        e = group_sizes.shape[0]
        if rhs.dim() != 3 or group_offset < 0 or rhs.shape[0] < 1 \
                or group_offset + rhs.shape[0] > e:
            raise ValueError(f"gmm: rhs {tuple(rhs.shape)} at group_offset "
                             f"{group_offset} must hold groups inside the "
                             f"{e} the sizes count")
    elif rhs.dim() != 3 or rhs.shape[0] != group_sizes.shape[0]:
        raise ValueError(f"gmm: rhs {tuple(rhs.shape)} must be [E, k, n] "
                         f"with E = len(group_sizes) = "
                         f"{group_sizes.shape[0]}")
    rk, n = (rhs.shape[2], rhs.shape[1]) if transpose_rhs else rhs.shape[1:]
    if rk != k:
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)} and rhs "
                         f"{tuple(rhs.shape)} (transpose_rhs="
                         f"{transpose_rhs}) do not agree on k")
    return m, k, n


def _gmm_body_code(name: str, auto: str, body: Optional[str],
                   bf16s: bool) -> int:
    """The body code to launch: ``auto`` (the library's choice) when
    ``body`` is None; a forced body must be that choice, "FMA", or
    "mma.sync" for bf16 x bf16 (to time the bodies side by side)."""
    chosen = body or auto
    if chosen not in (auto, "FMA") and not (chosen == "mma.sync" and bf16s):
        raise ValueError(f"{name}: body {body!r} does not serve this call; "
                         f"the library's choice is {auto!r}")
    return GMM_BODIES.index(chosen)


def gmm_forward(lhs: torch.Tensor, rhs: torch.Tensor,
                group_sizes: torch.Tensor, out_dtype: torch.dtype,
                transpose_rhs: bool, body: Optional[str] = None,
                group_offset: Optional[int] = None) -> torch.Tensor:
    """K6 ``gmm`` on CUDA tensors: [m, n] in ``out_dtype``.  The group
    sizes stay on the device: the kernel's blocks read them.  ``body``
    None takes the library's choice (``gmm_body``); see
    ``_gmm_body_code`` for a forced one.  ``group_offset``: ``rhs`` holds
    the groups from there on; other groups' rows come back zero."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    m, k, n = _gmm_checks("gmm", lhs, rhs, group_sizes, transpose_rhs,
                          group_offset)
    lib = library()
    args = [lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), None,
            m, k, n, group_sizes.shape[0], int(transpose_rhs),
            _DTYPE_CODES[lhs.dtype], _DTYPE_CODES[rhs.dtype],
            _DTYPE_CODES[out_dtype]]
    launch = lib.ttd_gmm
    if body is not None or group_offset is not None:
        args.append(_gmm_body_code(
            "gmm", gmm_body(lhs, rhs, transpose_rhs), body,
            lhs.dtype == rhs.dtype == torch.bfloat16))
        args += [int(group_offset or 0), rhs.shape[0]]
        launch = lib.ttd_gmm_as
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    args[3] = out.data_ptr()
    rc = launch(*args, _stream())
    _raise_on("gmm", rc)
    _count("gmm" if group_offset is None else "gmm_ep")
    return out


def tgmm_forward(lhs_mk: torch.Tensor, rhs: torch.Tensor,
                 group_sizes: torch.Tensor, out_dtype: torch.dtype,
                 body: Optional[str] = None,
                 group_offset: Optional[int] = None,
                 num_actual_groups: Optional[int] = None) -> torch.Tensor:
    """K6 ``tgmm`` on CUDA tensors, reading ``lhs_mk`` [m, k] in place
    (megablox's [k, m] operand is its transpose): [E, k, n] in
    ``out_dtype``, zero for an empty group.  ``body`` as ``gmm_forward``
    (the choice is ``tgmm_body``); with ``group_offset`` the groups
    [offset, offset + num_actual_groups) alone, [count, k, n]."""
    from tensorflow_train_distributed_torch.ops.cuda_build import library

    m, k, n = _gmm_checks("tgmm", lhs_mk, rhs, group_sizes, False)
    lib = library()
    off, num_groups = _local_groups(group_sizes, group_offset,
                                    num_actual_groups)
    args = [lhs_mk.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), None,
            m, k, n, num_groups, _DTYPE_CODES[lhs_mk.dtype],
            _DTYPE_CODES[rhs.dtype], _DTYPE_CODES[out_dtype]]
    launch = lib.ttd_tgmm
    if body is not None or group_offset is not None:
        args.append(_gmm_body_code(
            "tgmm", tgmm_body(lhs_mk, rhs), body,
            lhs_mk.dtype == rhs.dtype == torch.bfloat16))
        args.append(off)
        launch = lib.ttd_tgmm_as
    out = torch.empty((num_groups, k, n), dtype=out_dtype,
                      device=lhs_mk.device)
    if out.numel() == 0:
        return out
    args[3] = out.data_ptr()
    rc = launch(*args, _stream())
    _raise_on("tgmm", rc)
    _count("tgmm" if group_offset is None else "tgmm_ep")
    return out


def _gmm_call(lhs, rhs, group_sizes, out_dtype, transpose_rhs,
              group_offset=None):
    """gmm's plain version for CPU tensors, its kernel for CUDA ones."""
    if _on_cpu("gmm", lhs, rhs, group_sizes):
        return gmm_reference(lhs, rhs, group_sizes,
                             preferred_element_type=out_dtype,
                             transpose_rhs=transpose_rhs,
                             group_offset=group_offset)
    return gmm_forward(lhs, rhs, group_sizes, out_dtype, transpose_rhs,
                       group_offset=group_offset)


def _tgmm_call(lhs_mk, rhs, group_sizes, out_dtype, group_offset=None,
               num_actual_groups=None):
    """tgmm of ``lhs_mk.t()`` and ``rhs``: the plain version for CPU
    tensors, the kernel (reading ``lhs_mk`` in place) for CUDA ones."""
    if _on_cpu("tgmm", lhs_mk, rhs, group_sizes):
        return tgmm_reference(lhs_mk.t(), rhs, group_sizes,
                              preferred_element_type=out_dtype,
                              group_offset=group_offset,
                              num_actual_groups=num_actual_groups)
    return tgmm_forward(lhs_mk.contiguous(), rhs.contiguous(), group_sizes,
                        out_dtype, group_offset=group_offset,
                        num_actual_groups=num_actual_groups)


class _GmmFn(torch.autograd.Function):
    """megablox's ``gmm`` custom VJP (``ops.py`` ``_gmm_fwd``/``_gmm_bwd``):
    the forward is gmm; the backward is grad_lhs = gmm(grad, rhs,
    transpose_rhs flipped) rounded to lhs's dtype and grad_rhs =
    tgmm(lhsᵀ, grad) rounded to rhs's dtype (swapped back when the
    forward read rhs transposed).  Each product is the kernel on CUDA
    tensors and the plain version on CPU ones.  A ``group_offset`` goes
    to both products of the backward (megablox's ``_gmm_bwd``): grad_lhs
    is zero off the local groups' rows, grad_rhs covers the rhs.shape[0]
    local groups."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, out_dtype, transpose_rhs,
                group_offset=None):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.transpose_rhs = transpose_rhs
        ctx.group_offset = group_offset
        return _gmm_call(lhs, rhs, group_sizes, out_dtype, transpose_rhs,
                         group_offset)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.contiguous()
        dlhs = drhs = None
        off = ctx.group_offset
        if ctx.needs_input_grad[0]:
            dlhs = _gmm_call(grad, rhs, group_sizes, lhs.dtype,
                             not ctx.transpose_rhs, off)
        if ctx.needs_input_grad[1]:
            drhs = _tgmm_call(lhs, grad, group_sizes, rhs.dtype, off,
                              None if off is None else rhs.shape[0])
            if ctx.transpose_rhs:
                drhs = drhs.transpose(1, 2)
        return dlhs, drhs, None, None, None, None


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
        preferred_element_type: torch.dtype = torch.float32,
        transpose_rhs: bool = False,
        group_offset: Optional[int] = None) -> torch.Tensor:
    """Grouped matmul with megablox's signature and layout (arguments as
    ``gmm_reference``, ``group_offset`` included): the kernel on CUDA
    tensors, the plain version on CPU ones, differentiable through
    ``_GmmFn``.  The kernel takes contiguous f32/bf16 operands and int32
    sizes on the same device and never reads the sizes on the host."""
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return _GmmFn.apply(lhs, rhs, group_sizes, preferred_element_type,
                            bool(transpose_rhs), group_offset)
    return _gmm_call(lhs, rhs, group_sizes, preferred_element_type,
                     bool(transpose_rhs), group_offset)


def tgmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
         preferred_element_type: torch.dtype = torch.float32,
         group_offset: Optional[int] = None,
         num_actual_groups: Optional[int] = None) -> torch.Tensor:
    """Transposed grouped matmul with megablox's signature and layout
    (arguments as ``tgmm_reference``): ``lhs`` [k, m] is read in place
    when it is the transpose of a contiguous [m, k] tensor (as
    ``x.t()``), copied otherwise."""
    return _tgmm_call(lhs.t(), rhs, group_sizes, preferred_element_type,
                      group_offset, num_actual_groups)
