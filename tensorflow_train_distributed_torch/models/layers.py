"""Transformer building blocks: training and serving.

Counterpart of the JAX package's ``models/layers.py``: ``Embed`` (with
tied logits, ``attend``), RoPE (with the Llama-3 frequency scaling),
``sinusoidal_positions``, the int8 KV recipe, ``RMSNorm`` over the fused
kernel, ``LayerNorm``, ``Conv``, the gated and the plain ``MlpBlock``,
dropout, and ``MultiHeadAttention`` in its training branch (causal or
full self-attention and cross-attention through the kernel dispatch,
sliding windows included) and its decode modes (the shared-index cache
of ``generate()``, with a sliding window's rolling ring and the sink
buffers, and the serving engine's per-row linear and paged caches).

Weights keep the flax layout, so converted checkpoints load verbatim:
dense kernels are ``[in, out]`` (``y = x @ kernel``), the embedding table
``[vocab, d_model]``, norm scales ``[d]``.  They are trainable
parameters; serving runs under ``torch.no_grad()``.

Mixed precision: the JAX trainer casts every floating parameter to the
policy's compute dtype before the forward.  Here each leaf module
(``Dense``, ``Embed``, ``RMSNorm``) casts its own parameters to
``compute_dtype`` when that is set (``set_compute_dtype``),
inside autograd, so the f32 masters receive the gradients; the cast sits
inside the module so that a rematerialised block recomputes it too.

KV caches are plain tensors held in a ``KVCache`` and updated IN PLACE
(the JAX package threads them functionally and donates the old buffers;
in place saves the copy):

- linear (the engine's batch-1 prefill cache): per layer ``key_cache`` /
  ``value_cache`` [B, C, kvh, hd] and, for ``kv_cache_int8``,
  ``kv_scales`` [2, B, C, kvh];
- paged (the slot grid): per layer ``key_pool`` / ``value_pool``
  [nb, bs, kvh, hd] and ``kv_pool_scales`` [2, nb, bs, kvh]; plus one
  ``block_table`` [B, n_blk] int32 shared by all layers (the JAX package
  keeps an identical copy per layer);
- shared-index (``generate()``, the JAX ``_decode_step``): the linear
  leaves at ``cache_len`` rows, or for a ``window`` shorter than
  ``cache_len`` a ring of ``window`` rows (position p in slot p % window)
  with ``sink_key`` / ``sink_value`` [B, sinks, kvh, hd] buffers for the
  attention sinks.

The linear and paged caches carry one ``index`` [B] int32, each row's
position; the shared-index cache one host int for every row.  The model
advances it once per call.

Dropout draws from the ``torch.Generator`` that ``dropout_generator``
installs (the trainer installs one seeded from (seed, step), as the JAX
trainer folds the step into its key), and only in a module's training
mode; the masks differ from JAX's, the rate and scaling do not.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.ops.attention import (
    dot_product_attention,
    multihead_attention_kernel,
)


@dataclasses.dataclass
class KVCache:
    """A decoder's KV cache: ``layers[i]`` maps leaf names to tensors (see
    the module docstring); ``index`` [B] int32; ``cache_len`` the logical
    rows a lane can hold; ``block_table`` [B, n_blk] int32 for the paged
    layout, None for the linear one."""

    layers: list
    index: torch.Tensor
    cache_len: int
    block_table: Optional[torch.Tensor] = None
    # Shared-index mode: ``index`` is a host int, the position of every
    # row; ``fresh`` until the first call has written it.
    shared: bool = False
    fresh: bool = False

    @property
    def paged(self) -> bool:
        return self.block_table is not None


def shared_cache_rows(window: Optional[int], sinks: int, kv_int8: bool,
                      cache_len: int) -> tuple:
    """(rows, rolling) of a shared-index cache layer, with the JAX
    ``_decode_step``'s refusals: a window shorter than ``cache_len``
    rolls a ring of ``window`` rows; sinks need a window at least as
    long; an int8 cache is linear only."""
    if cache_len <= 0:
        raise ValueError("decode=True needs cache_len > 0")
    if sinks and (window is None or sinks > window):
        raise ValueError(f"sinks={sinks} needs a sliding window >= sinks, "
                         f"got window={window}")
    rolling = window is not None and cache_len > window
    if kv_int8 and (rolling or sinks):
        raise ValueError(
            "kv_cache_int8 supports the LINEAR cache only (the rolling "
            "window ring / sink buffers would need scale plumbing through "
            "roll/concat, and the window already bounds cache memory)")
    return (window if rolling else cache_len), rolling


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S, ...] zero-padded along S to ``n`` rows."""
    if t.shape[1] == n:
        return t
    pad = t.new_zeros((t.shape[0], n - t.shape[1], *t.shape[2:]))
    return torch.cat([t, pad], dim=1)


class _Leaf(nn.Module):
    """A module that owns parameters: ``compute_dtype`` (None, or the
    policy's compute dtype) is the cast each parameter takes on use."""

    compute_dtype: Optional[torch.dtype] = None

    def _cast(self, p: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return p if cd is None or p.dtype == cd else p.to(cd)


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Cast every parameter of ``model`` to ``dtype`` on use (the
    mixed-precision policy's compute dtype; None turns the cast off)."""
    for m in model.modules():
        if isinstance(m, _Leaf):
            m.compute_dtype = dtype


class Dense(_Leaf):
    """``y = x @ kernel (+ bias)``, kernel ``[in, out]`` (flax layout);
    inputs and weights are promoted to ``dtype`` as flax's Dense does
    (``dtype=None``: to the promotion of the input's and the cast
    kernel's dtypes, flax's default).

    int8 weight-only serving (``models.quant``): the kernel is then an
    int8 ``Parameter`` that requires no gradient (the decode model is
    frozen before ``load_state_dict(assign=True)`` takes it) and
    ``scale`` [out] f32 a non-persistent buffer (``quant.attach_scales``;
    None otherwise, and never in the state dict).  The product is the
    JAX interceptor's, in its order: ``(x @ q) * scale`` in ``dtype`` (or
    x's), then ``+ bias``, so the f32 router stays f32."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        pdt = dtype or torch.float32
        self.kernel = nn.Parameter(
            torch.empty(in_features, out_features, dtype=pdt,
                        device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=pdt,
                                              device=device))
                     if use_bias else None)
        self.register_buffer("scale", None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale is not None:
            dt = self.dtype or x.dtype
            y = torch.matmul(x.to(dt), self.kernel.to(dt)) * self.scale.to(dt)
            if self.bias is not None:
                y = y + self._cast(self.bias).to(dt)
            return y
        w = self._cast(self.kernel)
        dt = self.dtype or torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(dt), w.to(dt))
        if self.bias is not None:
            y = y + self._cast(self.bias).to(dt)
        return y


class Embed(_Leaf):
    """Token embedding (table ``[vocab, features]``)."""

    def __init__(self, vocab_size: int, features: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty(vocab_size, features, dtype=dtype, device=device))
        # (mesh, table_axis, vocab_size) of a row-sharded table holding
        # this rank's rows (``set_tensor_parallel``).
        self.row_shard = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.row_shard is not None:
            from tensorflow_train_distributed_torch.ops.embedding import (
                sharded_lookup,
            )

            mesh, axis, vocab = self.row_shard
            return self._cast(sharded_lookup(
                self.embedding, ids, mesh=mesh, table_axis=axis,
                vocab_size=vocab)).to(self.dtype)
        # take-then-cast equals the JAX cast-then-take bit for bit; the
        # backward then sums repeated tokens' rows in f32 (JAX sums them
        # in the compute dtype before its cast back).
        return self._cast(self.embedding[ids]).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output logits ``x @ Eᵀ`` in x's dtype (BERT's and the
        Transformer's heads)."""
        return torch.matmul(x, self._cast(self.embedding).to(x.dtype).t())


def sinusoidal_positions(seq_len: int, features: int) -> np.ndarray:
    """Fixed sin/cos table [seq_len, features] f32 (Transformer-big)."""
    pos = np.arange(seq_len)[:, None]
    div = np.exp(np.arange(0, features, 2) / features * -np.log(10000.0))
    table = np.zeros((seq_len, features), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


_DROPOUT_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator):
    """Dropout inside draws from ``generator`` (on the tensors' device):
    a ``torch.Generator``, or a callable that makes one, called at the
    first draw, so that a model without dropout builds none."""
    token = _DROPOUT_GENERATOR.set([generator])
    try:
        yield
    finally:
        _DROPOUT_GENERATOR.reset(token)


def _installed_generator() -> Optional[torch.Generator]:
    box = _DROPOUT_GENERATOR.get()
    if box is None or box[0] is None:
        return None
    if not isinstance(box[0], torch.Generator):
        box[0] = box[0]()
    return box[0]


def dropout(x: torch.Tensor, rate: float, active: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate,
    scaled by 1 / (1 - rate) in x's dtype; the identity unless ``active``
    (a module in training mode) and rate > 0."""
    if not active or rate <= 0.0:
        return x
    gen = _installed_generator()
    if gen is None:
        raise RuntimeError("dropout in training mode draws from the "
                           "generator of layers.dropout_generator(...); "
                           "none is installed")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def checkpoint_with_dropout(fn, *args):
    """``torch.utils.checkpoint`` of ``fn(*args)`` whose recompute in the
    backward draws the forward's dropout masks again: the recompute runs
    under the forward's generator, rewound to its state at the forward's
    entry."""
    from torch.utils.checkpoint import checkpoint

    gen = _installed_generator()
    state = None if gen is None else gen.get_state()

    def run(*a):
        if state is not None:
            gen.set_state(state)
        with dropout_generator(gen):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


def llama3_scaled_freqs(freqs: torch.Tensor, scaling) -> torch.Tensor:
    """Llama-3.x frequency-dependent RoPE scaling (HF
    ``_compute_llama3_parameters``); ``scaling`` = (factor,
    low_freq_factor, high_freq_factor, original_max_positions)."""
    factor, low, high, old_len = scaling
    wavelen = 2.0 * math.pi / freqs
    low_wl = old_len / low
    high_wl = old_len / high
    scaled = torch.where(wavelen > low_wl, freqs / factor, freqs)
    smooth = (old_len / wavelen - low) / (high - low)
    smoothed = (1.0 - smooth) / factor * freqs + smooth * freqs
    medium = (wavelen >= high_wl) & (wavelen <= low_wl)
    return torch.where(medium, smoothed, scaled)


def rope_sin_cos(positions: torch.Tensor, head_dim: int, *,
                 base: float = 10000.0, scaling=None):
    """(sin, cos) [B, S, 1, head_dim/2] in f32 for integer ``positions``
    [B, S] — computed once per model call and shared by every layer."""
    freqs = 1.0 / base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim)
    if scaling is not None:
        freqs = llama3_scaled_freqs(freqs, scaling)
    angles = positions[..., None].float() * freqs
    return torch.sin(angles)[:, :, None, :], torch.cos(angles)[:, :, None, :]


def rotate(x: torch.Tensor, sin: torch.Tensor,
           cos: torch.Tensor) -> torch.Tensor:
    """RoPE rotation of [B, S, H, D] by precomputed tables (f32 math)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               base: float = 10000.0, scaling=None) -> torch.Tensor:
    """RoPE applied to [B, S, H, D] at integer ``positions`` [B, S]."""
    sin, cos = rope_sin_cos(positions, x.shape[-1], base=base,
                            scaling=scaling)
    return rotate(x, sin, cos)


def _quantize_kv_rows(t: torch.Tensor):
    """Symmetric int8 quantization of KV rows, one f32 scale per
    (..., row, kv_head) taken over head_dim — the one KV recipe of the
    linear cache and the paged pool.  ``torch.round`` rounds half to even,
    as ``jnp.round`` does, so both frameworks store the same bytes."""
    t32 = t.float()
    amax = t32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    qt = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127)
    return qt.to(torch.int8), scale


class RMSNorm(_Leaf):
    """Llama-family norm over the fused kernel (``ops.kernels.rms_norm``:
    K1f forward, K1b backward).  ``zero_centered`` (Gemma): output
    x̂·(1 + scale); the +1 is applied here, outside the kernel."""

    def __init__(self, features: int, *, epsilon: float = 1e-5,
                 dtype=torch.float32, zero_centered: bool = False,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.zero_centered = zero_centered
        self.scale = nn.Parameter(
            torch.empty(features, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self._cast(self.scale)
        if self.zero_centered:
            scale = scale + 1.0
        return K.rms_norm(x, scale, epsilon=self.epsilon).to(self.dtype)


class LayerNorm(_Leaf):
    """flax ``nn.LayerNorm`` (scale and bias): statistics and the affine in
    f32, the result in ``dtype``."""

    def __init__(self, features: int, *, epsilon: float = 1e-6,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(features, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.empty(features, dtype=dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],),
                         self._cast(self.scale).float(),
                         self._cast(self.bias).float(), self.epsilon)
        return y.to(self.dtype)


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """(lo, hi) padding of XLA's "SAME" along one axis: asymmetric, the
    extra row at the end, e.g. (2, 3) for a 7x7 stride-2 conv on 224."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(_Leaf):
    """flax ``nn.Conv`` over NCHW tensors (the port's vision layout; a
    permuted NHWC batch is channels-last in memory).  ``kernel`` is
    ``[out, in, kh, kw]`` (OIHW; ``convert`` transposes flax's HWIO);
    ``padding`` "SAME" (XLA's asymmetric split, ``same_padding``),
    "VALID" or ((lo, hi), (lo, hi)).  The product runs in the promoted
    dtype of input and (cast) kernel, as flax's ``dtype=None``."""

    def __init__(self, in_features: int, features: int, kernel: int, *,
                 stride: int = 1, padding="SAME", use_bias: bool = True,
                 kernel_init=("fan_in", 1.0), device=None):
        super().__init__()
        self.kernel_init = kernel_init
        self.kernel_size = kernel
        self.stride = stride
        self.padding = padding
        self.kernel = nn.Parameter(torch.empty(features, in_features, kernel,
                                               kernel, device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    def init_spec(self) -> dict:
        """Random kernels N(0, scale / fan) (flax's variance scaling with
        a normal draw; ``kernel_init`` = (fan mode, scale)): lecun's
        ("fan_in", 1) by default, ResNet's ("fan_out", 2)."""
        mode, scale = self.kernel_init
        o, i, kh, kw = self.kernel.shape
        fan = (i if mode == "fan_in" else o) * kh * kw
        return {"kernel": ("normal", math.sqrt(scale / fan))}

    def _pads(self, h: int, w: int) -> tuple:
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SAME":
            return (same_padding(h, self.kernel_size, self.stride),
                    same_padding(w, self.kernel_size, self.stride))
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self._cast(self.kernel)
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
        if x.is_cuda:
            w = w.contiguous(memory_format=torch.channels_last)
        (t, b), (lft, r) = self._pads(x.shape[2], x.shape[3])
        if t == b and lft == r:
            pad = (t, lft)
        else:
            x = F.pad(x, (lft, r, t, b))
            pad = 0
        b_ = None if self.bias is None else self._cast(self.bias).to(dt)
        return F.conv2d(x, w, b_, stride=self.stride, padding=pad)


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # flax nn.gelu
    "gelu_exact": F.gelu,                              # erf (HF BERT)
}


class MlpBlock(nn.Module):
    """Transformer FFN.  Gated (Llama): SwiGLU (``silu``) or GeGLU with the
    tanh gelu, ``wi_gate``/``wi_up``/``wo`` without biases.  Plain
    (``gated=False``, BERT and the Transformer): ``wi`` and ``wo`` with
    biases, the activation (``gelu``: tanh; ``gelu_exact``: erf) and
    dropout on the hidden activations in training mode."""

    def __init__(self, features: int, hidden: int, *, dtype=torch.float32,
                 activation: str = "silu", gated: bool = True,
                 dropout_rate: float = 0.0, device=None):
        super().__init__()
        allowed = ("silu", "gelu") if gated else tuple(_ACTIVATIONS)
        if activation not in allowed:
            raise ValueError(f"activation must be one of {allowed}, got "
                             f"{activation!r}")
        self.activation = activation
        self.gated = gated
        self.dropout_rate = dropout_rate
        if gated:
            self.wi_gate = Dense(features, hidden, dtype=dtype,
                                 device=device)
            self.wi_up = Dense(features, hidden, dtype=dtype, device=device)
        else:
            self.wi = Dense(features, hidden, use_bias=True, dtype=dtype,
                            device=device)
        self.wo = Dense(hidden, features, use_bias=not gated, dtype=dtype,
                        device=device)
        # The tensor group of a split FFN (``set_tensor_parallel``).
        self.tensor_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = _ACTIVATIONS[self.activation]
        if self.gated:
            return _tensor_sum(self.wo(act(self.wi_gate(x)) * self.wi_up(x)),
                               self.tensor_group)
        h = dropout(act(self.wi(x)), self.dropout_rate, self.training)
        return self.wo(h)


class MultiHeadAttention(nn.Module):
    """MHA/GQA attention: training, or decode over a KV cache.

    Without a cache (training, ``_train_step``) the whole sequence attends
    through ``ops.attention.multihead_attention_kernel``: the flash kernel
    on CUDA (causal, or full for ``causal=False``: BERT's encoder and the
    Transformer's, its cross-attention over ``x_kv``), or with a sliding
    ``window`` (and ``sinks``) the splash kernel; the reference paths on
    the CPU and at the shapes the kernels' gate refuses.  ``use_rope``
    (the decoders) rotates q and k by the caller's tables; ``use_bias``
    (BERT) gives every projection a bias; ``dropout_rate`` drops the
    attention output before the out projection in training mode.  With a
    cache (causal self-attention with RoPE only), a call appends this
    call's k/v rows at each row's own position (``index``) and attends
    over everything up to it: over a linear cache (``_slot_decode_step``,
    the serving engine's batch-1 prefill) or over the paged pool
    (``_paged_decode_step``, the slot-grid decode step, whose read is the
    fused paged-attention kernel)."""

    def __init__(self, features: int, num_heads: int, head_dim: int,
                 num_kv_heads: Optional[int] = None, *, dtype=torch.float32,
                 kv_cache_int8: bool = False, fused_qkv: bool = False,
                 qkv_bias: bool = False, window: Optional[int] = None,
                 sinks: int = 0, causal: bool = True, use_rope: bool = True,
                 use_bias: bool = False, dropout_rate: float = 0.0,
                 device=None):
        super().__init__()
        self.causal = causal
        self.use_rope = use_rope
        self.dropout_rate = dropout_rate
        qkv_bias = qkv_bias or use_bias
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_kv_heads = num_kv_heads or num_heads
        self.dtype = dtype
        self.kv_cache_int8 = kv_cache_int8
        self.fused_qkv = fused_qkv
        self.window = window
        self.sinks = sinks
        # (method, group): attention over a sequence sharded on the seq
        # axis (``set_seq_parallel``); the tensor group whose sum follows
        # the row-split out projection (``set_tensor_parallel``).
        self.seq_parallel = None
        self.tensor_group = None
        kvh = self.num_kv_heads
        if fused_qkv:
            self.qkv = Dense(features, (num_heads + 2 * kvh) * head_dim,
                             use_bias=qkv_bias, dtype=dtype, device=device)
        else:
            self.query = Dense(features, num_heads * head_dim,
                               use_bias=qkv_bias, dtype=dtype, device=device)
            self.key = Dense(features, kvh * head_dim, use_bias=qkv_bias,
                             dtype=dtype, device=device)
            self.value = Dense(features, kvh * head_dim, use_bias=qkv_bias,
                               dtype=dtype, device=device)
        self.out = Dense(num_heads * head_dim, features, use_bias=use_bias,
                         dtype=dtype, device=device)

    def _qkv(self, x: torch.Tensor, x_kv: Optional[torch.Tensor] = None):
        """q [B, S, H, D], k/v [B, S_kv, KV, D]: three products, or one
        fused product split head-wise (self-attention only); k and v read
        ``x_kv`` where it is given (cross-attention)."""
        b, s, _ = x.shape
        h, kvh, hd = self.num_heads, self.num_kv_heads, self.head_dim
        if x_kv is not None:
            if self.fused_qkv:
                raise ValueError("fused_qkv is self-attention only (q and "
                                 "kv read different inputs)")
            skv = x_kv.shape[1]
            return (self.query(x).view(b, s, h, hd),
                    self.key(x_kv).view(b, skv, kvh, hd),
                    self.value(x_kv).view(b, skv, kvh, hd))
        if not self.fused_qkv:
            return (self.query(x).view(b, s, h, hd),
                    self.key(x).view(b, s, kvh, hd),
                    self.value(x).view(b, s, kvh, hd))
        y = self.qkv(x).view(b, s, h + 2 * kvh, hd)
        return y[:, :, :h], y[:, :, h:h + kvh], y[:, :, h + kvh:]

    def forward(self, x: torch.Tensor, layer_cache: Optional[dict] = None,
                cache: Optional[KVCache] = None, *,
                positions: Optional[torch.Tensor] = None, rope=None,
                segment_ids: Optional[torch.Tensor] = None,
                x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``layer_cache``: this layer's leaves of ``cache`` (both None for
        training); ``positions`` [B, S] the tokens' positions (decode:
        ``cache.index[:, None] + arange(S)``); ``rope`` the (sin, cos)
        tables at those positions (``use_rope`` only); ``segment_ids``
        [B, S] (training only) the packing restriction; ``x_kv`` [B, S_kv,
        features] the keys' and values' input for cross-attention."""
        q, k, v = self._qkv(x, x_kv)
        if self.use_rope:
            if rope is None:
                raise ValueError("use_rope attention needs the rope tables")
            q = rotate(q, *rope)
            k = rotate(k, *rope)
        if cache is None:
            return self._train_step(q, k, v, segment_ids, x_kv is not None)
        if x_kv is not None or not (self.causal and self.use_rope):
            raise ValueError("decode is causal self-attention with RoPE")
        if segment_ids is not None:
            raise ValueError("decode mode does not take packed segments")
        if cache.shared:
            out = self._decode_step(q, k, v, layer_cache, cache)
        elif self.window is not None or self.sinks:
            raise ValueError(
                "slot_decode (per-slot cache positions) supports the "
                "LINEAR cache only (full-precision or kv_cache_int8) "
                "— window/sinks keep the shared-index path")
        elif cache.paged:
            out = self._paged_decode_step(q, k, v, layer_cache, positions,
                                          cache)
        else:
            out = self._slot_decode_step(q, k, v, layer_cache, positions)
        return self._attn_epilogue(out)

    def _train_step(self, q, k, v, segment_ids, cross: bool = False):
        """Attention over the whole sequence (the JAX ``__call__`` without
        decode): causal (keys at their queries' positions) or full; GQA's
        kv heads are read, not repeated, by the kernels (the reference
        paths repeat them).  Under ``seq_parallel`` the sequence is this
        rank's block and ring or Ulysses attention spans the axis, the
        unrepeated KV handed over (self-attention only)."""
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if self.seq_parallel is not None:
            if cross:
                raise ValueError("seq_parallel supports self-attention only")
            from tensorflow_train_distributed_torch.parallel.ring_attention \
                import METHODS

            method, group = self.seq_parallel
            out = METHODS[method](
                qh, kh, vh, group=group, causal=self.causal,
                segment_ids=segment_ids, window=self.window,
                sinks=self.sinks)
        else:
            out = multihead_attention_kernel(
                qh, kh, vh, causal=self.causal, segment_ids=segment_ids,
                window=self.window, sinks=self.sinks)
        out = dropout(out.transpose(1, 2), self.dropout_rate, self.training)
        return self._attn_epilogue(out)

    def _stored(self, k: torch.Tensor, v: torch.Tensor, cache_dtype):
        """Rows as the cache stores them: int8 + scales, or cast."""
        if self.kv_cache_int8:
            qk, sk = _quantize_kv_rows(k)
            qv, sv = _quantize_kv_rows(v)
            return qk, qv, torch.stack([sk, sv])
        return k.to(cache_dtype), v.to(cache_dtype), None

    def _slot_decode_step(self, q, k, v, lc, positions):
        """Per-row positions over a linear cache (the engine's batch-1
        prefill).  A position past the cache's end would be dropped by the
        JAX scatter; here it lands in the last row instead.  Only pad rows
        of a final prefill piece go there, and rows at or past the prompt
        length are rewritten before anything attends them, so the
        difference is never read."""
        kc_all, vc_all = lc["key_cache"], lc["value_cache"]
        b, c = kc_all.shape[:2]
        rows = positions.clamp(max=c - 1).long()
        bidx = torch.arange(b, device=q.device)[:, None].expand_as(rows)
        k_st, v_st, scales = self._stored(k, v, kc_all.dtype)
        kc_all[bidx, rows] = k_st
        vc_all[bidx, rows] = v_st
        if scales is not None:
            lc["kv_scales"][:, bidx, rows] = scales
            kc = (kc_all.to(self.dtype)
                  * lc["kv_scales"][0][..., None].to(self.dtype))
            vc = (vc_all.to(self.dtype)
                  * lc["kv_scales"][1][..., None].to(self.dtype))
        else:
            kc, vc = kc_all, vc_all
        kv_pos = torch.arange(c, device=q.device)
        mask = kv_pos[None, None, :] <= positions[:, :, None]   # [B, q, C]
        return self._cache_attend(q, kc, vc, mask[:, None])

    def _paged_decode_step(self, q, k, v, lc, positions, cache: KVCache):
        """Per-row positions over the paged pool: scatter each token's
        rows to ``pool[table[b, p // bs], p % bs]``, then the fused
        paged-attention kernel.  Positions past the table's reach go to
        the scratch block 0 (the JAX scatter drops them; scratch is
        garbage nobody reads as data, so both are unobservable)."""
        kpool, vpool = lc["key_pool"], lc["value_pool"]
        table = cache.block_table
        nb, bs, kvh, hd = kpool.shape
        n_blk = table.shape[1]
        blk = torch.clamp(positions // bs, 0, n_blk - 1).long()
        phys = torch.gather(table, 1, blk)                   # [B, q]
        dest = torch.where(positions < n_blk * bs,
                           phys * bs + positions % bs,
                           torch.zeros_like(phys)).reshape(-1).long()
        k_st, v_st, scales = self._stored(k, v, kpool.dtype)
        kpool.view(nb * bs, kvh, hd)[dest] = k_st.reshape(-1, kvh, hd)
        vpool.view(nb * bs, kvh, hd)[dest] = v_st.reshape(-1, kvh, hd)
        ks = vs = None
        if scales is not None:
            spool = lc["kv_pool_scales"]
            spool.view(2, nb * bs, kvh)[:, dest] = scales.reshape(2, -1, kvh)
            ks, vs = spool[0], spool[1]
        return K.paged_attention(q.contiguous(), kpool, vpool, table,
                                 cache.index, k_scales=ks, v_scales=vs,
                                 cache_len=cache.cache_len)

    # -- the shared-index cache (generate()) ---------------------------------

    def _decode_step(self, q, k, v, lc, cache: KVCache):
        """Append this call's rows at the shared position ``cache.index``
        and attend over the cache (the JAX ``_decode_step``).  The first
        multi-token call on a fresh cache attends the block alone through
        the attention kernels (``_fresh_block``); later calls take the
        linear cache's masked attention, or under a rolling window the
        ring's single-token step or ``_rolling_block``."""
        cur, q_len = cache.index, q.shape[1]
        _, rolling = shared_cache_rows(self.window, self.sinks,
                                       self.kv_cache_int8, cache.cache_len)
        if cache.fresh and q_len > 1:
            return self._fresh_block(q, k, v, lc, rolling)
        if rolling:
            if q_len > 1:
                return self._rolling_block(q, k, v, lc, cur)
            return self._rolling_step(q, k, v, lc, cur)
        c = lc["key_cache"].shape[1]
        if cur + q_len > c:
            raise ValueError(f"decode past the cache: position {cur} + "
                             f"{q_len} rows > cache_len {c}")
        k_st, v_st, scales = self._stored(k, v, lc["key_cache"].dtype)
        lc["key_cache"][:, cur:cur + q_len] = k_st
        lc["value_cache"][:, cur:cur + q_len] = v_st
        kc, vc = self._linear_rows(lc, scales, cur, q_len)
        kv_pos = torch.arange(c, device=q.device)
        q_pos = cur + torch.arange(q_len, device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]              # [q, C]
        if self.window is not None:
            # The last ``window`` positions and the sink prefix.
            band = kv_pos[None, :] > q_pos[:, None] - self.window
            if self.sinks:
                band = band | (kv_pos < self.sinks)[None, :]
            mask = mask & band
        return self._cache_attend(q, kc, vc, mask[None, None])

    def _linear_rows(self, lc, scales, cur: int, q_len: int):
        """The linear cache's rows as attention reads them: dequantized
        (int8, after storing this call's scales) or as stored."""
        if scales is None:
            return lc["key_cache"], lc["value_cache"]
        lc["kv_scales"][:, :, cur:cur + q_len] = scales
        sc = lc["kv_scales"].to(self.dtype)
        return (lc["key_cache"].to(self.dtype) * sc[0][..., None],
                lc["value_cache"].to(self.dtype) * sc[1][..., None])

    def _fresh_block(self, q, k, v, lc, rolling: bool):
        """The first multi-token call on a fresh shared-index cache: the
        block attends to itself alone, causal, with the window band and
        the sinks' keep-set — the function of the kernel dispatch
        (``multihead_attention_kernel``: flash, or splash past the
        window).  Its gate wants lengths that are multiples of 128, so
        q/k/v are zero-padded at the end: under causal masking no real
        query sees a pad key, the pad rows' outputs are dropped, and only
        the real rows are written to the cache, ring or sink buffers.  An
        int8 cache's rows are attended as stored (dequantized), as the
        JAX linear path reads them."""
        b, s = q.shape[:2]
        kdt = lc["key_cache"].dtype
        if self.kv_cache_int8:
            k_st, v_st, scales = self._stored(k, v, kdt)
            lc["key_cache"][:, :s] = k_st
            lc["value_cache"][:, :s] = v_st
            lc["kv_scales"][:, :, :s] = scales
            sc = scales.to(self.dtype)
            kk = k_st.to(self.dtype) * sc[0][..., None]
            vv = v_st.to(self.dtype) * sc[1][..., None]
        else:
            kk, vv = k.to(kdt), v.to(kdt)
            w = lc["key_cache"].shape[1]
            if not rolling or s < w:
                lc["key_cache"][:, :s] = kk
                lc["value_cache"][:, :s] = vv
            else:
                # The ring after the block: position p in slot p % w.
                end = s % w
                lc["key_cache"].copy_(torch.roll(kk[:, -w:], end, dims=1))
                lc["value_cache"].copy_(torch.roll(vv[:, -w:], end, dims=1))
            if "sink_key" in lc:
                self._write_sinks(lc, k, v, 0)
        n = -(-s // 128) * 128
        out = multihead_attention_kernel(
            _pad_rows(q, n).transpose(1, 2), _pad_rows(kk, n).transpose(1, 2),
            _pad_rows(vv, n).transpose(1, 2), causal=True, window=self.window,
            sinks=self.sinks)
        return out[:, :, :s].transpose(1, 2)

    def _write_sinks(self, lc, k, v, cur: int) -> None:
        """Copy this call's rows that land in the sink range (positions
        [cur, cur + q_len) within [0, sinks)) into the sink buffers."""
        lo, hi = cur, min(cur + k.shape[1], self.sinks)
        if lo < hi:
            lc["sink_key"][:, lo:hi] = k[:, :hi - lo].to(lc["sink_key"].dtype)
            lc["sink_value"][:, lo:hi] = v[:, :hi - lo].to(
                lc["sink_value"].dtype)

    def _rolling_step(self, q, k, v, lc, cur: int):
        """A single token under the rolling ring: its row goes to slot
        cur % w, and slot j then holds position cur - ((cur - j) % w);
        slots not yet written (negative positions) and those the sink
        buffers serve (positions < sinks) are masked out."""
        kc, vc = lc["key_cache"], lc["value_cache"]
        w = kc.shape[1]
        slot = cur % w
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        j = torch.arange(w, device=q.device)
        slot_pos = cur - torch.remainder(cur - j, w)
        mask = slot_pos >= self.sinks
        if self.sinks:
            self._write_sinks(lc, k, v, cur)
            kc = torch.cat([lc["sink_key"], kc], dim=1)
            vc = torch.cat([lc["sink_value"], vc], dim=1)
            mask = torch.cat([torch.arange(self.sinks, device=q.device)
                              <= cur, mask])
        return self._cache_attend(q, kc, vc, mask[None, None, None])

    def _rolling_block(self, q, k, v, lc, cur: int):
        """A multi-token call under the rolling ring at any position
        (chunked prefill, speculative blocks): the ring unrolled into
        positional order (slot j holds position cur - w + ((j - cur) %
        w)), the block's rows after it, each query kept to the causal
        window band over the w + q_len keys (and the sink columns), and
        the last w rows re-rolled into slot order as the new ring."""
        kc, vc = lc["key_cache"], lc["value_cache"]
        w, q_len, sinks, dev = kc.shape[1], q.shape[1], self.sinks, q.device
        if sinks:
            # The block's own sink rows first: the sink columns below
            # read the merged buffer.
            self._write_sinks(lc, k, v, cur)
        shift = cur % w
        kcat = torch.cat([torch.roll(kc, -shift, dims=1), k.to(kc.dtype)],
                         dim=1)
        vcat = torch.cat([torch.roll(vc, -shift, dims=1), v.to(vc.dtype)],
                         dim=1)
        kv_pos = cur - w + torch.arange(w + q_len, device=dev)
        q_pos = cur + torch.arange(q_len, device=dev)
        keep = ((kv_pos[None, :] >= 0) & (kv_pos[None, :] <= q_pos[:, None])
                & (q_pos[:, None] - kv_pos[None, :] < w))
        end = (cur + q_len) % w
        kc.copy_(torch.roll(kcat[:, -w:], end, dims=1))
        vc.copy_(torch.roll(vcat[:, -w:], end, dims=1))
        if sinks:
            # Sink columns serve positions < sinks, ring and block rows
            # the rest.
            keep = keep & (kv_pos[None, :] >= sinks)
            sink_keep = (torch.arange(sinks, device=dev)[None, :]
                         <= q_pos[:, None])
            keep = torch.cat([sink_keep, keep], dim=1)
            kcat = torch.cat([lc["sink_key"], kcat], dim=1)
            vcat = torch.cat([lc["sink_value"], vcat], dim=1)
        return self._cache_attend(q, kcat, vcat, keep[None, None])

    def _cache_attend(self, q, kc, vc, mask):
        """Masked einsum attention of q over dense cache buffers."""
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            kc = kc.repeat_interleave(rep, dim=2)
            vc = vc.repeat_interleave(rep, dim=2)
        out = dot_product_attention(q.transpose(1, 2), kc.transpose(1, 2),
                                    vc.transpose(1, 2), mask=mask)
        return out.transpose(1, 2)

    def _attn_epilogue(self, out: torch.Tensor) -> torch.Tensor:
        """Head merge and output projection (shared by all modes); under
        a tensor split the row-split product's sum over the group."""
        b, s = out.shape[:2]
        y = self.out(out.reshape(b, s, self.num_heads * self.head_dim))
        return _tensor_sum(y, self.tensor_group)


def _tensor_sum(y: torch.Tensor, group) -> torch.Tensor:
    """The all-reduce after a row-split product (the identity without a
    tensor group)."""
    if group is None:
        return y
    from tensorflow_train_distributed_torch.parallel.collectives import psum

    return psum(y, group)


def set_tensor_parallel(model: nn.Module, mesh, axis: str,
                        vocab_size: int) -> None:
    """Make ``model`` (a decoder holding one rank's share of a tensor
    split, ``llama.tensor_split``) sum its row-split products over the
    ``axis`` group and look its tokens up in its row block of the
    ``vocab_size``-row embedding."""
    group = mesh.group(axis)
    for m in model.modules():
        if isinstance(m, (MultiHeadAttention, MlpBlock)):
            m.tensor_group = group
    emb = model.token_embed
    e = emb.embedding
    emb.embedding = nn.Parameter(torch.empty(
        (vocab_size // mesh.shape[axis],) + tuple(e.shape[1:]),
        dtype=e.dtype, device=e.device), requires_grad=False)
    emb.row_shard = (mesh, axis, vocab_size)


def set_seq_parallel(model: nn.Module, method: str, group) -> int:
    """Route every ``MultiHeadAttention`` of ``model`` through
    ``parallel.ring_attention``'s ``method`` ("ring" or "ulysses") over
    the seq axis's ``group``.  Returns the number of layers set."""
    from tensorflow_train_distributed_torch.parallel.ring_attention import (
        METHODS,
    )

    if method not in METHODS:
        raise ValueError(f"seq_parallel must be one of {sorted(METHODS)}, "
                         f"got {method!r}")
    n = 0
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.seq_parallel = (method, group)
            n += 1
    return n
