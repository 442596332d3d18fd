"""Mixture-of-Experts decoder: the training forward and the task.

Counterpart of the JAX package's ``models/moe.py``: ``MoeConfig`` and
``MOE_PRESETS`` carry over field for field (``dtype`` is a
``torch.dtype``).  A ``MoEMlpBlock`` routes each token to its top-k
experts with an f32 router, then computes the experts' SwiGLU one of two
ways, on one parameter tree (``experts/{wi_gate,wi_up,wo}/kernel``,
expert-stacked ``[E, d, f]`` / ``[E, f, d]``), so weights move freely
between them:

- ``dispatch="dense"``: the GShard dispatch and combine einsums over
  ``[groups, seq, E, capacity]`` one-hots, one routing group a sequence,
  tokens past an expert's capacity dropped (they ride the residual);
- ``dispatch="gmm"``: the dropless MegaBlocks formulation: token copies
  sorted by expert, the three products as grouped matmuls
  (``ops.kernels.gmm``, the K6 kernels on CUDA), unsorted and combined.

The aux losses (load balance, router z-loss) and the routing statistics
are returned by each block, not collected as a side effect: a block that
is rematerialised runs its forward twice, and a side channel would
record the second run too.

Decode (``model(tokens, cache)``, as ``LlamaModel``'s: ``generate()``'s
shared-index cache, the engine's linear and paged caches) routes each
call's tokens as the training forward does, one routing group a row, so
a decode step is a group of one token whose capacity never binds.  int8
weight-only serving (``models.quant``) scales each expert's product in
the dense dispatch, as the JAX ``nn.vmap`` over ``_ExpertFfn`` carries
the ``quant`` collection; the gmm dispatch refuses int8 experts, as
JAX's does.

Expert parallelism (``set_expert_parallel``, a mesh whose ``expert``
axis is above 1): each block holds only its rank's E/ep experts' stacks
(the trainer loads them, ``training/trainer.py``); tokens stay sharded
over the batch axes and replicated over ``expert``.  The gmm dispatch
sorts its tokens locally and computes only its experts' rows through
``gmm(..., group_offset=e0)`` (zeros elsewhere); one ``all_reduce`` over
the expert group assembles the rows, where JAX uses
``psum("expert")``, and its backward passes the cotangent through, while
the tokens' gradient is summed over the group (each rank's covers its
rows only).  The dense dispatch computes its experts' slice of the
``[E, G, C, ·]`` buffers the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.models.llama import (
    LlamaModel,
    segment_relative_positions,
)
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.parallel import collectives as C
from tensorflow_train_distributed_torch.ops.losses import (
    fold_sample_weight,
    softmax_cross_entropy,
)


class _SumOverExperts(torch.autograd.Function):
    """Forward: the sum over the expert group (``psum("expert")``);
    backward: the cotangent, which every rank holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        return C.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToExperts(torch.autograd.Function):
    """Forward: the identity on a tensor every expert rank holds whole;
    backward: the sum of the ranks' cotangents (each covers the rows of
    its own experts)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g.contiguous(), ctx.group), None


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    vocab_size: int = 32_000
    d_model: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = 8
    ffn_size: int = 14_336
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 1          # 1 = every layer MoE (Mixtral); 2 = alternate
    max_positions: int = 4096
    rope_base: float = 10_000.0
    rms_epsilon: float = 1e-5
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # "dense" (GShard, capacity-bound) or "gmm" (dropless, grouped
    # matmuls; capacity_factor is ignored).
    dispatch: str = "dense"
    # Shared expert (DeepSeek/Qwen-MoE): a dense SwiGLU of this hidden
    # size on every token beside the routed experts; None = none.
    shared_expert_size: Optional[int] = None
    # Qwen-MoE: sigmoid(x @ w) per token scales the shared branch.
    shared_expert_gate: bool = False
    # Renormalise the top-k gates over the chosen experts (GShard,
    # Mixtral); False keeps the raw softmax probabilities (Qwen2-MoE).
    norm_topk_prob: bool = True
    qkv_bias: bool = False

    # The decode-side knobs of ``LlamaConfig`` that an MoE config lacks,
    # at their off values, so that the caches and the serving engine
    # read one interface.  The JAX MoeLmModel is a Python loop of layers
    # (``layer_{i}``), never depth-scanned.
    kv_cache_int8 = False
    sliding_window = None
    attention_sinks = 0
    scan_layers = False

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def attn_head_dim(self) -> int:
        return self.d_model // self.num_heads


MOE_PRESETS = {
    "mixtral_8x7b": MoeConfig(),
    "moe_1b": MoeConfig(d_model=1024, num_layers=8, num_heads=16,
                        num_kv_heads=4, ffn_size=4096, num_experts=8),
    "moe_370m": MoeConfig(d_model=768, num_layers=8, num_heads=12,
                          num_kv_heads=4, ffn_size=2048, num_experts=8,
                          top_k=2, max_positions=2048),
    "moe_tiny": MoeConfig(vocab_size=256, d_model=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, ffn_size=128,
                          num_experts=4, top_k=2, max_positions=128,
                          dtype=torch.float32, remat=False),
    "qwen15_moe_a27b": MoeConfig(
        vocab_size=151_936, d_model=2048, num_layers=24, num_heads=16,
        num_kv_heads=16, ffn_size=1408, num_experts=60, top_k=4,
        capacity_factor=15.0, max_positions=8192, rope_base=1_000_000.0,
        rms_epsilon=1e-6, shared_expert_size=5632, shared_expert_gate=True,
        norm_topk_prob=False, qkv_bias=True),
    "moe_tiny_shared": MoeConfig(vocab_size=256, d_model=64,
                                 num_layers=2, num_heads=4,
                                 num_kv_heads=2, ffn_size=128,
                                 num_experts=4, top_k=2,
                                 max_positions=128, dtype=torch.float32,
                                 remat=False, shared_expert_size=96),
    "qwen_moe_tiny": MoeConfig(vocab_size=256, d_model=64,
                               num_layers=2, num_heads=4,
                               num_kv_heads=2, ffn_size=96,
                               num_experts=4, top_k=2,
                               capacity_factor=2.0,
                               max_positions=128, dtype=torch.float32,
                               remat=False, shared_expert_size=112,
                               shared_expert_gate=True,
                               norm_topk_prob=False, qkv_bias=True),
}

# Rows of the grouped matmuls are padded to a multiple of this (the JAX
# kernel's row tile), the pad added to the last expert's group.
GMM_ROW_PAD = 128


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: all-zero rows for indices outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _router_one_hot(probs: torch.Tensor, top_k: int, capacity: int,
                    normalize: bool = True):
    """Top-k dispatch/combine tensors with per-expert capacity, per routing
    group.  ``probs`` [G, T, E] f32.  Returns ``dispatch`` [G, T, E, C]
    one-hot, ``combine`` [G, T, E, C] gate-weighted and the [G, T, E]
    routed mask; assignments past an expert's capacity are dropped.
    ``normalize=False`` keeps the raw softmax probabilities as gates."""
    groups, tokens, num_experts = probs.shape
    dt = probs.dtype
    remaining = probs
    fill = torch.zeros(groups, num_experts, dtype=torch.int64,
                       device=probs.device)
    dispatch = probs.new_zeros((groups, tokens, num_experts, capacity))
    combine = torch.zeros_like(dispatch)
    routed = torch.zeros_like(probs)
    gate_sum = probs.new_zeros((groups, tokens, 1))
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                   # [G, T]
        onehot = _one_hot(idx, num_experts, dt)
        gate = torch.sum(remaining * onehot, dim=-1, keepdim=True)
        # Each token's slot in its expert's buffer this round, after
        # what earlier rounds filled.
        pos = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1).to(torch.int64)
        keep = (pos_tok < capacity).to(dt)
        slot = _one_hot(pos_tok, capacity, dt)
        hot = onehot[..., None] * slot[..., None, :] * keep[..., None, None]
        dispatch = dispatch + hot
        combine = combine + hot * gate[..., None]
        routed = routed + onehot * keep[..., None]
        gate_sum = gate_sum + gate * keep[..., None]
        fill = fill + torch.sum(onehot * keep[..., None], dim=1).to(
            torch.int64)
        remaining = remaining * (1.0 - onehot)
    if normalize:
        combine = combine / torch.clamp(gate_sum[..., None], min=1e-9)
    return dispatch, combine, routed


class _StackedKernel(L._Leaf):
    """One expert-stacked kernel ``[E, in, out]`` (flax's
    ``experts/<name>/kernel``), cast to the compute dtype on use like
    every other parameter.  Under int8 serving the kernel holds the codes
    and ``scale`` [E, out] their scales (held as ``layers.Dense`` holds
    them)."""

    def __init__(self, *shape, dtype=torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape, dtype=dtype,
                                               device=device))
        self.register_buffer("scale", None, persistent=False)

    def forward(self) -> torch.Tensor:
        return self._cast(self.kernel)


class _Experts(nn.Module):
    """The routed experts' SwiGLU weights: ``wi_gate``/``wi_up``
    [E, d, f], ``wo`` [E, f, d]."""

    def __init__(self, num_experts: int, d: int, f: int, *, device=None):
        super().__init__()
        self.wi_gate = _StackedKernel(num_experts, d, f, device=device)
        self.wi_up = _StackedKernel(num_experts, d, f, device=device)
        self.wo = _StackedKernel(num_experts, f, d, device=device)


def _routed_ffn_rows(flat, top_e, gate_w, num_experts, wi_gate, wi_up, wo,
                     *, dtype, group_offset=None, ep_group=None):
    """The dropless routed FFN over ``flat`` [T, d] tokens with the
    router's choices ``top_e`` and gates ``gate_w`` [T, k]: sort token
    copies by expert (stable, as ``jnp.argsort``), count each expert's
    rows on the device, pad the rows to ``GMM_ROW_PAD`` (zero rows added
    to the last expert: silu(0)·0 = 0, sliced off before the combine),
    run the SwiGLU as three grouped matmuls with f32 outputs, unsort and
    gate-combine (``expert_rows``, then ``combine_rows``).

    With ``group_offset`` the stacks hold experts [offset, offset +
    E_local) and this is one expert rank's share: only its experts' rows
    are computed (zeros elsewhere), and the sum over ``ep_group``
    assembles every row, each computed by exactly one rank, before the
    combine."""
    if ep_group is not None:
        flat = _CopyToExperts.apply(flat, ep_group)
    out, order = expert_rows(flat, top_e, num_experts, wi_gate, wi_up, wo,
                             dtype=dtype, group_offset=group_offset)
    if ep_group is not None:
        out = _SumOverExperts.apply(out, ep_group)
    return combine_rows(out, order, gate_w, dtype=dtype)


def expert_rows(flat, top_e, num_experts, wi_gate, wi_up, wo, *, dtype,
                group_offset=None):
    """The expert FFN's rows: ([m_pad, d] f32 in expert order, the
    sort order).  With ``group_offset``, one expert shard's rows (zeros
    elsewhere): a sum over the shards' is the unsharded result bit for
    bit, since each row is one shard's product plus zeros."""
    t = flat.shape[0]
    top_k = top_e.shape[-1]
    e_flat = top_e.reshape(-1)                          # [T*k] token-major
    order = torch.argsort(e_flat, stable=True)
    xs = flat[order // top_k].to(dtype)
    sizes = torch.zeros(num_experts, dtype=torch.int64,
                        device=flat.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    m = t * top_k
    m_pad = -(-m // GMM_ROW_PAD) * GMM_ROW_PAD
    if m_pad != m:
        xs = F.pad(xs, (0, 0, 0, m_pad - m))
        sizes[num_experts - 1] += m_pad - m
    sizes = sizes.to(torch.int32)
    gate = K.gmm(xs, wi_gate, sizes, group_offset=group_offset)
    up = K.gmm(xs, wi_up, sizes, group_offset=group_offset)
    h = (F.silu(gate) * up).to(dtype)
    return K.gmm(h, wo, sizes, group_offset=group_offset), order


def combine_rows(out, order, gate_w, *, dtype):
    """Unsort ``out`` (``expert_rows``'s) and gate-combine each token's
    k rows: [T, d] in ``dtype``."""
    t, top_k = gate_w.shape
    m = t * top_k
    inv = torch.empty_like(order)
    inv[order] = torch.arange(m, device=order.device)
    y = out[:m][inv].reshape(t, top_k, out.shape[-1])
    return torch.sum(y * gate_w[..., None], dim=1).to(dtype)


class MoEMlpBlock(nn.Module):
    """Routed expert FFN, a drop-in for ``layers.MlpBlock``.
    ``forward(x)`` returns ``(y, aux, stats)``: ``aux`` the weighted
    load-balance and router-z terms, ``stats`` (dropped fraction [],
    expert load [E]) for the routing metrics."""

    def __init__(self, config: MoeConfig, *, device=None):
        super().__init__()
        cfg = config
        if cfg.dispatch not in ("dense", "gmm"):
            raise ValueError(f"unknown MoeConfig.dispatch {cfg.dispatch!r} "
                             "(expected 'dense' or 'gmm')")
        self.config = cfg
        # (process group, ranks, this rank's index) of the expert axis;
        # None without expert parallelism (``set_expert_parallel``).
        self.expert_parallel = None
        self.router = L.Dense(cfg.d_model, cfg.num_experts,
                              dtype=torch.float32, device=device)
        self.experts = _Experts(cfg.num_experts, cfg.d_model, cfg.ffn_size,
                                device=device)
        if cfg.shared_expert_size:
            self.shared_mlp = L.MlpBlock(cfg.d_model, cfg.shared_expert_size,
                                         dtype=cfg.dtype, device=device)
            if cfg.shared_expert_gate:
                self.shared_gate = L.Dense(cfg.d_model, 1,
                                           dtype=torch.float32, device=device)

    def _weights(self):
        dt = self.config.dtype
        return (self.experts.wi_gate().to(dt), self.experts.wi_up().to(dt),
                self.experts.wo().to(dt))

    def _expert_product(self, name: str, eq: str, h: torch.Tensor):
        """One product of the dense dispatch's expert FFN over the
        [E, G, C, ·] buffer; an int8 stack's scale [E, out] multiplies
        each expert's output after its product (the JAX interceptor's
        order, per expert)."""
        stack = getattr(self.experts, name)
        dt = self.config.dtype
        y = torch.einsum(eq, h, stack().to(dt))
        if stack.scale is not None:
            y = y * stack.scale.to(dt)[:, None, None, :]
        return y

    def forward(self, x: torch.Tensor):
        cfg = self.config
        groups, group_size, d = x.shape
        # Router in f32: a small product, numerically load-bearing.
        logits = self.router(x.float())                  # [G, S, E]
        probs = torch.softmax(logits, dim=-1)
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        if cfg.dispatch == "gmm":
            y, lb, stats = self._gmm_moe(x, probs)
        else:
            y, lb, stats = self._dense_moe(x, probs)
        aux = (cfg.aux_loss_weight * lb, cfg.z_loss_weight * z)
        return self._add_shared(x, y), aux, stats

    def _dense_moe(self, x, probs):
        cfg = self.config
        groups, group_size, _ = x.shape
        capacity = max(1, int(cfg.capacity_factor * cfg.top_k * group_size
                              / cfg.num_experts))
        dispatch, combine, routed = _router_one_hot(
            probs, cfg.top_k, capacity, cfg.norm_topk_prob)
        frac_routed = torch.mean(routed, dim=(0, 1))
        frac_prob = torch.mean(probs, dim=(0, 1))
        lb = cfg.num_experts * torch.sum(frac_routed * frac_prob) / cfg.top_k
        desired = float(groups * group_size * cfg.top_k)
        total = torch.sum(routed)
        stats = (1.0 - total / desired,
                 torch.sum(routed, dim=(0, 1)) / torch.clamp(total, min=1.0))
        ep = self.expert_parallel
        if ep is not None:
            # This rank's experts' slice of the buffers; the full tensors
            # it is cut from are held whole by every expert rank.
            group, n, ix = ep
            e_local = cfg.num_experts // n
            local = slice(ix * e_local, (ix + 1) * e_local)
            x = _CopyToExperts.apply(x, group)
            combine = _CopyToExperts.apply(combine, group)[:, :, local]
            dispatch = dispatch[:, :, local]
        expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(cfg.dtype), x)
        gate = self._expert_product("wi_gate", "egcd,edf->egcf", expert_in)
        up = self._expert_product("wi_up", "egcd,edf->egcf", expert_in)
        expert_out = self._expert_product("wo", "egcf,efd->egcd",
                                          F.silu(gate) * up)
        y = torch.einsum("gsec,egcd->gsd", combine.to(cfg.dtype), expert_out)
        if ep is not None:
            y = _SumOverExperts.apply(y, ep[0])
        return y, lb, stats

    def _gmm_moe(self, x, probs):
        cfg = self.config
        if self.experts.wi_gate.scale is not None:
            # The grouped matmuls would read int8 codes with no scale.
            raise NotImplementedError(
                "int8 weight-only serving is not wired for the gmm "
                "dispatch path — serve quantized MoE checkpoints with "
                "dispatch='dense', or dequantize_params() first")
        groups, group_size, d = x.shape
        n_tokens, k = groups * group_size, cfg.top_k
        flat = x.reshape(n_tokens, d)
        p2 = probs.reshape(n_tokens, cfg.num_experts)
        top_p, top_e = torch.topk(p2, k, dim=-1)
        if cfg.norm_topk_prob:
            gate_w = top_p / torch.clamp(top_p.sum(-1, keepdim=True),
                                         min=1e-9)
        else:
            gate_w = top_p
        routed = _one_hot(top_e, cfg.num_experts, torch.float32).sum(1)
        lb = cfg.num_experts * torch.sum(
            routed.mean(0) * p2.mean(0)) / k
        stats = (torch.zeros((), device=x.device),
                 routed.sum(0) / float(n_tokens * k))
        ep = self.expert_parallel
        offset = None if ep is None else ep[2] * (cfg.num_experts // ep[1])
        y = _routed_ffn_rows(flat, top_e, gate_w, cfg.num_experts,
                             *self._weights(), dtype=cfg.dtype,
                             group_offset=offset,
                             ep_group=None if ep is None else ep[0])
        return y.reshape(groups, group_size, d), lb, stats

    def _add_shared(self, x, routed):
        """The shared expert (``shared_expert_size``) summed with the
        routed output, scaled per token by the Qwen sigmoid gate."""
        cfg = self.config
        if not cfg.shared_expert_size:
            return routed
        shared = self.shared_mlp(x)
        if cfg.shared_expert_gate:
            g = torch.sigmoid(self.shared_gate(x.float()))
            shared = shared * g.to(shared.dtype)
        return routed + shared


def set_expert_parallel(model: nn.Module, mesh) -> int:
    """Shard every ``MoEMlpBlock`` of ``model`` over the mesh's ``expert``
    axis: each block keeps its rank's E/ep experts' stacks (fresh
    storage on the stacks' device, to be loaded by the caller) and runs
    the expert-parallel dispatch.  Refuses ``num_experts % expert`` and,
    for ``dispatch="gmm"``, an expert × tensor mesh (the JAX package's
    refusals).  Returns the number of blocks sharded."""
    n = mesh.shape["expert"]
    blocks = [m for m in model.modules() if isinstance(m, MoEMlpBlock)]
    if n <= 1:
        return 0
    for b in blocks:
        cfg = b.config
        if cfg.num_experts % n:
            raise ValueError(
                f"num_experts={cfg.num_experts} not divisible by the "
                f"expert mesh axis ({n})")
        if cfg.dispatch == "gmm" and mesh.shape["tensor"] > 1:
            raise ValueError(
                "dispatch='gmm' supports data×fsdp×expert meshes; an "
                "expert×tensor mesh keeps dispatch='dense'")
    for b in blocks:
        e_local = b.config.num_experts // n
        b.expert_parallel = (mesh.group("expert"), n, mesh.index("expert"))
        for name in ("wi_gate", "wi_up", "wo"):
            stack = getattr(b.experts, name)
            k = stack.kernel
            stack.kernel = nn.Parameter(torch.empty(
                (e_local,) + tuple(k.shape[1:]), dtype=k.dtype,
                device=k.device))
    return len(blocks)


class MoeDecoderBlock(nn.Module):
    """Pre-norm block with an MoE FFN (or a dense SwiGLU when
    ``use_moe`` is False).  ``forward`` returns ``(x, aux, stats)``;
    a dense block returns empty ``aux`` and ``stats``."""

    def __init__(self, config: MoeConfig, *, use_moe: bool = True,
                 device=None):
        super().__init__()
        cfg = config
        self.use_moe = use_moe
        norm = dict(epsilon=cfg.rms_epsilon, dtype=cfg.dtype, device=device)
        self.attn_norm = L.RMSNorm(cfg.d_model, **norm)
        self.attention = L.MultiHeadAttention(
            cfg.d_model, cfg.num_heads, cfg.d_model // cfg.num_heads,
            cfg.num_kv_heads, dtype=cfg.dtype, qkv_bias=cfg.qkv_bias,
            device=device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, **norm)
        if use_moe:
            self.moe = MoEMlpBlock(cfg, device=device)
        else:
            self.mlp = L.MlpBlock(cfg.d_model, cfg.ffn_size, dtype=cfg.dtype,
                                  device=device)

    def forward(self, x, layer_cache: Optional[dict] = None,
                cache: Optional[L.KVCache] = None, *, positions, rope,
                segment_ids=None):
        h = self.attn_norm(x)
        x = x + self.attention(h, layer_cache, cache, positions=positions,
                               rope=rope, segment_ids=segment_ids)
        h = self.mlp_norm(x)
        if not self.use_moe:
            return x + self.mlp(h), (), ()
        y, aux, stats = self.moe(h)
        return x + y, aux, stats


class MoeLmModel(nn.Module):
    """Decoder LM with an MoE FFN every ``moe_every``-th layer.
    ``model(tokens [B, S], segment_ids=...)`` returns ``(logits, aux,
    stats)``: logits [B, S, vocab] in ``config.dtype``, ``aux`` the list
    of every MoE layer's weighted aux terms, ``stats`` a list of each MoE
    layer's (dropped fraction, expert load).  Each block is
    rematerialised under ``config.remat``.  Decode, ``model(tokens,
    cache)`` over a ``layers.KVCache`` (``init_cache``, as
    ``LlamaModel``'s), returns the logits alone, as the JAX model's
    decode apply does, and advances the cache's index by S."""

    def __init__(self, config: MoeConfig, *, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.token_embed = L.Embed(cfg.vocab_size, cfg.d_model,
                                   dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(
            MoeDecoderBlock(cfg, use_moe=(i % cfg.moe_every == 0),
                            device=device)
            for i in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, epsilon=cfg.rms_epsilon,
                                    dtype=cfg.dtype, device=device)
        self.lm_head = L.Dense(cfg.d_model, cfg.vocab_size, dtype=cfg.dtype,
                               device=device)

    def forward(self, tokens: torch.Tensor, cache=None, *,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None):
        cfg = self.config
        if cache is not None:
            return self._decode(tokens, cache, segment_ids, positions)
        if positions is None:
            if segment_ids is not None:
                positions = segment_relative_positions(segment_ids)
            else:
                positions = torch.arange(
                    tokens.shape[1], device=tokens.device).expand(
                        tokens.shape)
        rope = L.rope_sin_cos(positions, cfg.d_model // cfg.num_heads,
                              base=cfg.rope_base)
        x = self.token_embed(tokens)
        aux, stats = [], []
        for layer in self.layers:
            kw = dict(positions=positions, rope=rope, segment_ids=segment_ids)
            if cfg.remat and torch.is_grad_enabled():
                x, a, s = checkpoint(layer, x, use_reentrant=False, **kw)
            else:
                x, a, s = layer(x, **kw)
            aux.extend(a)
            if s:
                stats.append(s)
        return self.lm_head(self.final_norm(x)), aux, stats

    def _decode(self, tokens, cache: L.KVCache, segment_ids, positions):
        """The decode forward: positions from the cache (one host int for
        the shared-index cache, each row's ``index`` otherwise), every
        layer appending its rows in place, no remat."""
        cfg = self.config
        if segment_ids is not None or positions is not None:
            raise ValueError("decode mode takes its positions from the "
                             "cache and no packed segments")
        offsets = torch.arange(tokens.shape[1], device=tokens.device)
        if cache.shared:
            positions = (cache.index + offsets).expand(tokens.shape)
        else:
            positions = cache.index[:, None] + offsets
        rope = L.rope_sin_cos(positions, cfg.attn_head_dim,
                              base=cfg.rope_base)
        x = self.token_embed(tokens)
        for layer, lc in zip(self.layers, cache.layers):
            x = layer(x, lc, cache, positions=positions, rope=rope)[0]
        cache.index += tokens.shape[1]
        cache.fresh = False
        return self.lm_head(self.final_norm(x))

    # The caches are the Llama decoder's: one attention layout per layer.
    init_cache = LlamaModel.init_cache


def _routing_metrics(stats: list) -> dict:
    """Routing health averaged over MoE layers: ``dropped_frac`` (> 0
    when the capacity binds) and the largest and smallest expert share
    of kept tokens (uniform = 1/E)."""
    if not stats:
        return {}
    mean_load = torch.mean(torch.stack([load for _, load in stats]), dim=0)
    return {
        "dropped_frac": torch.mean(torch.stack([d for d, _ in stats])),
        "expert_load_max": torch.max(mean_load),
        "expert_load_min": torch.min(mean_load),
    }


class MoeLmTask:
    """Causal LM objective plus the routed aux losses (the JAX
    ``MoeLmTask``).  ``device="meta"`` builds it without storage, for
    weights loaded later (``Trainer.create_state``)."""

    def __init__(self, config: MoeConfig, *, device=None):
        self.config = config
        self.model = MoeLmModel(config, device=device)

    def loss_fn(self, batch: dict, train: Optional[bool] = None):
        """(loss, metrics) of one batch: the cross-entropy plus, in
        training, the aux terms (in evaluation they stay a metric, as
        they cover pad rows the weights cannot mask).  ``train`` defaults
        to the model's mode (``Trainer.evaluate`` runs it in eval mode)."""
        if train is None:
            train = self.model.training
        logits, aux, stats = self.model(
            batch["tokens"], segment_ids=batch.get("segment_ids"))
        logits = logits.float()
        weights = fold_sample_weight(batch, batch["targets"].shape,
                                     batch.get("loss_weights"))
        ce, acc = softmax_cross_entropy(logits, batch["targets"],
                                        weights=weights)
        aux_total = (torch.stack(aux).sum() if aux
                     else torch.zeros((), device=ce.device))
        loss = ce + aux_total if train else ce
        metrics = {"accuracy": acc, "ce_loss": ce, "aux_loss": aux_total}
        metrics.update(_routing_metrics(stats))
        if weights is not None:
            metrics["loss_weight"] = weights.sum()
        return loss, metrics
